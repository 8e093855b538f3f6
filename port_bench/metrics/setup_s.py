"""``setup_s``: process start -> start of the window (kernel builds from
the cache, the weights, the engine's bucket-grid validation and warm-up,
the server, and the traffic's own warm-up)."""


def read(ctx, name):
    return ctx.setup_s
