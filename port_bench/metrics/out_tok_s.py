"""``out_tok_s``: output tokens streamed to clients inside the window,
over the window's seconds."""

from port_bench import stats


def read(ctx, name):
    w0, w1 = ctx.window
    return stats.tokens_between(ctx.requests, w0, w1) / (w1 - w0)
