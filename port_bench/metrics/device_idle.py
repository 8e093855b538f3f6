"""``device_idle.<split>``: the share of the traced sub-window with no
kernel, memcpy or memset on the card, in %."""


def read(ctx, name):
    tr = ctx.trace
    if tr is None or tr["summary"] is None:
        return None
    return 100.0 * (1.0 - tr["summary"]["busy_s"] / tr["seconds"])
