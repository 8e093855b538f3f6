"""``k3_roofline.<split>``: the least time of the sub-window's K3 work
(``bounds.k3_least_s``) over K3's device time in the trace (its
``quantize_rows`` pass included, as the trace's groups have it), in %."""

from port_bench import bounds, trace


def read(ctx, name):
    tr = ctx.trace
    if tr is None or tr["summary"] is None:
        return None
    device_s = tr["summary"]["groups"].get(trace.K3, 0.0)
    least = bounds.k3_least_s(tr["work"], ctx.widths)
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
