"""``k2_roofline``: the least time of the sub-window's prefill attention
(``bounds.Work.k2_least_s``, request by request) over K2's device time
in the trace, in %."""

from port_bench import trace


def read(ctx, name):
    tr = ctx.trace
    if tr is None or tr["summary"] is None:
        return None
    device_s = tr["summary"]["groups"].get(trace.K2, 0.0)
    least = tr["work"].k2_least_s
    if device_s <= 0 or least <= 0:
        return None
    return 100.0 * least / device_s
