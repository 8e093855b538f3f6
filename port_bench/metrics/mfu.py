"""``mfu.<split>``: the model's useful operations in the traced
sub-window (``bounds.model_ops``: matmuls, attention and lm_head of the
prompt tokens computed and the tokens decoded, counted from the traffic,
the program's counters and the published widths) over its seconds at
the card's int8 peak, in %."""

from port_bench import bounds


def read(ctx, name):
    tr = ctx.trace
    if tr is None or tr["summary"] is None or not tr["work"].tokens():
        return None
    ops = bounds.model_ops(tr["work"], ctx.widths)
    return 100.0 * ops / (tr["seconds"] * bounds.PEAK_INT8)
