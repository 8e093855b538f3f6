"""``ttft_p50_ms`` / ``ttft_p95_ms``: the percentile, over every request
due in the window, of due time -> first streamed token (a miss reads
``stats.MISS_MS``)."""

from port_bench import stats

NAMES = ("ttft_p50_ms", "ttft_p95_ms")


def read(ctx, name):
    window = stats.in_window(ctx.requests)
    if not window:
        return None
    q = float(name.split("_")[1][1:])
    return stats.tail_ms([stats.ttft_ms(r) for r in window], q)
