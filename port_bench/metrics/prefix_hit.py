"""``prefix_hit``: the program's prefix-cache hit tokens over the prompt
tokens it took in (``WorkerProfiler.global_.cache_hit_count`` and
``input_token_cnt``), differenced across the window, in %."""


def read(ctx, name):
    a, b = ctx.counters["window_start"], ctx.counters["window_end"]
    tokens = b["input_tokens"] - a["input_tokens"]
    if tokens <= 0:
        return None
    return 100.0 * (b["cache_hits"] - a["cache_hits"]) / tokens
