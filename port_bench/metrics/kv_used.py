"""``kv_used``: the KV pool's share in use, 1 - free / pool tokens (the
generator's page manager, sampled every 50 ms), averaged over the
window, in %."""


def read(ctx, name):
    samples = ctx.kv_samples
    if not samples:
        return None
    return 100.0 * sum(1.0 - free / total for free, total in samples) \
        / len(samples)
