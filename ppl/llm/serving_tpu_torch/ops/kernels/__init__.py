"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (or raises). :func:`launch_counts` reads the
wrappers' launch counters (and, apart, K1's block-tail launches under
``paged_decode_attention_tail`` and K1's and K2's ALiBi launches under
``paged_decode_attention_alibi`` and ``paged_prefill_attention_alibi``,
and K3's by tile under ``i8i8_matmul_<tile>``);
:func:`reset_launch_counts` sets them to 0; :func:`add_launch_counts`
adds the launches a replayed CUDA graph holds.
"""

from . import cache_read, paged_attention, quant_matmul

WRAPPERS = {
    "paged_decode_attention": paged_attention.paged_decode_attention,
    "paged_prefill_attention": paged_attention.paged_prefill_attention,
    "i8i8_matmul": quant_matmul.i8i8_matmul,
    "w4a8_matmul": quant_matmul.w4a8_matmul,
    "page_read": cache_read.page_read,
}


# counter name -> (wrapper, attribute)
COUNTERS = {name: (fn, "launches") for name, fn in WRAPPERS.items()}
COUNTERS["paged_decode_attention_tail"] = (
    paged_attention.paged_decode_attention, "tail_launches")
COUNTERS["paged_decode_attention_alibi"] = (
    paged_attention.paged_decode_attention, "alibi_launches")
COUNTERS["paged_prefill_attention_alibi"] = (
    paged_attention.paged_prefill_attention, "alibi_launches")
for _tile in quant_matmul.TILES:     # K3's launches by tile
    COUNTERS[f"i8i8_matmul_{_tile}"] = (quant_matmul.i8i8_matmul,
                                        f"{_tile}_launches")


def launch_counts() -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr) in COUNTERS.items()}


def reset_launch_counts() -> None:
    for fn, attr in COUNTERS.values():
        setattr(fn, attr, 0)


def add_launch_counts(delta: dict) -> None:
    for name, n in delta.items():
        fn, attr = COUNTERS[name]
        setattr(fn, attr, getattr(fn, attr) + n)


__all__ = ["cache_read", "paged_attention", "quant_matmul", "WRAPPERS",
           "COUNTERS", "launch_counts", "reset_launch_counts",
           "add_launch_counts"]
