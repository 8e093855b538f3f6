"""Hand-written CUDA kernels of the port and their wrappers.

Each wrapper runs its plain PyTorch version for CPU tensors and launches
its kernel for CUDA tensors (or raises). :func:`launch_counts` reads the
wrappers' launch counters; :func:`reset_launch_counts` sets them to 0.
"""

from . import paged_attention, quant_matmul

WRAPPERS = {
    "paged_decode_attention": paged_attention.paged_decode_attention,
    "paged_prefill_attention": paged_attention.paged_prefill_attention,
    "i8i8_matmul": quant_matmul.i8i8_matmul,
    "w4a8_matmul": quant_matmul.w4a8_matmul,
}


def launch_counts() -> dict:
    return {name: fn.launches for name, fn in WRAPPERS.items()}


def reset_launch_counts() -> None:
    for fn in WRAPPERS.values():
        fn.launches = 0


__all__ = ["paged_attention", "quant_matmul", "WRAPPERS", "launch_counts",
           "reset_launch_counts"]
