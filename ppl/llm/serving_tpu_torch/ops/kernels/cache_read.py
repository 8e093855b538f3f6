"""Page read (K5): the wrapper of the CUDA kernel in
``csrc/cache_read.cu``.

The KV-write microbench (:mod:`..tools.microbench_scatter_7b`) reads the
cache in place between its writes with this kernel, as the JAX
package's microbench does with its Pallas ``pallas_read``. On the CPU
the wrapper runs the plain version; on a CUDA tensor it launches the
kernel or raises, never falling back. ``page_read.launches`` counts
launches. :func:`plan_page_read` cuts the page into the chunks that the
kernel's CTAs each bring in with one bulk asynchronous copy.
"""

from __future__ import annotations

import ctypes
from typing import Tuple

import torch

from . import _build

# shared memory one H100 block can hold, less the kernel's mbarrier
_SMEM_MAX = 227 * 1024 - 16
# CTAs a SM the chunks aim at: 8 of 256 threads fill an SM's 2,048. At the
# 7B microbench page the read takes the same time from 32 to 1,024 CTAs
# when 8 rows convert, and falls from 128 to 1,024 CTAs when all 128 do
# (the chunk sweep recorded in PERF.md)
CTAS_PER_SM = 8
_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong


def _lib():
    lib = _build.load("cache_read")
    if not getattr(lib, "_ppl_typed", False):
        lib.ppl_page_read.argtypes = [_P, _P, _I, _LL, _I, _I, _I, _I, _P]
        lib.ppl_page_read.restype = _I
        lib._ppl_typed = True
    return lib


def plan_page_read(kvh: int, page_size: int, r: int,
                   sms: int) -> Tuple[int, int]:
    """K5's chunks of a head's page: ``(chunk_rows, n_chunks)``. Chunk
    ``i`` holds rows ``[i * chunk_rows, min(page_size, (i + 1) *
    chunk_rows))``, none empty (the last may be shorter); one CTA copies
    each. The smallest chunks whose ``kvh * n_chunks`` CTAs stay within
    ``CTAS_PER_SM * sms``, where the page has the rows for it, and none
    outgrowing one block's shared memory."""
    chunks = min(page_size, max(1, CTAS_PER_SM * sms // kvh,
                                -(-page_size // max(1, _SMEM_MAX // r))))
    chunk_rows = -(-page_size // chunks)
    return chunk_rows, -(-page_size // chunk_rows)


def page_read_ref(cache: torch.Tensor, rows: int = 8) -> torch.Tensor:
    """The plain version: the first ``rows`` rows of every KV head as
    f32 ``[KVH, rows, R]``."""
    return cache[:, :rows, :].float()


def page_read(cache: torch.Tensor, rows: int = 8,
              page_size: int = 128) -> torch.Tensor:
    """K5: read page 0 of layer 0 (rows ``[0, page_size)`` of every KV
    head of the int8 cache ``[KVH, L*S, R]``) and return its first
    ``rows`` rows as f32 ``[KVH, rows, R]``, one CTA a chunk of
    :func:`plan_page_read`."""
    if cache.device.type == "cpu":
        return page_read_ref(cache, rows)
    if cache.device.type != "cuda":
        raise ValueError(f"page_read: device {cache.device}")
    if cache.dtype != torch.int8 or cache.ndim != 3:
        raise TypeError(f"page_read: cache must be int8 [KVH, L*S, R], "
                        f"got {cache.dtype} {tuple(cache.shape)}")
    kvh, ls_rows, r = cache.shape
    if not cache.is_contiguous() or cache.data_ptr() % 16 or r % 16:
        raise ValueError("page_read: cache must be contiguous, 16-byte "
                         "aligned, with rows of whole 16-byte vectors")
    if not 0 < rows <= page_size <= ls_rows:
        raise ValueError(f"page_read: rows {rows} / page_size {page_size} "
                         f"do not fit a cache of {ls_rows} rows")
    chunk_rows, _ = plan_page_read(kvh, page_size, r,
                                   _build.sm_count(cache.device))
    if chunk_rows * r > _SMEM_MAX:
        raise ValueError(f"page_read: a row of {r} bytes does not fit one "
                         "block's shared memory")
    out = torch.empty((kvh, rows, r), dtype=torch.float32,
                      device=cache.device)
    err = _lib().ppl_page_read(
        cache.data_ptr(), out.data_ptr(), kvh, ls_rows, page_size, r, rows,
        chunk_rows, torch.cuda.current_stream(cache.device).cuda_stream)
    if err:
        raise RuntimeError(f"page_read: launch failed (cudaError {err})")
    page_read.launches += 1
    return out


page_read.launches = 0
