"""Paged decode (K1) and prefill (K2) attention: wrappers of the CUDA
kernels in ``csrc/paged_attention.cu``.

Each wrapper dispatches on the device of its tensors. On the CPU it runs
the plain version from :mod:`..attention`; on a CUDA tensor it launches
its kernel or raises, never falling back. Each wrapper counts its
launches in a plain integer attribute (``paged_decode_attention.launches``)
so a run can show that the main path went through the kernel; decode
launches in block-tail mode are also counted apart
(``paged_decode_attention.tail_launches``), and so are ALiBi launches
(``alibi_launches`` on each wrapper).

Contracts are those of the JAX package's Pallas kernels
(``serving_tpu/ops/pallas/paged_attention.py``) in deferred-append mode:
decode takes the current token's k/v as ``fresh_k/fresh_v`` and writes
zeros for rows with ``context_len == 0`` (in block-tail mode it also reads
the block's side buffer ``tail_kv`` rows ``j < tail_len`` between the
cache and the self-term); prefill takes this step's K/V
as the packed ``fresh_kv`` slab ``[Bp, KVH, Qp, 2*shd]`` and writes zeros
for query rows past ``new_len``.

With int8 KV the cache is int8 and ``scale`` holds its bf16 group-scale
rows ``[L*S, scale_lanes]``; the kernels dequantize each page (to bf16
for bf16 q, as the Pallas bodies do, in f32 for f32 q).
Decode's ``fresh_k/fresh_v`` stay unquantized (q's dtype); prefill's
``fresh_kv`` is int8 too, with its scale rows ``fresh_scale
[Bp, Qp, scale_lanes]``.

``alibi`` (f32 slopes ``[Hq]`` on q's device, or None) adds the ALiBi
bias ``slope * k_pos`` to every score, at the key positions the plain
versions document.

Decode with bf16 q splits each row's context over the CTAs that
:func:`plan_decode_splits` chooses (:func:`split_pages` says which pages
each covers); its partials and arrival counters are allocated per call,
so a CUDA graph captures them.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from .. import attention as attn_ops
from .. import kv_cache as kv_ops
from ..kv_cache import CacheSpec
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_KV_GROUP = 8                # kKvGroup in the .cu: int8 KV scale group
_DEC_MAX_OUT = 8 * 256       # kDecMaxOut * kThreads in the .cu (f32 body)
_HEAD_DIMS = (16, 32, 64, 128)  # K2's and K1's bf16 instantiations
_PREFILL_ROWS = 64           # kRows in the .cu
_DEC_TC_ROWS = 16            # K1's A tile: at most 16 query heads a kv head
_DECODE_CHUNK = 64
CTAS_PER_SM = 2              # what K1's split plan aims for at small batch

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float


def _lib():
    lib = _build.load("paged_attention")
    if not getattr(lib, "_ppl_typed", False):
        lib.ppl_paged_decode_attention.argtypes = [
            _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
            _I, _I, _LL, _I, _LL, _I, _F, _P, _P, _P, _I, _P, _I, _P, _P,
            _P]
        lib.ppl_paged_decode_attention.restype = _I
        lib.ppl_paged_prefill_attention.argtypes = [
            _I, _I, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
            _I, _I, _I, _I, _LL, _I, _LL, _F, _P, _P]
        lib.ppl_paged_prefill_attention.restype = _I
        lib._ppl_typed = True
    return lib


def _check_cuda(name: str, device, vector_loaded, **tensors) -> None:
    """Same device, contiguous; the tensors the kernel reads with 16-byte
    vector loads (``vector_loaded``) also 16-byte aligned."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if key in vector_loaded and t.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _check_scale_rows(name: str, key: str, scale, shape) -> None:
    if scale is None or scale.dtype != torch.bfloat16:
        raise TypeError(f"{name}: int8 KV needs bf16 {key} rows")
    if tuple(scale.shape) != tuple(shape):
        raise ValueError(f"{name}: {key} shape {tuple(scale.shape)}, "
                         f"expected {tuple(shape)}")


def _check_common(name: str, q: torch.Tensor, cache: torch.Tensor,
                  scale, spec: CacheSpec, page_table: torch.Tensor) -> None:
    if q.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: dtype {q.dtype} not supported")
    want = torch.int8 if spec.quantized else q.dtype
    if cache.dtype != want:
        raise TypeError(f"{name}: cache dtype {cache.dtype}, expected "
                        f"{want}")
    if page_table.dtype != torch.int32:
        raise TypeError(f"{name}: page_table must be int32")
    kvh, ls_rows, lanes = cache.shape
    if (kvh != spec.num_kv_heads or lanes != spec.row_lanes
            or ls_rows != spec.num_layers * spec.num_slots):
        raise ValueError(f"{name}: cache shape {tuple(cache.shape)} does "
                         "not match its CacheSpec")
    es = cache.element_size()
    if (spec.head_dim * es) % 16 or (spec.shd * es) % 16:
        raise ValueError(f"{name}: head_dim {spec.head_dim} is not a "
                         "whole number of 16-byte vectors")
    if spec.quantized:
        if spec.quant_group != _KV_GROUP:
            raise ValueError(f"{name}: int8 KV group {spec.quant_group} "
                             f"not supported (only {_KV_GROUP})")
        _check_scale_rows(name, "scale", scale,
                          (ls_rows, spec.scale_lanes))


def _check_alibi(name: str, alibi, hq: int) -> None:
    if alibi.dtype != torch.float32 or tuple(alibi.shape) != (hq,):
        raise ValueError(f"{name}: alibi must be float32 [{hq}], got "
                         f"{alibi.dtype} {tuple(alibi.shape)}")


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def plan_decode_splits(b: int, kvh: int, p: int, num_sms: int) -> int:
    """K1's context splits S for a ``(B, KVH)`` grid over a page table
    ``p`` pages wide: 1 when the ``B * KVH`` CTAs fill the SMs, else
    enough for about ``CTAS_PER_SM`` CTAs a SM, at most one a page. Every
    value is known when a step is built, so a program key keeps one S."""
    rows = b * kvh
    if rows <= 0 or rows >= num_sms:
        return 1
    return max(1, min(p, -(-CTAS_PER_SM * num_sms // rows)))


def split_pages(n_pages: int, splits: int, z: int) -> Tuple[int, int]:
    """The pages ``[p0, p1)`` that split ``z`` of ``splits`` covers in a
    row whose cached tokens fill ``n_pages`` pages (K1's tensor-core body
    computes the same): ``ceil(n_pages / splits)`` whole pages a split,
    none past ``n_pages``."""
    pps = -(-n_pages // splits)
    return min(z * pps, n_pages), min((z + 1) * pps, n_pages)


def paged_decode_attention(
    q: torch.Tensor,             # [B, Hq, hd]
    cache: torch.Tensor,         # [KVH, L*S, 2*shd] (int8 when quantized)
    scale,                       # bf16 [L*S, scale_lanes] or None
    page_table: torch.Tensor,    # i32[B, P]
    context_len: torch.Tensor,   # i32[B] kv length incl. current token
    spec: CacheSpec,
    *,
    layer: int,
    fresh_k: torch.Tensor,       # [B, KVH, hd]
    fresh_v: torch.Tensor,
    tail_kv=None,                # [L, B, KVH, J, 2*shd] cache dtype
    tail_scale=None,             # bf16 [L, B, J, scale_lanes] if int8
    tail_len=None,               # i32[1]
    alibi=None,                  # f32[Hq] ALiBi slopes
    splits: Optional[int] = None,
) -> torch.Tensor:               # [B, Hq, hd]
    """K1: decode attention over the paged cache; the cache holds
    ``context_len - 1`` tokens and the current token's k/v enters as a
    self-term. With ``tail_kv`` (block-tail mode) the cache holds
    ``tail_len`` tokens fewer and those come from the side buffer.

    bf16 q runs the tensor-core body over ``splits`` CTAs a (row, kv
    head), :func:`plan_decode_splits`'s choice when None; f32 q runs the
    SIMT body, unsplit."""
    if q.device.type == "cpu":
        out = attn_ops.decode_attention_ref(
            q, cache, scale, page_table, context_len, spec, layer=layer,
            fresh_k=fresh_k, fresh_v=fresh_v, tail_kv=tail_kv,
            tail_scale=tail_scale, tail_len=tail_len, alibi=alibi)
        return torch.where((context_len > 0)[:, None, None], out,
                           torch.zeros((), dtype=out.dtype))
    if q.device.type != "cuda":
        raise ValueError(f"paged_decode_attention: device {q.device}")
    b, hq, hd = q.shape
    kvh = spec.num_kv_heads
    _check_common("paged_decode_attention", q, cache, scale, spec,
                  page_table)
    if context_len.dtype != torch.int32:
        raise TypeError("paged_decode_attention: context_len must be int32")
    if (hq % kvh or hd != spec.head_dim or tuple(fresh_k.shape) != (b, kvh, hd)
            or fresh_k.shape != fresh_v.shape or page_table.shape[0] != b
            or tuple(context_len.shape) != (b,)):
        raise ValueError("paged_decode_attention: inconsistent shapes")
    if fresh_k.dtype != q.dtype or fresh_v.dtype != q.dtype:
        raise TypeError("paged_decode_attention: fresh k/v dtype must be "
                        "q's")
    g = hq // kvh
    tc = q.dtype == torch.bfloat16
    if tc and (hd not in _HEAD_DIMS or g > _DEC_TC_ROWS):
        raise ValueError(f"paged_decode_attention: head_dim {hd} / group {g} "
                         f"not supported (head_dim in {_HEAD_DIMS}, group "
                         f"<= {_DEC_TC_ROWS})")
    if not tc and g * hd > _DEC_MAX_OUT:
        raise ValueError("paged_decode_attention: G*head_dim too large")
    if splits is not None and splits < 1:
        raise ValueError(f"paged_decode_attention: splits {splits} < 1")
    extra = {"scale": scale} if spec.quantized else {}
    jt = 0
    if tail_kv is not None:
        jt = _check_tail(tail_kv, tail_scale, tail_len, cache, spec, b)
        extra.update(tail_kv=tail_kv, tail_len=tail_len)
        if spec.quantized:
            extra["tail_scale"] = tail_scale
    if alibi is not None:
        _check_alibi("paged_decode_attention", alibi, hq)
        extra["alibi"] = alibi
    _check_cuda("paged_decode_attention", q.device,
                ("cache", "scale", "tail_kv", "tail_scale"), q=q,
                cache=cache, page_table=page_table, context_len=context_len,
                fresh_k=fresh_k, fresh_v=fresh_v, **extra)
    out = torch.empty_like(q)
    if b == 0:
        return out
    s, part, done = 1, None, None
    if tc:
        s = splits or plan_decode_splits(b, kvh, page_table.shape[1],
                                         _build.sm_count(q.device))
        if s > 1:
            # the splits' partials (acc [G, hd], m [G], l [G]) and one
            # arrival counter a (row, kv head)
            part = torch.empty(b * kvh * s * g * (hd + 2),
                               dtype=torch.float32, device=q.device)
            done = torch.zeros(b * kvh, dtype=torch.int32, device=q.device)
    err = _lib().ppl_paged_decode_attention(
        _DTYPE_CODE[q.dtype], int(spec.quantized), q.data_ptr(),
        cache.data_ptr(), _ptr(extra.get("scale")), spec.scale_lanes,
        page_table.data_ptr(), context_len.data_ptr(), fresh_k.data_ptr(),
        fresh_v.data_ptr(), out.data_ptr(), b, hq, kvh, hd, spec.shd,
        page_table.shape[1], spec.page_size, cache.shape[1], layer,
        spec.num_slots, _DECODE_CHUNK, hd ** -0.5,
        _ptr(extra.get("tail_kv")), _ptr(extra.get("tail_scale")),
        _ptr(extra.get("tail_len")), jt, _ptr(alibi), s, _ptr(part),
        _ptr(done), torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_decode_attention: launch failed "
                           f"(cudaError {err})")
    paged_decode_attention.launches += 1
    if tail_kv is not None:
        paged_decode_attention.tail_launches += 1
    if alibi is not None:
        paged_decode_attention.alibi_launches += 1
    return out


paged_decode_attention.launches = 0
paged_decode_attention.tail_launches = 0
paged_decode_attention.alibi_launches = 0


def _check_tail(tail_kv, tail_scale, tail_len, cache, spec: CacheSpec,
                b: int) -> int:
    """Shapes and dtypes of the block-tail arguments; returns J."""
    name = "paged_decode_attention"
    if tail_kv.dtype != cache.dtype:
        raise TypeError(f"{name}: tail_kv dtype {tail_kv.dtype}, expected "
                        f"the cache's {cache.dtype}")
    if (tail_kv.ndim != 5 or tuple(tail_kv.shape[:3])
            != (spec.num_layers, b, spec.num_kv_heads)
            or tail_kv.shape[4] != spec.row_lanes):
        raise ValueError(f"{name}: tail_kv shape {tuple(tail_kv.shape)}, "
                         f"expected ({spec.num_layers}, {b}, "
                         f"{spec.num_kv_heads}, J, {spec.row_lanes})")
    jt = tail_kv.shape[3]
    if not 1 <= jt <= _DECODE_CHUNK:
        raise ValueError(f"{name}: {jt} tail rows; the tail phase takes "
                         f"1 to {_DECODE_CHUNK}")
    if spec.quantized:
        _check_scale_rows(name, "tail_scale", tail_scale,
                          (spec.num_layers, b, jt, spec.scale_lanes))
    elif tail_scale is not None:
        raise ValueError(f"{name}: tail_scale given for a float cache")
    if (tail_len is None or tail_len.dtype != torch.int32
            or tuple(tail_len.shape) != (1,)):
        raise TypeError(f"{name}: tail_len must be int32 [1]")
    return jt


def paged_prefill_attention(
    q: torch.Tensor,             # [Bp, Qp, Hq, hd]
    cache: torch.Tensor,         # [KVH, L*S, 2*shd] (int8 when quantized)
    scale,                       # bf16 [L*S, scale_lanes] or None
    page_table: torch.Tensor,    # i32[Bp, P]
    start: torch.Tensor,         # i32[Bp]
    new_len: torch.Tensor,       # i32[Bp]
    spec: CacheSpec,
    *,
    layer: int,
    fresh_kv: torch.Tensor,      # [Bp, KVH, Qp, 2*shd] packed rows
    fresh_scale=None,            # bf16 [Bp, Qp, scale_lanes] if int8
    alibi=None,                  # f32[Hq] ALiBi slopes
) -> torch.Tensor:               # [Bp, Qp, Hq, hd]
    """K2: chunked-causal prefill attention over the paged cache with
    ``start > 0`` support; positions ``>= start`` read ``fresh_kv``."""
    hd = spec.head_dim
    if q.device.type == "cpu":
        fk = fresh_kv[..., :hd].permute(0, 2, 1, 3)
        fv = fresh_kv[..., spec.shd:spec.shd + hd].permute(0, 2, 1, 3)
        if spec.quantized:
            bp, qp = fk.shape[:2]
            s = fresh_scale[..., :spec.num_kv_heads * spec.scale_lane_stride]
            s = s.reshape(bp, qp, spec.num_kv_heads, 2, spec.scale_groups)
            fk = kv_ops.dequantize_kv(fk, s[..., 0, :], spec.quant_group,
                                      q.dtype)
            fv = kv_ops.dequantize_kv(fv, s[..., 1, :], spec.quant_group,
                                      q.dtype)
        return attn_ops.prefill_attention_ref(
            q, cache, scale, page_table, start, new_len, spec, layer=layer,
            fresh_k=fk, fresh_v=fv, alibi=alibi)
    if q.device.type != "cuda":
        raise ValueError(f"paged_prefill_attention: device {q.device}")
    bp, qp, hq, qhd = q.shape
    kvh = spec.num_kv_heads
    _check_common("paged_prefill_attention", q, cache, scale, spec,
                  page_table)
    if start.dtype != torch.int32 or new_len.dtype != torch.int32:
        raise TypeError("paged_prefill_attention: start/new_len must be "
                        "int32")
    if (hq % kvh or qhd != hd or page_table.shape[0] != bp
            or tuple(fresh_kv.shape) != (bp, kvh, qp, spec.row_lanes)
            or tuple(start.shape) != (bp,) or tuple(new_len.shape) != (bp,)):
        raise ValueError("paged_prefill_attention: inconsistent shapes")
    if fresh_kv.dtype != cache.dtype:
        raise TypeError("paged_prefill_attention: fresh_kv dtype must be "
                        "the cache's")
    if hd not in _HEAD_DIMS or hq // kvh > _PREFILL_ROWS:
        raise ValueError(f"paged_prefill_attention: head_dim {hd} / group "
                         f"{hq // kvh} not supported")
    extra = {}
    if spec.quantized:
        _check_scale_rows("paged_prefill_attention", "fresh_scale",
                          fresh_scale, (bp, qp, spec.scale_lanes))
        extra = {"scale": scale, "fresh_scale": fresh_scale}
    if alibi is not None:
        _check_alibi("paged_prefill_attention", alibi, hq)
        extra["alibi"] = alibi
    _check_cuda("paged_prefill_attention", q.device,
                ("cache", "fresh_kv", "scale", "fresh_scale"), q=q,
                cache=cache, page_table=page_table, start=start,
                new_len=new_len, fresh_kv=fresh_kv, **extra)
    out = torch.empty_like(q)
    if bp == 0 or qp == 0:
        return out
    err = _lib().ppl_paged_prefill_attention(
        _DTYPE_CODE[q.dtype], int(spec.quantized), q.data_ptr(),
        cache.data_ptr(), _ptr(extra.get("scale")), spec.scale_lanes,
        page_table.data_ptr(), start.data_ptr(), new_len.data_ptr(),
        fresh_kv.data_ptr(), _ptr(extra.get("fresh_scale")), out.data_ptr(),
        bp, qp, hq, kvh, hd, spec.shd,
        page_table.shape[1], spec.page_size, cache.shape[1], layer,
        spec.num_slots, hd ** -0.5, _ptr(alibi),
        torch.cuda.current_stream(q.device).cuda_stream)
    if err:
        raise RuntimeError(f"paged_prefill_attention: launch failed "
                           f"(cudaError {err})")
    paged_prefill_attention.launches += 1
    if alibi is not None:
        paged_prefill_attention.alibi_launches += 1
    return out


paged_prefill_attention.launches = 0
paged_prefill_attention.alibi_launches = 0
