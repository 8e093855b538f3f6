"""Fused dynamic-quant i8i8 (K3) and w4a8 (K4) matmuls: wrappers of the
CUDA kernels in ``csrc/quant_matmul.cu``.

On the CPU each wrapper runs its plain version (:func:`..quant.i8i8_matmul`,
:func:`..quant.w4a8_matmul`); on a CUDA tensor it launches the kernels (a
per-token quantize pass, then the int8 x int8 or int8 x int4 GEMM with
the scale epilogue) or raises, never falling back.
``i8i8_matmul.launches`` and ``w4a8_matmul.launches`` count launches, and
``i8i8_matmul.<tile>_launches`` K3's by tile (:data:`TILES`).

K3 routes by T alone (:func:`k3_tile`): up to ``DECODE_MAX_T`` = 64
tokens, the served decode bucket, the decode tile, which streams the
weight (a TMA ring, 256 columns a CTA) over pieces of K that
:func:`plan_split_k` chooses, one thread block cluster of at most
``MAX_PIECES`` a column tile, the pieces' int32 sums added in the
cluster's shared memory; above it (and for a weight whose rows are not
whole 16-byte units, N % 16 > 0) the prefill tile, whole. K4 runs its
decode tile up to ``W4_DECODE_MAX_T`` = 16 tokens, over pieces of whole
groups (:func:`plan_split_k_w4`) that write f32 partials which the last
piece of a column tile adds in piece order, its arrival counters kept per
device and left at zero by every launch; above it its prefill tile.
Either way every run gives the same bits, with nothing zeroed per call.
``splits=`` asks a decode tile for another piece count than the
planner's (the microbench and the card tests sweep it; the model never
passes it).

Same two weight contracts as the JAX package's Pallas kernels: plain
x [T, D] x w [D, ...out] -> [T, ...out] (w4a8: packed [D/2, ...out],
scales [G, ...out]); fused w [C, D, N] (w4a8: [C, D/2, N], scales
[C, G, N]) -> [C, T, N]. ``out_dtype`` is written by the epilogue.
"""

from __future__ import annotations

import ctypes

import torch

from .. import quant as quant_ops
from . import _build

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}
_W4_GROUPS = (16, 32, 64, 128)   # the GROUP instantiations in the .cu
DECODE_MAX_T = 64    # kDcMaxT in the .cu: K3's decode tile's largest T
W4_DECODE_MAX_T = 16  # kW4DecodeMaxT: K4's decode tile's largest T
K_STAGE = 64         # kDcBK: K3's contraction rows per stage, and per piece
ROW_ALIGN = 128      # kPfBK: the int8 activation rows' stride is a multiple of it
TILE_N = 128         # kTileN: weight columns per CTA (K4, K3's prefill tile)
DECODE_TILE_N = 256  # kDcCols: weight columns per CTA of K3's decode tile
MAX_PIECES = 8       # kDcMaxPieces: K3's decode tile's pieces, a portable cluster
W4_STAGE = 64        # kW4Stage: K4's packed rows per stage, at least
CTAS_PER_SM = 2      # what K4's split-K planner aims for at decode sizes
# what K3's decode tile aims for: one CTA a SM, each with its ring's 80 kB
# in flight, and no more than the one wave of two a SM that fits
DECODE_CTAS_PER_SM = 1
# K3's tiles, the .cu's kTilePrefill, kTileDecode
TILES = ("prefill", "decode")
_P = ctypes.c_void_p
_I = ctypes.c_int


def _lib():
    lib = _build.load("quant_matmul")
    if not getattr(lib, "_ppl_typed", False):
        lib.ppl_i8i8_quantize_rows.argtypes = [_I, _P, _P, _P, _I, _I, _I,
                                               _I, _P]
        lib.ppl_i8i8_quantize_rows.restype = _I
        lib.ppl_i8i8_gemm.argtypes = [_I, _I, _P, _I, _P, _P, _P, _P, _I,
                                      _I, _I, _I, _I, _I, _P]
        lib.ppl_i8i8_gemm.restype = _I
        lib.ppl_w4a8_gemm.argtypes = [_I, _P, _I, _P, _P, _P, _P, _I, _I,
                                      _I, _I, _I, _I, _I, _P, _P, _P]
        lib.ppl_w4a8_gemm.restype = _I
        lib._ppl_typed = True
    return lib


def _check_x(name: str, x: torch.Tensor, out_dtype: torch.dtype) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{name}: device {x.device}")
    if x.ndim != 2 or x.dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: x must be 2-D float32/bfloat16, got "
                        f"{tuple(x.shape)} {x.dtype}")
    if out_dtype not in _DTYPE_CODE:
        raise TypeError(f"{name}: out_dtype {out_dtype} not supported")


def _check_operands(name: str, x: torch.Tensor, **tensors) -> None:
    """Every operand contiguous, on x's device and 16-byte aligned."""
    for key, ten in (("x", x),) + tuple(tensors.items()):
        if ten.device != x.device or not ten.is_contiguous():
            raise ValueError(f"{name}: {key} must be a contiguous "
                             f"tensor on {x.device}")
        if ten.data_ptr() % 16:
            raise ValueError(f"{name}: {key} must be 16-byte aligned")


def _quantize_rows(name: str, lib, x: torch.Tensor, stream, ld=None,
                   k16=False):
    """The per-token int8 pass: x [T, D] -> (int8 [T, ld], zero past D,
    f32 [T]); ``ld`` defaults to D; ``k16``: each 16-byte group in the
    order K3's decode tile reads (``dc_k16_offset`` in the .cu)."""
    t, d = x.shape
    ld = d if ld is None else ld
    xq = torch.empty((t, ld), dtype=torch.int8, device=x.device)
    xs = torch.empty((t,), dtype=torch.float32, device=x.device)
    err = lib.ppl_i8i8_quantize_rows(_DTYPE_CODE[x.dtype], x.data_ptr(),
                                     xq.data_ptr(), xs.data_ptr(), t, d, ld,
                                     int(k16), stream)
    if err:
        raise RuntimeError(f"{name}: quantize launch failed (cudaError "
                           f"{err})")
    return xq, xs


def _pieces(stages: int, tiles: int, num_sms: int, stage: int,
            splits=None):
    """K4's ``(splits, kchunk)`` over ``stages`` stages of ``stage`` rows:
    the planner's rule (see :func:`plan_split_k_w4`), or ``ceil(stages /
    splits)`` stages a piece for an explicit ``splits``, none empty (so
    fewer pieces than asked where that leaves one empty)."""
    if splits is not None:
        if splits < 1:
            raise ValueError(f"splits {splits} < 1")
        per_piece = -(-stages // splits)
    else:
        want = -(-CTAS_PER_SM * num_sms // tiles)
        per_piece = max(1, stages // want)
    return -(-stages // per_piece), per_piece * stage


def k3_tile(t: int, n: int) -> str:
    """K3's tile for ``t`` tokens and ``n`` weight columns (one of
    :data:`TILES`): the decode tile up to ``DECODE_MAX_T`` tokens where
    its tensor map takes the weight (``n % 16 == 0``: whole 16-byte rows),
    else the prefill tile."""
    return "decode" if t <= DECODE_MAX_T and n % 16 == 0 else "prefill"


def plan_split_k(t: int, d: int, n: int, c: int, num_sms: int,
                 splits=None):
    """K3's pieces of K: ``(splits, kchunk)``. On the prefill tile
    (:func:`k3_tile`) one piece, ``(1, D rounded up to K_STAGE)``. On the
    decode tile piece ``i`` covers rows ``[i*kchunk, min(D, (i+1) *
    kchunk))``, ``kchunk`` a multiple of ``K_STAGE``, none empty, at most
    ``MAX_PIECES``: the fewest pieces whose CTAs (``c * ceil(n /
    DECODE_TILE_N)`` column tiles times the pieces) reach
    ``DECODE_CTAS_PER_SM * num_sms``, unless K's stages or the cluster cap
    them, or for an explicit ``splits`` that many (fewer where a piece
    would be empty, and ``MAX_PIECES`` at most)."""
    stages = -(-d // K_STAGE)
    if k3_tile(t, n) == "prefill":
        if splits is not None and splits != 1:
            raise ValueError(f"splits {splits}: the prefill tile (T > "
                             f"{DECODE_MAX_T}, or N % 16 > 0) runs whole")
        return 1, stages * K_STAGE
    if splits is None:
        tiles = c * -(-n // DECODE_TILE_N)
        splits = -(-DECODE_CTAS_PER_SM * num_sms // tiles)
    elif splits < 1:
        raise ValueError(f"splits {splits} < 1")
    # as even as whole stages allow: the cluster waits for its longest piece
    per_piece = -(-stages // min(splits, stages, MAX_PIECES))
    return -(-stages // per_piece), per_piece * K_STAGE


def plan_split_k_w4(t: int, d2: int, n: int, c: int, num_sms: int,
                    group: int, splits=None):
    """K4's pieces of the ``d2`` packed rows: ``(splits, kchunk)`` in
    packed rows, by :func:`_pieces`' rule over stages of
    ``max(group, W4_STAGE)`` packed rows (whole groups): above
    ``W4_DECODE_MAX_T`` tokens one piece; at decode sizes none empty, and
    ``c * ceil(n / TILE_N) * splits`` CTAs reach ``CTAS_PER_SM *
    num_sms`` (pieces of ``stages // want`` stages, ``want`` the pieces
    that needs) unless the rows have fewer stages than that needs. An
    explicit ``splits`` overrides that choice (:func:`_pieces`)."""
    ksp = max(group, W4_STAGE)
    stages = -(-d2 // ksp)
    if t > W4_DECODE_MAX_T:
        if splits is not None and splits != 1:
            raise ValueError(f"splits {splits}: the prefill tile (T > "
                             f"{W4_DECODE_MAX_T}) runs whole")
        return 1, stages * ksp
    return _pieces(stages, c * -(-n // TILE_N), num_sms, ksp, splits)


_COUNTERS = {}      # device -> K4's int32 arrival counters, all zero
_MIN_COUNTERS = 4096


def _w4_counters(device, needed: int) -> torch.Tensor:
    """K4's split-K arrival counters on ``device``: zero between launches
    (the last piece of each column tile puts its counter back), so one
    buffer serves every call, eager or replayed in a CUDA graph. It is
    allocated outside any graph capture: growing it inside one would
    leave it in the graph's memory pool."""
    buf = _COUNTERS.get(device)
    if buf is None or buf.numel() < needed:
        if torch.cuda.is_current_stream_capturing():
            raise RuntimeError(
                "w4a8_matmul: split-K counters must grow to "
                f"{needed} during a CUDA graph capture; run the same "
                "shapes eagerly first")
        buf = torch.zeros(max(_MIN_COUNTERS, needed), dtype=torch.int32,
                          device=device)
        _COUNTERS[device] = buf
    return buf


def i8i8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                splits=None) -> torch.Tensor:
    """K3: per-token int8 activations x int8 weights, int32 sums, the f32
    epilogue, ``out_dtype`` out; ``splits``: the decode tile's pieces of K
    (:func:`plan_split_k`'s choice when None)."""
    if splits is not None and splits < 1:
        raise ValueError(f"i8i8_matmul: splits {splits} < 1")
    if x.device.type == "cpu":
        return quant_ops.i8i8_matmul(x, w_q, w_scale).to(out_dtype)
    _check_x("i8i8_matmul", x, out_dtype)
    if w_q.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("i8i8_matmul: w_q must be int8 and w_scale float32")
    t, d = x.shape
    fused = w_q.ndim == 3
    if fused:
        c, d2, n = w_q.shape
        out_shape = None
    else:
        c, d2 = 1, w_q.shape[0]
        out_shape = tuple(w_q.shape[1:])
        n = w_q[0].numel()
    if d2 != d or w_scale.numel() != c * n:
        raise ValueError(f"i8i8_matmul: x {tuple(x.shape)} w "
                         f"{tuple(w_q.shape)} scale {tuple(w_scale.shape)}")
    if d % 4 or n % 4:
        raise ValueError("i8i8_matmul: D and N must be multiples of 4")
    _check_operands("i8i8_matmul", x, w_q=w_q, w_scale=w_scale)
    out = torch.empty((c, t, n), dtype=out_dtype, device=x.device)
    if t:
        lib = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        tile = k3_tile(t, n)
        splits, kchunk = plan_split_k(t, d, n, c, _build.sm_count(x.device),
                                      splits)
        ldx = -(-d // ROW_ALIGN) * ROW_ALIGN
        xq, xs = _quantize_rows("i8i8_matmul", lib, x, stream, ldx,
                                k16=tile == "decode")
        err = lib.ppl_i8i8_gemm(_DTYPE_CODE[out_dtype], TILES.index(tile),
                                xq.data_ptr(), ldx, xs.data_ptr(),
                                w_q.data_ptr(), w_scale.data_ptr(),
                                out.data_ptr(), t, d, n, c, splits, kchunk,
                                stream)
        if err:
            raise RuntimeError(f"i8i8_matmul: launch failed (cudaError "
                               f"{err})")
        i8i8_matmul.launches += 1
        setattr(i8i8_matmul, f"{tile}_launches",
                getattr(i8i8_matmul, f"{tile}_launches") + 1)
    if fused:
        return out
    return out[0].reshape((t,) + out_shape)


i8i8_matmul.launches = 0
for _tile in TILES:     # launches by tile
    setattr(i8i8_matmul, f"{_tile}_launches", 0)


def w4a8_matmul(x: torch.Tensor, w_p: torch.Tensor, w_scale: torch.Tensor,
                out_dtype: torch.dtype = torch.float32,
                splits=None) -> torch.Tensor:
    """K4: per-token int8 activations x group-int4 weights (nibble pairs
    i, i + D/2), f32 accumulation, ``out_dtype`` out; ``splits``: the
    decode tile's pieces (:func:`plan_split_k_w4`'s choice when None)."""
    if splits is not None and splits < 1:
        raise ValueError(f"w4a8_matmul: splits {splits} < 1")
    if x.device.type == "cpu":
        return quant_ops.w4a8_matmul(x, w_p, w_scale).to(out_dtype)
    _check_x("w4a8_matmul", x, out_dtype)
    if w_p.dtype != torch.int8 or w_scale.dtype != torch.float32:
        raise TypeError("w4a8_matmul: w_p must be int8 (packed int4) and "
                        "w_scale float32")
    t, d = x.shape
    fused = w_p.ndim == 3
    if fused:
        c, d2, n = w_p.shape
        g = w_scale.shape[1] if w_scale.ndim == 3 else -1
        out_shape = None
    else:
        c, d2 = 1, w_p.shape[0]
        g = w_scale.shape[0]
        out_shape = tuple(w_p.shape[1:])
        n = w_p[0].numel()
    if (2 * d2 != d or g <= 0 or d % g
            or w_scale.numel() != c * g * n):
        raise ValueError(f"w4a8_matmul: x {tuple(x.shape)} w_p "
                         f"{tuple(w_p.shape)} w_scale "
                         f"{tuple(w_scale.shape)}")
    group = d // g
    if group not in _W4_GROUPS or d2 % group:
        raise ValueError(f"w4a8_matmul: group {group} not supported "
                         f"(one of {_W4_GROUPS}, dividing D/2)")
    if n % 4:
        raise ValueError("w4a8_matmul: N must be a multiple of 4")
    _check_operands("w4a8_matmul", x, w_p=w_p, w_scale=w_scale)
    out = torch.empty((c, t, n), dtype=out_dtype, device=x.device)
    if t:
        lib = _lib()
        stream = torch.cuda.current_stream(x.device).cuda_stream
        splits, kchunk = plan_split_k_w4(t, d2, n, c,
                                         _build.sm_count(x.device), group,
                                         splits)
        # D % 32 == 0 (D/2 is a multiple of the group), so rows of D
        # bytes keep every 16-byte chunk of both column ranges whole
        xq, xs = _quantize_rows("w4a8_matmul", lib, x, stream)
        part = done = None
        if splits > 1:
            part = torch.empty((splits, c, t, n), dtype=torch.float32,
                               device=x.device)
            done = _w4_counters(x.device, c * -(-n // TILE_N))
        err = lib.ppl_w4a8_gemm(_DTYPE_CODE[out_dtype], xq.data_ptr(), d,
                                xs.data_ptr(), w_p.data_ptr(),
                                w_scale.data_ptr(), out.data_ptr(), t, d2, n,
                                c, group, splits, kchunk,
                                0 if part is None else part.data_ptr(),
                                0 if done is None else done.data_ptr(),
                                stream)
        if err:
            raise RuntimeError(f"w4a8_matmul: launch failed (cudaError "
                               f"{err})")
        w4a8_matmul.launches += 1
    if fused:
        return out
    return out[0].reshape((t,) + out_shape)


w4a8_matmul.launches = 0
