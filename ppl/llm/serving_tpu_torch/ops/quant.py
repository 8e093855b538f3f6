"""Dynamic per-token INT8 activation x INT8 or groupwise INT4 weight
matmuls: the plain PyTorch versions.

Mirrors ``serving_tpu/ops/quant.py``:

- ``online_i8i8`` (``quantize_weight``, ``quantize_activation``,
  ``i8i8_matmul``): weights are quantized once with symmetric
  per-output-channel absmax scales, activations on the fly with symmetric
  per-token absmax scales (``absmax / 127``, round half to even, clip to
  +-127), the int8 x int8 product accumulates exactly, and the epilogue
  multiplies by ``x_scale * w_scale``.
- ``online_w4a8`` (``quantize_weight_int4``, ``unpack_int4``,
  ``w4a8_matmul``): int4 weights in [-7, 7] with one scale per group of 64
  contraction rows, chosen by a 12-step MSE search; byte ``i`` of the
  packed weight holds row ``i`` in its low nibble and row ``i + D/2`` in
  its high nibble. The product is exact per group, scaled per (group,
  column), summed over groups and multiplied by the token scale.

The CUDA kernels in :mod:`.kernels.quant_matmul` compute the same numbers.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch


def _scale_and_inverse(absmax: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """scale = absmax / 127 and inv = 1 / max(scale, 1e-10) (0 where the
    scale is 0), both as true IEEE divisions of two tensors: PyTorch's
    CUDA division by a Python scalar multiplies by the scalar's
    reciprocal, which can differ by an ulp and flip a rounding."""
    scale = torch.div(absmax, torch.full_like(absmax, 127.0))
    inv = torch.div(torch.ones_like(scale), torch.clamp(scale, min=1e-10))
    return scale, torch.where(scale > 0, inv, torch.zeros_like(inv))


def quantize_weight(w: torch.Tensor, contract_axis: int = 0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-output-channel symmetric int8 quantization.

    ``contract_axis`` is the axis the matmul contracts over; returns
    (int8 weights, f32 scales shaped like w without that axis)."""
    w32 = w.to(torch.float32)
    scale, inv = _scale_and_inverse(w32.abs().amax(dim=contract_axis))
    q = torch.clamp(torch.round(w32 * inv.unsqueeze(contract_axis)),
                    -127, 127).to(torch.int8)
    return q, scale


def quantize_activation(x: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Dynamic per-token (last-axis) symmetric int8 quantization:
    x [T, D] -> (int8 [T, D], f32 scales [T])."""
    x32 = x.to(torch.float32)
    scale, inv = _scale_and_inverse(x32.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x32 * inv[:, None]), -127, 127).to(torch.int8)
    return q, scale


def _int_product(x_q: torch.Tensor, w_q2: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> f32-converted int32 sums. float64 holds every
    partial sum exactly (|sum| < 2^53), and its conversion to f32 rounds
    the same integer the way int32 -> f32 does."""
    return torch.matmul(x_q.to(torch.float64),
                        w_q2.to(torch.float64)).to(torch.float32)


def i8i8_matmul(x: torch.Tensor, w_q: torch.Tensor, w_scale: torch.Tensor
                ) -> torch.Tensor:
    """Fused dynamic-quant int8 matmul, f32 out.

    - plain: x [T, D] x w_q [D, ...out] -> [T, ...out]
    - fused 3-axis: w_q [C, D, N] (C leading), w_scale [C, N] -> [C, T, N]
    """
    x_q, x_scale = quantize_activation(x)
    if w_q.ndim == 3:
        acc = torch.stack([_int_product(x_q, w_q[c])
                           for c in range(w_q.shape[0])])   # [C, T, N]
        scale = x_scale[None, :, None] * w_scale[:, None, :]
        return acc * scale
    out_shape = tuple(w_q.shape[1:])
    acc = _int_product(x_q, w_q.reshape(w_q.shape[0], -1)).reshape(
        (x.shape[0],) + out_shape)
    scale = x_scale.reshape(x_scale.shape + (1,) * len(out_shape)) * w_scale
    return acc * scale


# ---------------------------------------------------------------- w4a8

def _search_factors(steps: int) -> torch.Tensor:
    """The f32 values of ``jnp.linspace(1.0, 0.55, steps)`` as the JAX
    package gets them: XLA folds the division by ``steps - 1`` into a
    multiply by its f32 reciprocal and contracts ``(1 - i*c1) + i*c2``
    (``c2 = f32(0.55 * c1)``) into one fused multiply-add, which float64
    reproduces (the exact sum fits in 53 bits, then one rounding)."""
    f32 = np.float32
    i = np.arange(steps - 1, dtype=f32)
    c1 = f32(f32(1.0) / f32(steps - 1))
    c2 = f32(f32(0.55) * c1)
    head = ((f32(1.0) - i * c1).astype(np.float64)
            + i.astype(np.float64) * np.float64(c2)).astype(f32)
    return torch.from_numpy(np.append(head, f32(0.55)))


def _sum_groups(x: torch.Tensor) -> torch.Tensor:
    """Sum over axis 1 in the order XLA's CPU backend uses for the JAX
    package's ``jnp.sum(..., axis=1)``: windows of 32 rows summed one row
    at a time, then the window sums, recursively. The scale search keeps
    a candidate only when its error is strictly smaller, so the order of
    these f32 sums decides near-ties and with them the packed bytes."""
    while x.shape[1] > 32:
        n = x.shape[1]
        nw = -(-n // 32)
        if nw * 32 != n:
            pad = x.new_zeros((x.shape[0], nw * 32 - n) + x.shape[2:])
            x = torch.cat([x, pad], dim=1)
        xw = x.reshape((x.shape[0], nw, 32) + x.shape[2:])
        acc = xw[:, :, 0]
        for i in range(1, 32):
            acc = acc + xw[:, :, i]
        x = acc
    acc = x[:, 0]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
    return acc


def quantize_weight_int4(w: torch.Tensor, group: int = 64,
                         search_steps: int = 12
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Groupwise symmetric int4 quantization along axis 0 (the
    contraction axis) with the per-(group, column) MSE scale search.

    w: [D, ...out] -> (packed int8 [D/2, ...out], f32 scales
    [D/group, ...out]); ``group`` halves until it divides D/2. Candidate
    scales ``absmax/7 * k`` for the 12 factors k from 1.0 down to 0.55
    are scored by the round-trip squared error; a later candidate wins
    only with a strictly smaller error. ``search_steps=0`` is plain
    absmax rounding.
    """
    d = w.shape[0]
    while group > 1 and d % (2 * group):
        group //= 2
    if d % (2 * group):
        raise ValueError(f"quantize_weight_int4: D={d} has no group")
    grouped = w.to(torch.float32).reshape((d // group, group)
                                          + tuple(w.shape[1:]))
    absmax = grouped.abs().amax(dim=1)                       # [G, ...out]
    scale0 = torch.div(absmax, torch.full_like(absmax, 7.0))

    def quantize(scale):
        inv = torch.div(torch.ones_like(scale),
                        torch.clamp(scale, min=1e-10))
        inv = torch.where(scale > 0, inv, torch.zeros_like(inv))
        return torch.clamp(torch.round(grouped * inv.unsqueeze(1)), -7, 7)

    scale = scale0
    if search_steps > 1:
        best_err = None
        for k in _search_factors(search_steps).to(w.device):
            cand = scale0 * k
            err = quantize(cand) * cand.unsqueeze(1) - grouped
            err = _sum_groups(err * err)
            if best_err is None:
                best_err, scale = err, cand
            else:
                better = err < best_err
                best_err = torch.where(better, err, best_err)
                scale = torch.where(better, cand, scale)
    q = quantize(scale).to(torch.int32).reshape(w.shape)
    lo, hi = q[: d // 2], q[d // 2:]
    packed = ((hi & 0xF) << 4) | (lo & 0xF)
    return packed.to(torch.int8), scale


def _sign_nibble(n: torch.Tensor) -> torch.Tensor:
    """Nibble values 0..15 (int32) -> their signed value -8..7."""
    return n - ((n & 8) << 1)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of the nibble packing: int8 [D/2, ...] -> int8 [D, ...],
    the low nibbles' rows first, then the high nibbles'."""
    b = packed.to(torch.int32)
    lo = _sign_nibble(b & 0xF)
    hi = _sign_nibble((b >> 4) & 0xF)
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def _w4_product(x_q: torch.Tensor, x_scale: torch.Tensor,
                w_p: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """x_q [T, D] int8 x packed [D/2, N] with scales [G, N] -> f32
    [T, N]. Each group's int8 x int4 sum is exact (float64 holds it),
    converted to f32, scaled by its (group, column) scale; the groups are
    summed in order and the sum is scaled by the token scale."""
    g = w_scale.shape[0]
    group = x_q.shape[1] // g
    w = unpack_int4(w_p).to(torch.float64)                   # [D, N]
    x64 = x_q.to(torch.float64)
    out = None
    for i in range(g):
        rows = slice(i * group, (i + 1) * group)
        part = torch.matmul(x64[:, rows], w[rows]).to(torch.float32)
        part = part * w_scale[i]
        out = part if out is None else out + part
    return out * x_scale[:, None]


def w4a8_matmul(x: torch.Tensor, w_p: torch.Tensor, w_scale: torch.Tensor
                ) -> torch.Tensor:
    """Fused dynamic-quant int8 activation x groupwise int4 weight matmul,
    f32 out.

    - plain: x [T, D] x packed [D/2, ...out], scales [G, ...out]
      -> [T, ...out]
    - fused 3-axis: packed [C, D/2, N] (C leading), scales [C, G, N]
      -> [C, T, N]
    """
    x_q, x_scale = quantize_activation(x)
    if w_p.ndim == 3:
        return torch.stack([_w4_product(x_q, x_scale, w_p[c], w_scale[c])
                            for c in range(w_p.shape[0])])
    out_shape = tuple(w_p.shape[1:])
    out = _w4_product(x_q, x_scale, w_p.reshape(w_p.shape[0], -1),
                      w_scale.reshape(w_scale.shape[0], -1))
    return out.reshape((x.shape[0],) + out_shape)
