"""Paged KV-cache layout and in-place update ops (PyTorch).

The logical layout is exactly the JAX package's (``serving_tpu/ops/
kv_cache.py``), so a cache after a step compares byte for byte:

    cache:  [num_kv_heads, L * num_slots, 2 * shd]   (k|v PACKED rows)
    scale:  [L * num_slots, scale_lanes]             (int8 KV only)

The layer axis lives inside the slot axis (layer ``l``'s slot ``s`` is
row ``l * num_slots + s``), head-major. ``num_slots = (num_pages + 1) *
page_size``: a (page, offset) pair addresses slot ``page * page_size +
offset``, and the extra page at index ``num_pages`` is the trash page
that padding tokens write to. Each slot row packs the token's K vector
in lanes ``[0, shd)`` and its V vector in lanes ``[shd, 2*shd)``.

On Hopper one (head, page) tile is a contiguous ``[page_size, 2*shd]``
block: the attention kernels read a token's K and V with one 16-byte
vectorised row walk. ``shd`` is ``head_dim`` (the JAX package's 64-lane
rounding is a Mosaic DMA rule with no counterpart here).

int8 KV (``cache_quant_bit=8``, ``cache_quant_group=8``) stores int8
rows and one bf16 scale per group of 8 lanes: a packed scale row per slot
holds every head's k then v group scales, in lane order (head, k|v,
group). The JAX package pads that row to 128 lanes for Mosaic's DMA
rule; here it is padded to 8 lanes (16 bytes) only, so the used lanes
compare equal and the padding differs.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class CacheSpec:
    num_layers: int
    num_pages: int  # usable pages (excludes the trash page)
    page_size: int
    num_kv_heads: int
    head_dim: int
    quant_bit: int = 0
    quant_group: int = 1
    dtype: torch.dtype = torch.bfloat16
    storage_head_dim: Optional[int] = None

    @property
    def shd(self) -> int:
        return self.storage_head_dim or self.head_dim

    @property
    def row_lanes(self) -> int:
        """Packed k|v row width."""
        return 2 * self.shd

    @property
    def num_slots(self) -> int:
        return (self.num_pages + 1) * self.page_size

    @property
    def trash_page(self) -> int:
        return self.num_pages

    @property
    def quantized(self) -> bool:
        return self.quant_bit == 8

    @property
    def scale_groups(self) -> int:
        return max(self.head_dim // self.quant_group, 1)

    @property
    def scale_lane_stride(self) -> int:
        """Lanes per kv head in the packed scale row: k then v groups."""
        return 2 * self.scale_groups

    @property
    def scale_lanes(self) -> int:
        """Packed scale-row width: the used lanes rounded up to 8."""
        return -(-self.num_kv_heads * self.scale_lane_stride // 8) * 8


def init_cache(spec: CacheSpec, device
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Allocate the zeroed (cache, scale) pair: the stacked cache
    ``[kv_heads, L * num_slots, 2*shd]`` (int8 when quantized, else the
    spec's dtype) and the bf16 scale rows ``[L * num_slots,
    scale_lanes]``, None when unquantized. The engine keeps both for its
    whole life and every step writes into them in place."""
    cache = torch.zeros(
        (spec.num_kv_heads, spec.num_layers * spec.num_slots,
         spec.row_lanes),
        dtype=torch.int8 if spec.quantized else spec.dtype, device=device)
    scale = None
    if spec.quantized:
        scale = torch.zeros((spec.num_layers * spec.num_slots,
                             spec.scale_lanes), dtype=torch.bfloat16,
                            device=device)
    return cache, scale


def quantize_kv(x: torch.Tensor, group: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-group int8 quantization along the last dim:
    x [..., hd] -> (int8 [..., hd], bf16 scales [..., hd // group]).

    As in the JAX package, the values are rounded with the f32 scale and
    the stored scale is that scale rounded to bf16 (which dequantization
    then uses). The divisions are tensor by tensor: PyTorch's CUDA
    division by a Python scalar multiplies by its reciprocal."""
    shape = x.shape
    g = x.reshape(*shape[:-1], shape[-1] // group, group).to(torch.float32)
    absmax = g.abs().amax(dim=-1)
    scale = torch.div(absmax, torch.full_like(absmax, 127.0))
    inv = torch.div(torch.ones_like(scale), torch.clamp(scale, min=1e-8))
    inv = torch.where(scale > 0, inv, torch.zeros_like(inv))
    q = torch.clamp(torch.round(g * inv[..., None]), -127, 127)
    return q.to(torch.int8).reshape(shape), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor, group: int,
                  dtype=torch.bfloat16) -> torch.Tensor:
    """Inverse of :func:`quantize_kv` (int8 x bf16 scale is exact in
    f32, then rounded to ``dtype``)."""
    shape = q.shape
    g = q.reshape(*shape[:-1], shape[-1] // group, group).to(torch.float32)
    out = g * scale.to(torch.float32)[..., None]
    return out.reshape(shape).to(dtype)


def pack_scale_rows(sk: torch.Tensor, sv: torch.Tensor,
                    spec: CacheSpec) -> torch.Tensor:
    """k/v group scales [..., KVH, G] -> packed rows [..., scale_lanes]
    in lane order (head, k|v, group), zero-padded."""
    lead = sk.shape[:-2]
    packed = torch.stack([sk, sv], dim=-2).reshape(
        *lead, spec.num_kv_heads * spec.scale_lane_stride)
    pad = spec.scale_lanes - packed.shape[-1]
    if pad:
        packed = torch.nn.functional.pad(packed, (0, pad))
    return packed


def token_slots(page_table: torch.Tensor, positions: torch.Tensor,
                rows: torch.Tensor, page_size: int) -> torch.Tensor:
    """Flat cache slots for tokens at ``positions`` of batch ``rows``.

    page_table: i32[B, PMAX]; positions/rows: i32[T] -> slots i32[T].
    A position beyond the table reads its last column, as JAX's clamping
    gather does; the step routes such (padding) tokens to the trash page.
    """
    page_idx = torch.div(positions, page_size, rounding_mode="floor")
    offset = positions - page_idx * page_size
    page_idx = page_idx.clamp(0, page_table.shape[1] - 1)
    pages = page_table[rows.long(), page_idx.long()]
    return pages * page_size + offset


def pack_kv_rows(k: torch.Tensor, v: torch.Tensor,
                 spec: CacheSpec) -> torch.Tensor:
    """[..., KVH, hd] k and v -> packed rows [..., KVH, 2*shd] = [k | v],
    each half zero-padded to ``shd`` lanes."""
    pad = spec.shd - k.shape[-1]
    if pad:
        k = torch.nn.functional.pad(k, (0, pad))
        v = torch.nn.functional.pad(v, (0, pad))
    return torch.cat([k, v], dim=-1)


def append_kv_rows_block(cache: torch.Tensor,
                         scale: Optional[torch.Tensor], rows: torch.Tensor,
                         srows: Optional[torch.Tensor], slots: torch.Tensor,
                         spec: CacheSpec
                         ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Write ALL layers' pre-packed new-KV rows into ``cache`` (and their
    scale rows into ``scale``) in place.

    rows: [L, T, KVH, 2*shd] in the cache dtype (int8 when quantized);
    srows: [L, T, scale_lanes] bf16 scale rows, None when unquantized;
    slots: i32[T]. Row (h, l, t) lands at cache row
    ``h * L*S + l*S + slots[t]``, its scale row at ``l*S + slots[t]``.
    Returns ``(cache, scale)`` (the same storage) for symmetry with the
    JAX function. Duplicate slots (trash-page padding) take one of the
    written values, as XLA's scatter does; nothing ever reads the trash
    page.
    """
    kvh, _, lanes = cache.shape
    n_layers = spec.num_layers
    lslots = (torch.arange(n_layers, dtype=torch.int64,
                           device=slots.device)[:, None] * spec.num_slots
              + slots.long()[None, :])                        # [L, T]
    # rows [L, T, KVH, lanes] seen as [KVH, L*T, lanes]: a view of a
    # contiguous rows tensor (no copy of the step's largest buffer)
    cache.index_copy_(1, lslots.reshape(-1),
                      rows.permute(2, 0, 1, 3).reshape(kvh, -1, lanes)
                      .to(cache.dtype))
    if spec.quantized:
        scale.index_copy_(0, lslots.reshape(-1),
                          srows.reshape(-1, spec.scale_lanes))
    return cache, scale


def gather_pages(cache: torch.Tensor, scale: Optional[torch.Tensor],
                 page_table: torch.Tensor, spec: CacheSpec, dtype,
                 layer: int = 0):
    """Densify rows' KV for one layer from the paged pool, dequantized
    when int8 (the plain attention path only; the kernels read pages in
    place).

    page_table: i32[B, P] -> k, v: [B, P * page_size, kv_heads, head_dim]
    """
    b, p = page_table.shape
    base = (page_table.long()[..., None] * spec.page_size
            + torch.arange(spec.page_size, device=page_table.device))
    slots = layer * spec.num_slots + base.reshape(b, p * spec.page_size)
    rows_kv = cache[:, slots]                        # [KVH, B, KV, 2*shd]
    rows_kv = rows_kv.permute(1, 2, 0, 3)
    k = rows_kv[..., :spec.head_dim]
    v = rows_kv[..., spec.shd:spec.shd + spec.head_dim]
    if not spec.quantized:
        return k.to(dtype), v.to(dtype)
    # scale rows [L*S, lanes]: gather, unpack lane order (head, k|v,
    # group) -> [B, KV, KVH, 2, G]
    srows = scale[slots][..., :spec.num_kv_heads * spec.scale_lane_stride]
    srows = srows.reshape(b, p * spec.page_size, spec.num_kv_heads, 2,
                          spec.scale_groups)
    return (dequantize_kv(k, srows[..., 0, :], spec.quant_group, dtype),
            dequantize_kv(v, srows[..., 1, :], spec.quant_group, dtype))
