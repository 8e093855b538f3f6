"""Attention over the paged KV cache: the plain PyTorch versions.

These mirror ``serving_tpu/ops/attention.py``'s ``decode_attention_ref``
and ``prefill_attention_ref`` line for line (gather the pages densely,
mask, softmax). They are what the CPU runs, and what ``chip_smoke.py``
holds the CUDA kernels of :mod:`.kernels.paged_attention` against on the
card.

Contracts (per layer):

- decode: one new query token per row, attends to cache[0:context_len).
  Deferred-append mode (``fresh_k/v`` given): the cache holds
  ``context_len - 1`` tokens and the current token's K/V enters as an
  explicit self-term. Block-tail mode (``tail_kv`` given) puts the
  block's earlier tokens between the cache and the self-term.
- prefill: ``new_len`` new query tokens per row starting at absolute
  position ``start``; causal within the new tokens, full visibility of
  the cached prefix. Deferred mode (``fresh_k/v`` given): positions
  ``>= start`` read the fresh tensors instead of the cache.

With int8 KV, ``scale`` holds the cache's bf16 group-scale rows and the
pages are dequantized as they are gathered; without, it is None. The
decode self-term is the current token's unquantized k/v; the prefill
caller passes this step's k/v already round-tripped through int8, as the
kernel reads them (the JAX package's ``models/llama.py`` does the same).

ALiBi (``alibi`` = f32 slopes ``[q_heads]``) takes the JAX package's
shift-invariant form: ``slope_h * k_pos`` is added to each score after
the ``1/sqrt(hd)`` scale and before the mask, where the canonical
``-slope_h * (q_pos - k_pos)`` differs from it by a per-query constant
that the softmax drops.
"""

from __future__ import annotations

import math
from typing import Optional

import torch

from .kv_cache import CacheSpec, dequantize_kv, gather_pages

_NEG_INF = -1e30


def alibi_slopes(num_heads: int) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.), f32[num_heads]: the
    geometric sequence 2^(-8h/n) for a power-of-two head count; otherwise
    the closest power's slopes followed by the odd terms of the next
    power's (the published recipe, as HF/Baichuan build it)."""
    def pow2_slopes(n):
        start = 2.0 ** (-(2.0 ** -(math.log2(n) - 3)))
        return [start * (start ** i) for i in range(n)]

    if math.log2(num_heads).is_integer():
        s = pow2_slopes(num_heads)
    else:
        closest = 2 ** int(math.floor(math.log2(num_heads)))
        s = pow2_slopes(closest) + pow2_slopes(2 * closest)[0::2][
            :num_heads - closest]
    return torch.tensor(s, dtype=torch.float32)


def _gqa_expand(x: torch.Tensor, num_q_heads: int) -> torch.Tensor:
    """[..., kv_heads, d] -> [..., q_heads, d] by group repetition."""
    kv_heads = x.shape[-2]
    if kv_heads == num_q_heads:
        return x
    return torch.repeat_interleave(x, num_q_heads // kv_heads, dim=-2)


def decode_attention_ref(
    q: torch.Tensor,                 # [B, q_heads, head_dim]
    cache: torch.Tensor,             # [kv_heads, L*num_slots, 2*shd]
    scale: Optional[torch.Tensor],   # [L*num_slots, scale_lanes] if int8
    page_table: torch.Tensor,        # i32[B, P]
    context_len: torch.Tensor,       # i32[B] kv length incl. this token
    spec: CacheSpec,
    layer: int = 0,
    fresh_k: Optional[torch.Tensor] = None,  # [B, kv_heads, hd]
    fresh_v: Optional[torch.Tensor] = None,
    tail_kv: Optional[torch.Tensor] = None,     # [L, B, KVH, J, 2*shd]
    tail_scale: Optional[torch.Tensor] = None,  # [L, B, J, lanes] if int8
    tail_len: Optional[torch.Tensor] = None,    # i32[1]
    alibi: Optional[torch.Tensor] = None,       # f32[q_heads] slopes
) -> torch.Tensor:                   # [B, q_heads, head_dim]
    """Block-tail mode (``tail_kv`` given, deferred mode only): the cache
    is ``tail_len`` further tokens behind; the block's own earlier tokens
    are rows ``j < tail_len`` of ``tail_kv[layer]`` (packed like cache
    rows, with their scale rows under int8 KV) and join before the
    self-term. Rows with ``context_len == 0`` then give zeros, as the
    kernel's tail phase does.

    ALiBi key positions (the Pallas kernel's): gathered cache column
    ``j`` sits at ``j``, tail row ``j`` at ``cached + j`` with ``cached
    = max(context_len - 1 - tail_len, 0)``, the self-term at ``cached +
    tail_len``."""
    b, num_q_heads, head_dim = q.shape
    k, v = gather_pages(cache, scale, page_table, spec, q.dtype, layer)
    dev = q.device
    kc = torch.arange(k.shape[1], device=dev)[None, :]        # cache columns
    if fresh_k is None:
        mask = kc < context_len[:, None]
        k_pos = kc.expand(b, -1)
    else:
        cached_len = context_len - 1
        ks, vs = [k], [v]
        if tail_kv is not None:
            cached_len = torch.clamp(cached_len - tail_len, min=0)
            tk, tv = _tail_rows(tail_kv[layer], None if tail_scale is None
                                else tail_scale[layer], spec, q.dtype)
            ks.append(tk)
            vs.append(tv)
        mask = [kc < cached_len[:, None]]
        k_pos = [kc.expand(b, -1)]
        self_pos = torch.clamp(cached_len, min=0)
        if tail_kv is not None:
            jt = tail_kv.shape[3]
            ji = torch.arange(jt, device=dev)[None, :]
            mask.append((ji < tail_len).expand(b, jt))
            k_pos.append(cached_len[:, None] + ji)
            self_pos = cached_len + tail_len
        mask.append(torch.ones((b, 1), dtype=torch.bool, device=dev))
        k_pos.append(self_pos[:, None])
        mask = torch.cat(mask, dim=1)                         # [B, KV]
        k_pos = torch.cat(k_pos, dim=1)                       # [B, KV]
        k = torch.cat(ks + [fresh_k.to(q.dtype)[:, None]], dim=1)
        v = torch.cat(vs + [fresh_v.to(q.dtype)[:, None]], dim=1)
    k = _gqa_expand(k, num_q_heads)
    v = _gqa_expand(v, num_q_heads)
    scores = torch.einsum("bhd,bkhd->bhk", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if alibi is not None:
        scores = scores + (alibi.float()[None, :, None]
                           * k_pos.float()[:, None, :])
    scores = torch.where(mask[:, None, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhk,bkhd->bhd", probs.to(v.dtype).float(),
                       v.float()).to(q.dtype)
    if tail_kv is not None:
        out = torch.where((context_len > 0)[:, None, None], out,
                          torch.zeros((), dtype=out.dtype, device=dev))
    return out


def _tail_rows(rows: torch.Tensor, srows: Optional[torch.Tensor],
               spec: CacheSpec, dtype):
    """One layer's side-buffer rows [B, KVH, J, 2*shd] (and scale rows
    [B, J, lanes] under int8 KV) -> k, v [B, J, KVH, hd] in ``dtype``."""
    rows = rows.permute(0, 2, 1, 3)
    k = rows[..., :spec.head_dim]
    v = rows[..., spec.shd:spec.shd + spec.head_dim]
    if not spec.quantized:
        return k.to(dtype), v.to(dtype)
    b, jt = srows.shape[:2]
    s = srows[..., :spec.num_kv_heads * spec.scale_lane_stride].reshape(
        b, jt, spec.num_kv_heads, 2, spec.scale_groups)
    return (dequantize_kv(k, s[..., 0, :], spec.quant_group, dtype),
            dequantize_kv(v, s[..., 1, :], spec.quant_group, dtype))


def prefill_attention_ref(
    q: torch.Tensor,                 # [Bp, Qp, q_heads, head_dim]
    cache: torch.Tensor,             # [kv_heads, L*num_slots, 2*shd]
    scale: Optional[torch.Tensor],   # [L*num_slots, scale_lanes] if int8
    page_table: torch.Tensor,        # i32[Bp, P]
    start: torch.Tensor,             # i32[Bp] abs pos of first new token
    new_len: torch.Tensor,           # i32[Bp] valid new tokens per row
    spec: CacheSpec,
    layer: int = 0,
    fresh_k: Optional[torch.Tensor] = None,  # [Bp, Qp, kv_heads, hd]
    fresh_v: Optional[torch.Tensor] = None,
    alibi: Optional[torch.Tensor] = None,    # f32[q_heads] slopes
) -> torch.Tensor:                   # [Bp, Qp, q_heads, head_dim]
    bp, qp, num_q_heads, head_dim = q.shape
    k, v = gather_pages(cache, scale, page_table, spec, q.dtype, layer)
    dev = q.device
    if fresh_k is not None:
        kv_len_g = k.shape[1]
        pos = torch.arange(kv_len_g, device=dev)[None, :]          # [1, KV]
        fidx = (pos - start.long()[:, None]).clamp(0, qp - 1)       # [Bp, KV]
        is_fresh = pos >= start[:, None]
        gidx = fidx[..., None, None].expand(-1, -1, *fresh_k.shape[2:])
        fk = torch.gather(fresh_k.to(q.dtype), 1, gidx)
        fv = torch.gather(fresh_v.to(q.dtype), 1, gidx)
        k = torch.where(is_fresh[..., None, None], fk, k)
        v = torch.where(is_fresh[..., None, None], fv, v)
    k = _gqa_expand(k, num_q_heads)
    v = _gqa_expand(v, num_q_heads)
    kv_len = k.shape[1]
    scores = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float())
    scores = scores / math.sqrt(head_dim)
    if alibi is not None:
        k_pos = torch.arange(kv_len, device=dev, dtype=torch.float32)
        scores = scores + alibi.float()[:, None, None] * k_pos
    # query i sits at absolute position start + i; it sees keys
    # [0, start + i]
    q_pos = start.long()[:, None] + torch.arange(qp, device=dev)[None, :]
    k_idx = torch.arange(kv_len, device=dev)[None, None, :]
    causal = k_idx <= q_pos[:, :, None]                         # [Bp, Qp, KV]
    valid_q = torch.arange(qp, device=dev)[None, :] < new_len[:, None]
    mask = causal & valid_q[:, :, None]
    scores = torch.where(mask[:, None, :, :], scores, _NEG_INF)
    probs = torch.softmax(scores, dim=-1)
    # fully-masked (padding) query rows: output zeros, not NaN
    probs = torch.where(valid_q[:, None, :, None], probs, 0.0)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype).float(),
                       v.float())
    return out.to(q.dtype)
