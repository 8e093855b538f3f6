"""LLaMA-family decoder as one serving step (PyTorch).

The port of ``serving_tpu/models/llama.py``'s ``make_step_fn``: one
call processes a mixed continuous batch

    flat tokens = [ Bd decode tokens | Bp x Qp padded prefill tokens ]

- dense matmuls run on the flat [T, D] layout; with ``online_i8i8``
  they are the K3 kernel, with ``online_w4a8`` the K4 kernel
  (:mod:`..ops.kernels.quant_matmul`),
- attention splits into decode rows (K1, the current token as a
  self-term) and prefill rows (K2, this step's K/V read from the packed
  fresh slab), both reading the paged cache in place,
- with int8 KV each layer's new K/V is quantized once into int8 rows and
  bf16 scale rows; the prefill rows' slice of them is K2's fresh slab,
  and the decode self-term stays unquantized,
- after the last layer ONE in-place write lands every layer's new K/V
  (and scale rows) in the cache, then final norm, lm_head, penalties and
  sampling.

The model families of the JAX package's one llama-family graph: RoPE
(LLaMA, InternLM) or ALiBi (``position_encoding="alibi"``, Baichuan-13B:
no RoPE, the slopes go to K1 and K2), and optional qkv/o projection
biases (``attn_bias``, InternLM-7B: ``bqkv`` [KVH, G+2, hd] added after
the qkv matmul, ``bo`` [D] after wo, both in the compute dtype).

:func:`make_multi_step_fn` chains N decode steps into one block, each
step's sampled tokens feeding the next on the device, as the JAX
package's decode blocks do; in block-tail mode the block writes the cache
once at its end and K1 reads the block's own rows from a side buffer.

The weights keep the JAX package's fused layouts, so its parameters
convert one to one (:func:`params_from_jax`):

    wqkv:      [D, KVH, G+2, hd]  (per kv head: G q columns, k, v)
    w_gate_up: [D, 2, I]          (quantized: C-leading [2, D, I];
                                   w4a8: packed [2, D/2, I], scales
                                   [2, D/64, I])

The step and the block run eagerly on preallocated cache, scale-row and
count-map tensors, which they update in place, with no host
synchronisation, so the engine can capture a block as a CUDA graph.
"""

from __future__ import annotations

from typing import Any, Dict, NamedTuple, Optional

import numpy as np
import torch

from ..config import ModelConfig
from ..ops import attention as attn_ops
from ..ops import kv_cache as kv_ops
from ..ops import quant as quant_ops
from ..ops import sampling as sampling_ops
from ..ops.kernels import paged_attention as attn_kernels
from ..ops.kernels import quant_matmul as qmm_kernels
from ..ops.kv_cache import CacheSpec

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def torch_dtype(name: str) -> torch.dtype:
    return _DTYPES[name]


class StepInput(NamedTuple):
    """Device inputs for one continuous-batching step.

    Rows 0..Bd-1 are decode rows (one new token each); rows Bd..Bd+Bp-1
    are prefill rows (up to Qp new tokens each). Padding rows have
    context_len == 0 and trash-page page-table entries.
    """

    decode_tokens: torch.Tensor    # i32[Bd]
    decode_pos: torch.Tensor       # i32[Bd]
    prefill_tokens: torch.Tensor   # i32[Bp, Qp]
    prefill_start: torch.Tensor    # i32[Bp]
    prefill_len: torch.Tensor      # i32[Bp]
    page_table: torch.Tensor       # i32[Bd+Bp, KVP]
    context_len: torch.Tensor      # i32[Bd+Bp] kv length after this step
    batch_slots: torch.Tensor      # i32[Bd+Bp] persistent penalty slots
    sampling: sampling_ops.SamplingParams


class StepOutput(NamedTuple):
    tokens: torch.Tensor     # i32[B]
    logprobs: torch.Tensor   # f32[B]
    logits: Optional[torch.Tensor] = None  # [B, V]; tests only


def init_params(cfg: ModelConfig, generator: torch.Generator,
                dtype=torch.bfloat16, device="cpu", quantize: str = "none",
                quantize_lm_head: bool = False) -> Dict[str, Any]:
    """Random weights at the model's widths, drawn from ``generator`` on
    ``device`` (tests and benchmarks; the scales follow the JAX
    package's ``init_params``).

    With ``quantize`` (``online_i8i8`` / ``online_w4a8``) each layer is
    quantized as soon as it is drawn (:func:`build_params`), and the
    lm_head too when ``quantize_lm_head``. The draws are the same, in the
    same order, so the result equals ``quantize_model_params(
    init_params(...), quantize, quantize_lm_head)`` byte for byte."""
    d, hd = cfg.hidden_dim, cfg.head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    g = n_q // n_kv

    def w(shape, scale):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return (x * scale).to(dtype)

    def ones():
        return torch.ones((d,), dtype=dtype, device=device)

    s = d ** -0.5

    def layer(_):
        lp = {
            "attn_norm": ones(),
            "ffn_norm": ones(),
            "wqkv": w((d, n_kv, g + 2, hd), s),
            "wo": w((n_q * hd, d), (n_q * hd) ** -0.5),
            "w_gate_up": w((d, 2, cfg.intermediate_dim), s),
            "w_down": w((cfg.intermediate_dim, d),
                        cfg.intermediate_dim ** -0.5),
        }
        if cfg.attn_bias:
            lp["bqkv"] = w((n_kv, g + 2, hd), 0.02)
            lp["bo"] = w((d,), 0.02)
        return lp

    return build_params(cfg, w((cfg.vocab_size, d), 1.0), layer, ones,
                        lambda: w((d, cfg.vocab_size), s), dtype=dtype,
                        device=device, quantize=quantize,
                        quantize_lm_head=quantize_lm_head)


def build_params(cfg: ModelConfig, embedding: torch.Tensor, make_layer,
                 make_final_norm, make_lm_head, dtype=torch.bfloat16,
                 device="cpu", quantize: str = "none",
                 quantize_lm_head: bool = False) -> Dict[str, Any]:
    """Assemble a model's parameters one layer at a time: ``make_layer(i)``
    returns layer i's float weights, ``make_final_norm()`` the final norm
    and ``make_lm_head()`` the float lm_head ``[D, V]``, each called once,
    in that order, after the embedding was made.

    With ``quantize`` (``online_i8i8`` / ``online_w4a8``) each layer is
    quantized (:func:`quantize_layer_params`) as soon as it is made and
    its float weights dropped before the next is made, and the lm_head
    too when ``quantize_lm_head``: no more than one float layer is alive
    at a time. The result equals quantizing every layer afterwards
    (:func:`quantize_model_params`) byte for byte. On cuda each layer's
    quantized tensors are allocated before its float weights are made,
    right after the allocator's cache is emptied, so no temporary shares
    their memory segments and every temporary's segment can be given
    back."""
    d, hd = cfg.hidden_dim, cfg.head_dim
    n_q, n_kv = cfg.num_heads, cfg.num_kv_heads
    g = n_q // n_kv
    quantize = None if quantize == "none" else quantize
    cuda = torch.device(device).type == "cuda"
    shapes = {"wqkv": (d, n_kv, g + 2, hd), "wo": (n_q * hd, d),
              "w_gate_up": (d, 2, cfg.intermediate_dim),
              "w_down": (cfg.intermediate_dim, d),
              "lm_head": (d, cfg.vocab_size)}

    def empty_quantized(quantizer, names):
        """Empty tensors shaped and typed as ``quantizer``'s output for
        the weights ``names`` (worked out on the meta device)."""
        if cuda:
            torch.cuda.empty_cache()
        meta = quantizer({k: torch.empty(shapes[k], dtype=dtype,
                                         device="meta") for k in names})
        return {k: torch.empty(v.shape, dtype=v.dtype, device=device)
                for k, v in meta.items()}

    params = {"embedding": embedding, "layers": []}
    for i in range(cfg.num_layers):
        if quantize is not None:
            out = empty_quantized(
                lambda lp: quantize_layer_params(lp, quantize), _MATMULS)
        layer = make_layer(i)
        if quantize is not None:
            layer = quantize_layer_params(layer, quantize)
            for k, v in out.items():
                layer[k] = v.copy_(layer[k])
        params["layers"].append(layer)
    params["final_norm"] = make_final_norm()
    if quantize is not None and quantize_lm_head:
        out = empty_quantized(
            lambda lp: _quantize_lm_head(lp["lm_head"], quantize),
            ("lm_head",))
        q = _quantize_lm_head(make_lm_head(), quantize)
        params.update({k: v.copy_(q[k]) for k, v in out.items()})
    else:
        if cuda:
            torch.cuda.empty_cache()
        params["lm_head"] = make_lm_head()
    return params


def _to_torch(a, device, float_dtype) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        t = torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(a.copy())
    if t.is_floating_point():
        t = t.to(float_dtype)
    return t.to(device)


def params_from_jax(np_params: Dict[str, Any], device,
                    dtype=torch.float32) -> Dict[str, Any]:
    """The JAX package's parameter pytree (leaves as numpy arrays) ->
    the port's parameters. Float weights become ``dtype``; quantized
    ``*_q`` (int8, or packed int4 in int8 bytes) are carried across
    unchanged and their ``*_s`` scales stay float32."""
    def conv(name, a):
        if name.endswith("_s"):
            return _to_torch(a, device, torch.float32)
        return _to_torch(a, device, dtype)

    out = {k: conv(k, v) for k, v in np_params.items() if k != "layers"}
    out["layers"] = [{k: conv(k, v) for k, v in lp.items()}
                     for lp in np_params["layers"]]
    return out


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = (x32 * x32).mean(dim=-1, keepdim=True)
    return (x32 * torch.rsqrt(var + eps)).to(x.dtype) * weight


def apply_rope(x: torch.Tensor, pos: torch.Tensor,
               theta: float) -> torch.Tensor:
    """HF rotate-half RoPE. x: [T, heads, head_dim], pos: i32[T]."""
    half = x.shape[-1] // 2
    inv_freq = 1.0 / (theta ** (torch.arange(
        0, half, dtype=torch.float32, device=x.device) / half))
    angles = pos.to(torch.float32)[:, None] * inv_freq[None, :]
    cos = torch.cos(angles)[:, None, :]
    sin = torch.sin(angles)[:, None, :]
    x32 = x.to(torch.float32)
    x1, x2 = x32[..., :half], x32[..., half:]
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


_QUANTIZERS = {
    "online_i8i8": lambda w: quant_ops.quantize_weight(w, contract_axis=0),
    "online_w4a8": quant_ops.quantize_weight_int4,
}
_MATMULS = ("wqkv", "wo", "w_gate_up", "w_down")


def quantize_layer_params(lp: Dict[str, Any],
                          method: str = "online_i8i8") -> Dict[str, Any]:
    """One layer's matmul weights as (<name>_q, <name>_s): int8 with f32
    per-output-channel scales (``online_i8i8``), or packed int4 with f32
    group-64 scales (``online_w4a8``). The fused gate|up goes C-leading:
    [2, D, I] (int4: packed [2, D/2, I] and scales [2, G, I]). Norms and
    biases are kept as they are; ``lp`` is not changed."""
    quantize = _QUANTIZERS[method]
    nl = {k: v for k, v in lp.items() if k not in _MATMULS}
    for name in _MATMULS:
        q, s = quantize(lp[name])
        if q.ndim == 3:
            q = q.permute(1, 0, 2)
            if s.ndim == 3:
                s = s.permute(1, 0, 2)
        nl[name + "_q"] = q.contiguous()
        nl[name + "_s"] = s.contiguous()
    return nl


def _quantize_lm_head(lm_head: torch.Tensor, method: str) -> Dict[str, Any]:
    q, s = _QUANTIZERS[method](lm_head)
    return {"lm_head_q": q.contiguous(), "lm_head_s": s.contiguous()}


def quantize_model_params(params: Dict[str, Any],
                          method: str = "online_i8i8",
                          quantize_lm_head: bool = False) -> Dict[str, Any]:
    """Every layer through :func:`quantize_layer_params`, and the lm_head
    too when ``quantize_lm_head``; the embedding and norms stay float.
    Returns new params; the caller's float ones stay alive as long as the
    caller holds them, so building this way holds every float layer
    beside its quantized copy. To hold one float layer at a time, draw
    the weights quantized (``init_params(..., quantize=method)``)."""
    out = dict(params)
    out["layers"] = [quantize_layer_params(lp, method)
                     for lp in params["layers"]]
    if quantize_lm_head:
        del out["lm_head"]
        out.update(_quantize_lm_head(params["lm_head"], method))
    return out


def _make_matmul(quant_method: str):
    """The transformer matmul of ``quant_method``: ``matmul(h, p, name,
    out_dtype)`` of h [T, D] with the weight ``name`` (plain contract
    [D, ...out] -> [T, ...out]; fused [C, D, N] -> [C, T, N])."""
    kernel = {"online_i8i8": qmm_kernels.i8i8_matmul,
              "online_w4a8": qmm_kernels.w4a8_matmul}.get(quant_method)
    if kernel is not None:
        def matmul(h, p, name, out_dtype):
            return kernel(h, p[name + "_q"], p[name + "_s"],
                          out_dtype=out_dtype)
        return matmul

    def matmul(h, p, name, out_dtype):
        w = p[name]
        out = torch.matmul(h, w.reshape(w.shape[0], -1))
        return out.reshape((h.shape[0],) + tuple(w.shape[1:])).to(out_dtype)
    return matmul


def _gate_up_act(matmul, h: torch.Tensor, p: Dict[str, Any],
                 out_dtype: torch.dtype) -> torch.Tensor:
    """silu(gate) * up from the fused gate|up weight."""
    if "w_gate_up_q" in p:
        gu = matmul(h, p, "w_gate_up", out_dtype)         # [2, T, I]
        return torch.nn.functional.silu(gu[0]) * gu[1]
    w = p["w_gate_up"]                                    # [D, 2, I]
    gu = torch.matmul(h, w.reshape(w.shape[0], -1)).to(torch.float32)
    gu = gu.reshape(h.shape[0], 2, -1)
    return torch.nn.functional.silu(gu[:, 0]) * gu[:, 1]


def pack_new_kv(k: torch.Tensor, v: torch.Tensor, spec: CacheSpec):
    """A layer's new K/V as packed rows in the cache dtype [T, KVH, 2*shd]
    and, with int8 KV, their scale rows [T, scale_lanes] (else None): the
    bytes a cache write lands."""
    if not spec.quantized:
        return kv_ops.pack_kv_rows(k.to(spec.dtype), v.to(spec.dtype),
                                   spec), None
    qk, sk = kv_ops.quantize_kv(k, spec.quant_group)
    qv, sv = kv_ops.quantize_kv(v, spec.quant_group)
    return (kv_ops.pack_kv_rows(qk, qv, spec),
            kv_ops.pack_scale_rows(sk, sv, spec))


def _layer_halves(cfg: ModelConfig, quant_method: str):
    """The two halves of a decoder layer around its attention, for the
    step and the NLL forward: ``before(p, x, pos) -> (q [T, Hq, hd],
    k [T, KVH, hd], v)`` (norm, qkv matmul, bias, RoPE) and ``after(p, x,
    attn [T, Hq*hd]) -> x`` (wo, bias, residual, norm, gate|up, down,
    residual)."""
    n_q, n_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    g = n_q // n_kv
    eps, theta = cfg.norm_eps, cfg.rope_theta
    compute_dtype = torch_dtype(cfg.dtype)
    matmul = _make_matmul(quant_method)
    use_alibi = cfg.position_encoding == "alibi"
    attn_bias = cfg.attn_bias

    def before(p, x, pos):
        h = rms_norm(x, p["attn_norm"], eps)
        t = x.shape[0]
        qkv = matmul(h, p, "wqkv", compute_dtype)    # [T, KVH, G+2, hd]
        if attn_bias:
            qkv = qkv + p["bqkv"].to(compute_dtype)
        q = qkv[:, :, :g, :].reshape(t, n_q, hd)
        k = qkv[:, :, g, :]
        v = qkv[:, :, g + 1, :]
        if not use_alibi:
            q = apply_rope(q, pos, theta)
            k = apply_rope(k, pos, theta)
        return q, k, v

    def after(p, x, attn):
        o = matmul(attn, p, "wo", compute_dtype)
        if attn_bias:
            o = o + p["bo"].to(o.dtype)
        x = x + o.to(compute_dtype)
        h = rms_norm(x, p["ffn_norm"], eps)
        act = _gate_up_act(matmul, h, p, compute_dtype)
        down = matmul(act.to(compute_dtype).contiguous(), p, "w_down",
                      compute_dtype)
        return x + down.to(compute_dtype)

    return before, after


def _lm_head(params, x: torch.Tensor, matmul) -> torch.Tensor:
    """f32 logits of the hidden rows ``x``; the quantized lm_head when the
    parameters hold one (``lm_head_q``)."""
    if "lm_head_q" in params:
        return matmul(x, params, "lm_head", torch.float32)
    return torch.matmul(x, params["lm_head"]).to(torch.float32)


def make_step_fn(cfg: ModelConfig, spec: CacheSpec,
                 enable_penalty: bool = False,
                 return_logits: bool = False,
                 quant_method: str = "none",
                 top_k_cap: int = 0,
                 greedy_only: bool = False):
    """Build the fused forward+sample step for one model configuration.

    ``step(params, kv_cache, kv_scale, count_map, inp, gumbel)`` writes
    this step's K/V into ``kv_cache`` (and, with int8 KV, their scale rows
    into ``kv_scale``; None otherwise) and, with penalties on, its tokens
    into ``count_map``, all in place, and returns a :class:`StepOutput`.
    ``gumbel`` is the [B, C] noise of the sampled rows (C = top_k_cap, or
    the vocab when uncapped); None when ``greedy_only``.

    ``tail=(tail_kv [L,B,KVH,J,2*shd], tail_scale [L,B,J,lanes] | None,
    tail_len i32[1])``: block-tail mode (decode rows only): the cache is
    ``tail_len`` tokens behind and the block's own K/V comes from the side
    buffer. ``defer_scatter``: skip the cache write and return ``(out,
    rows_l [L,T,KVH,2*shd], srows_l [L,T,lanes] | None, slots i32[T])``
    so that the block lands one write for all its steps.

    The matmuls follow ``quant_method`` ("none", "online_i8i8",
    "online_w4a8"), as the JAX step's do; whether lm_head is quantized
    follows the parameters (an ``lm_head_q`` key).
    """
    n_q, n_kv, hd = cfg.num_heads, cfg.num_kv_heads, cfg.head_dim
    eps = cfg.norm_eps
    compute_dtype = torch_dtype(cfg.dtype)
    matmul = _make_matmul(quant_method)
    before, after = _layer_halves(cfg, quant_method)
    use_alibi = cfg.position_encoding == "alibi"
    # ALiBi slopes, moved to a device at the step's first visit there,
    # which is eager: a host-to-device copy inside a CUDA graph capture
    # would fail it
    slopes_host = attn_ops.alibi_slopes(n_q) if use_alibi else None
    slopes_on: Dict[torch.device, torch.Tensor] = {}

    def slopes_for(dev: torch.device) -> Optional[torch.Tensor]:
        if slopes_host is None:
            return None
        if dev not in slopes_on:
            slopes_on[dev] = slopes_host.to(dev)
        return slopes_on[dev]

    def step(params, kv_cache: torch.Tensor,
             kv_scale: Optional[torch.Tensor], count_map: torch.Tensor,
             inp: StepInput, gumbel: Optional[torch.Tensor] = None,
             tail=None, defer_scatter: bool = False):
        dev = kv_cache.device
        bd = inp.decode_tokens.shape[0]
        bp, qp = inp.prefill_tokens.shape
        assert tail is None or bp == 0, "block-tail steps are decode-only"
        i32 = dict(dtype=torch.int32, device=dev)
        tail_kw = ({} if tail is None else
                   dict(tail_kv=tail[0], tail_scale=tail[1],
                        tail_len=tail[2]))
        alibi = slopes_for(dev)

        # ---- flat token metadata ------------------------------------------
        prefill_pos = (inp.prefill_start[:, None]
                       + torch.arange(qp, **i32)[None, :])
        flat_pos = torch.cat([inp.decode_pos, prefill_pos.reshape(-1)])
        flat_rows = torch.cat([
            torch.arange(bd, **i32),
            bd + torch.arange(bp, **i32)[:, None].expand(bp, qp).reshape(-1),
        ])
        flat_tokens = torch.cat([inp.decode_tokens,
                                 inp.prefill_tokens.reshape(-1)])
        valid_flat = torch.cat([
            torch.ones(bd, dtype=torch.bool, device=dev),
            (torch.arange(qp, **i32)[None, :]
             < inp.prefill_len[:, None]).reshape(-1),
        ])
        slots = kv_ops.token_slots(inp.page_table, flat_pos, flat_rows,
                                   spec.page_size)
        # padding tokens write to the trash page, spread over its slots
        t_flat = flat_tokens.shape[0]
        trash = (spec.trash_page * spec.page_size
                 + torch.arange(t_flat, **i32) % spec.page_size)
        slots = torch.where(valid_flat, slots, trash)

        pt_decode = inp.page_table[:bd].contiguous()
        pt_prefill = inp.page_table[bd:].contiguous()
        ctx_decode = inp.context_len[:bd].contiguous()

        # a token id past the vocabulary (a token-in request may carry
        # any uint32) reads the last row, as the JAX package's gather
        # clamps it; unclamped it would read out of bounds on the card
        x = params["embedding"][flat_tokens.long().clamp(
            max=params["embedding"].shape[0] - 1)].to(compute_dtype)

        # every layer's new K/V rows (and scale rows), held to the step's
        # one cache write in a buffer of their own: the step's largest
        # allocation at prefill sizes, so no second copy of it is made
        n_layers = len(params["layers"])
        rows_l = torch.empty((n_layers, t_flat, n_kv, spec.row_lanes),
                             dtype=kv_cache.dtype, device=dev)
        srows_l = (torch.empty((n_layers, t_flat, spec.scale_lanes),
                               dtype=torch.bfloat16, device=dev)
                   if spec.quantized else None)
        for li, p in enumerate(params["layers"]):
            q, k, v = before(p, x, flat_pos)
            rows, srows = pack_new_kv(k, v, spec)
            rows_l[li] = rows
            if srows is not None:
                srows_l[li] = srows
            if bd:
                attn_d = attn_kernels.paged_decode_attention(
                    q[:bd].contiguous(), kv_cache, kv_scale, pt_decode,
                    ctx_decode, spec, layer=li, fresh_k=k[:bd].contiguous(),
                    fresh_v=v[:bd].contiguous(), alibi=alibi, **tail_kw)
            else:
                attn_d = q.new_zeros((0, n_q, hd))
            if bp:
                # the deferred-prefill input is a slice of the same packed
                # rows the end-of-step write lands
                fslab = rows[bd:].reshape(bp, qp, n_kv, -1).permute(
                    0, 2, 1, 3).contiguous()
                fscale = (srows[bd:].reshape(bp, qp, -1)
                          if spec.quantized else None)
                attn_p = attn_kernels.paged_prefill_attention(
                    q[bd:].reshape(bp, qp, n_q, hd).contiguous(), kv_cache,
                    kv_scale, pt_prefill, inp.prefill_start,
                    inp.prefill_len, spec, layer=li, fresh_kv=fslab,
                    fresh_scale=fscale, alibi=alibi)
            else:
                attn_p = q.new_zeros((0, qp, n_q, hd))
            x = after(p, x, torch.cat([attn_d.reshape(bd, n_q * hd),
                                       attn_p.reshape(bp * qp, n_q * hd)]))

        if not defer_scatter:
            kv_ops.append_kv_rows_block(kv_cache, kv_scale, rows_l, srows_l,
                                        slots, spec)

        x = rms_norm(x, params["final_norm"], eps)
        last_idx = torch.cat([
            torch.arange(bd, **i32),
            bd + torch.arange(bp, **i32) * qp
            + torch.clamp(inp.prefill_len - 1, min=0),
        ])
        logits = _lm_head(params, x[last_idx.long()].contiguous(), matmul)

        if enable_penalty:
            # padding rows carry the trash batch slot: no masking needed
            sampling_ops.update_count_map(
                count_map, flat_tokens, inp.batch_slots[flat_rows.long()])
            logits = sampling_ops.apply_penalties(
                logits, count_map, inp.batch_slots, inp.sampling)

        tokens, logprobs = sampling_ops.sample_top_k_top_p(
            logits, inp.sampling, gumbel, top_k_cap=top_k_cap,
            greedy_only=greedy_only)
        out = StepOutput(tokens, logprobs, logits if return_logits else None)
        if defer_scatter:
            return out, rows_l, srows_l, slots
        return out

    return step


def make_nll_fn(cfg: ModelConfig, spec: CacheSpec,
                quant_method: str = "none", return_logprobs: bool = False):
    """Teacher-forced token NLLs for perplexity evaluation (the JAX
    package's ``make_nll_fn``).

    ``nll(params, kv_cache, kv_scale, tokens i32[L], n_valid, page_table
    i32[1, P]) -> (nll f32[L-1], mask bool[L-1])``, and with
    ``return_logprobs`` also the [L-1, V] f32 log-softmax: the serving
    step's layers over one prefill row of the whole (padded) sequence at
    start 0, with logits at every position. The matmuls follow
    ``quant_method`` (K3 or K4 at T = L); attention is K2 with Qp = L.

    Each layer's K/V rows are written into the cache (positions past
    ``n_valid`` into the trash page) and K2 reads the chunk's keys from
    those same rows: in the cache dtype, and with int8 KV quantized, with
    their scale rows, as the JAX function reads them back from its cache.
    Eager, one call per chunk; ``kv_cache``/``kv_scale`` are scratch,
    written in place."""
    n_q, hd = cfg.num_heads, cfg.head_dim
    compute_dtype = torch_dtype(cfg.dtype)
    matmul = _make_matmul(quant_method)
    before, after = _layer_halves(cfg, quant_method)
    slopes = (attn_ops.alibi_slopes(n_q)
              if cfg.position_encoding == "alibi" else None)

    def nll(params, kv_cache, kv_scale, tokens, n_valid: int, page_table):
        dev = kv_cache.device
        i32 = dict(dtype=torch.int32, device=dev)
        length = tokens.shape[0]
        pos = torch.arange(length, **i32)
        slots = kv_ops.token_slots(page_table, pos, torch.zeros_like(pos),
                                   spec.page_size)
        slots = torch.where(pos < n_valid, slots,
                            spec.trash_page * spec.page_size).long()
        start = torch.zeros(1, **i32)
        new_len = torch.full((1,), n_valid, **i32)
        alibi = None if slopes is None else slopes.to(dev)
        x = params["embedding"][tokens.long()].to(compute_dtype)
        for li, p in enumerate(params["layers"]):
            q, k, v = before(p, x, pos)
            rows, srows = pack_new_kv(k, v, spec)
            kv_cache.index_copy_(1, li * spec.num_slots + slots,
                                 rows.permute(1, 0, 2))
            if spec.quantized:
                kv_scale.index_copy_(0, li * spec.num_slots + slots, srows)
            attn = attn_kernels.paged_prefill_attention(
                q[None].contiguous(), kv_cache, kv_scale, page_table, start,
                new_len, spec, layer=li,
                fresh_kv=rows.permute(1, 0, 2)[None].contiguous(),
                fresh_scale=None if srows is None else srows[None],
                alibi=alibi)[0]
            x = after(p, x, attn.reshape(length, n_q * hd))
        x = rms_norm(x, params["final_norm"], cfg.norm_eps)
        logprobs = torch.log_softmax(_lm_head(params, x, matmul), dim=-1)
        nll_all = -logprobs[:-1].gather(
            1, tokens[1:, None].long())[:, 0]
        mask = torch.arange(length - 1, device=dev) < (n_valid - 1)
        if return_logprobs:
            return nll_all, mask, logprobs[:-1]
        return nll_all, mask

    return nll


def make_multi_step_fn(cfg: ModelConfig, spec: CacheSpec, num_steps: int,
                       block_tail: str = "auto", **step_kwargs):
    """N decode steps as one block, the sampled tokens feeding the next
    step on the device (the JAX package's ``make_multi_step_fn``).

    ``block(params, kv_cache, kv_scale, count_map, inp, gumbel)`` takes a
    decode-only :class:`StepInput` and the [N, B, C] noise of its sampled
    rows (None when greedy) and returns (tokens i32[N, B], logprobs
    f32[N, B]). Positions and context lengths advance by one per step for
    every row, padding rows included; rows that finish mid-block keep
    writing into their own pages, which are never read again.

    ``block_tail``: "auto" and "off" write the cache after every step;
    "on" writes it once, at block end: step i >= 1 reads the block's
    earlier K/V rows from a zeroed side buffer through K1's tail phase,
    and one write lands all N steps' rows (step-major, so the padding
    rows' trash slots repeat; the write takes duplicates).
    """
    if block_tail not in ("auto", "on", "off"):
        raise ValueError(f"unknown block_tail {block_tail}")
    step = make_step_fn(cfg, spec, **step_kwargs)
    use_tail = block_tail == "on"
    n_layers, n_kv = cfg.num_layers, cfg.num_kv_heads

    def block(params, kv_cache, kv_scale, count_map, inp: StepInput,
              gumbel: Optional[torch.Tensor] = None):
        assert inp.prefill_tokens.shape[0] == 0, (
            "multi-step blocks are decode-only")
        tokens, pos, ctx = inp.decode_tokens, inp.decode_pos, inp.context_len
        b, dev = tokens.shape[0], kv_cache.device
        toks, lps = [], []
        if use_tail:
            tkv = torch.zeros((n_layers, b, n_kv, num_steps, spec.row_lanes),
                              dtype=kv_cache.dtype, device=dev)
            tsr = (torch.zeros((n_layers, b, num_steps, spec.scale_lanes),
                               dtype=torch.bfloat16, device=dev)
                   if spec.quantized else None)
            slots = []
        for i in range(num_steps):
            it = inp._replace(decode_tokens=tokens, decode_pos=pos,
                              context_len=ctx)
            g = None if gumbel is None else gumbel[i]
            if use_tail:
                tail = None if i == 0 else (
                    tkv, tsr, torch.full((1,), i, dtype=torch.int32,
                                         device=dev))
                out, rows_l, srows_l, slots_i = step(
                    params, kv_cache, kv_scale, count_map, it, g,
                    tail=tail, defer_scatter=True)
                tkv[:, :, :, i] = rows_l
                if spec.quantized:
                    tsr[:, :, i] = srows_l
                slots.append(slots_i)
            else:
                out = step(params, kv_cache, kv_scale, count_map, it, g)
            tokens = out.tokens
            pos, ctx = pos + 1, ctx + 1
            toks.append(out.tokens)
            lps.append(out.logprobs)
        if use_tail:
            rows_cat = tkv.permute(0, 3, 1, 2, 4).reshape(
                n_layers, num_steps * b, n_kv, spec.row_lanes)
            srows_cat = (tsr.permute(0, 2, 1, 3).reshape(
                n_layers, num_steps * b, spec.scale_lanes)
                if spec.quantized else None)
            kv_ops.append_kv_rows_block(kv_cache, kv_scale, rows_cat,
                                        srows_cat, torch.cat(slots), spec)
        return torch.stack(toks), torch.stack(lps)

    return block
