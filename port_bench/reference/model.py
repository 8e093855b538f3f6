"""The plain reference of the served model: the configuration's forward
pass in float32 PyTorch, one whole sequence at a time, no cache, no
batching, no kernels.

It computes what the configuration states: int8 per-channel weights and
per-token int8 activations into every matmul (``online_i8i8``), keys and
values through int8 group-8 quantization (the int8 KV cache), RMSNorm,
RoPE (LLaMA, InternLM) or ALiBi (Baichuan), the qkv and o biases where
the configuration has them, SiLU-gated FFN, and the bf16 lm_head. The
weights come from :mod:`.weights`, drawn again from the seed; the
sequences (prompts and the tokens the program served) are the only
thing it takes from the run, and only to judge them.

Every layer's weights are drawn once and applied to all the sampled
sequences before the next is drawn, so the reference holds one layer at
a time. It runs in float32 with TF32 off.
"""

from __future__ import annotations

import math
from typing import Dict, List, Sequence

import torch

from .weights import Draw, int8_kv, int8_rows, int8_weight


def rms_norm(x: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps)


def rope(x: torch.Tensor, pos: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotate-half RoPE; x [T, heads, hd], pos [T]."""
    half = x.shape[-1] // 2
    inv = 1.0 / (theta ** (torch.arange(half, dtype=torch.float32,
                                        device=x.device) / half))
    ang = pos.to(torch.float32)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def alibi_slopes(n: int) -> torch.Tensor:
    """Per-head ALiBi slopes (Press et al.; the closest power of two's,
    then the odd terms of the next power's)."""
    def pow2(k):
        start = 2.0 ** (-(2.0 ** -(math.log2(k) - 3)))
        return [start * start ** i for i in range(k)]
    if math.log2(n).is_integer():
        s = pow2(n)
    else:
        c = 2 ** int(math.floor(math.log2(n)))
        s = pow2(c) + pow2(2 * c)[0::2][:n - c]
    return torch.tensor(s, dtype=torch.float32)


def attention(q, k, v, slopes) -> torch.Tensor:
    """Causal attention of one sequence; q [L, Hq, hd], k/v [L, KVH, hd]."""
    n, hq, hd = q.shape
    rep = hq // k.shape[1]
    k = k.repeat_interleave(rep, dim=1)
    v = v.repeat_interleave(rep, dim=1)
    scores = torch.einsum("qhd,khd->hqk", q, k) / math.sqrt(hd)
    pos = torch.arange(n, device=q.device)
    if slopes is not None:
        scores = scores + slopes[:, None, None] * pos.to(torch.float32)
    scores = scores.masked_fill(pos[None, :, None] < pos[None, None, :],
                                float("-inf"))
    return torch.einsum("hqk,khd->qhd", torch.softmax(scores, dim=-1), v)


def logit_gaps(cfg: Dict, seed: int, seqs: Sequence[Dict],
               device) -> List[List[float]]:
    """For each sequence (``prompt`` and served ``tokens`` ids): at each
    served token, how far its reference logit lies below the reference's
    best logit at that position."""
    dev = torch.device(device)
    draw = Draw(cfg, seed, dev)
    d, n_q = cfg["hidden_dim"], cfg["num_heads"]
    n_kv = cfg.get("num_kv_heads", n_q)
    hd, g = d // n_q, n_q // n_kv
    eps = float(cfg.get("norm_eps", 1e-5))
    theta = float(cfg.get("rope_theta", 10000.0))
    alibi = cfg.get("position_encoding") == "alibi"
    kv_group = cfg["cache_quant_group"] if cfg["cache_quant_bit"] == 8 else 0
    slopes = alibi_slopes(n_q).to(dev) if alibi else None

    ids = [list(s["prompt"]) + list(s["tokens"][:-1]) for s in seqs]
    lens = [len(x) for x in ids]
    flat = torch.tensor([t for x in ids for t in x], dtype=torch.long,
                        device=dev)
    pos = torch.cat([torch.arange(n, device=dev) for n in lens])
    x = draw.embedding()[flat.clamp(max=cfg["vocab_size"] - 1)].float()

    def mm(a, w):
        return int8_rows(a) @ w

    for lp in draw.layers():
        wqkv = int8_weight(lp["wqkv"]).reshape(d, -1)
        h = rms_norm(x, eps)
        qkv = mm(h, wqkv).reshape(-1, n_kv, g + 2, hd)
        if "bqkv" in lp:
            qkv = qkv + lp["bqkv"].float()
        q = qkv[:, :, :g].reshape(-1, n_q, hd)
        k, v = qkv[:, :, g], qkv[:, :, g + 1]
        if not alibi:
            q, k = rope(q, pos, theta), rope(k, pos, theta)
        if kv_group:
            k, v = int8_kv(k, kv_group), int8_kv(v, kv_group)
        out, start = [], 0
        for n in lens:
            sl = slice(start, start + n)
            out.append(attention(q[sl], k[sl], v[sl], slopes))
            start += n
        attn = torch.cat(out).reshape(-1, n_q * hd)
        o = mm(attn, int8_weight(lp["wo"]))
        if "bo" in lp:
            o = o + lp["bo"].float()
        x = x + o
        h = rms_norm(x, eps)
        gu = mm(h, int8_weight(lp["w_gate_up"]).reshape(d, -1)).reshape(
            -1, 2, cfg["intermediate_dim"])
        act = torch.nn.functional.silu(gu[:, 0]) * gu[:, 1]
        x = x + mm(act, int8_weight(lp["w_down"]))
        del lp
    lm_head = draw.lm_head().float()
    x = rms_norm(x, eps)
    gaps, start = [], 0
    for s, n in zip(seqs, lens):
        n_in = len(s["prompt"])
        rows = x[start + n_in - 1:start + n]
        logits = rows @ lm_head
        served = torch.tensor(s["tokens"], dtype=torch.long, device=dev)
        best = logits.max(dim=-1).values
        got = logits.gather(1, served[:, None].clamp(
            max=cfg["vocab_size"] - 1))[:, 0]
        gaps.append((best - got).tolist())
        start += n
    return gaps
