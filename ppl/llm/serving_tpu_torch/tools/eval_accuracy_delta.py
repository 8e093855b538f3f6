#!/usr/bin/env python3
"""Quantization accuracy-delta harness of the port.

The port of the JAX package's ``tools/eval_accuracy_delta.py``. The
<=0.1 perplexity-delta budget (BASELINE.md) is defined against real
checkpoints, which the repository does not hold. This harness TRAINS a
small byte-level LLaMA probe on the repository's texts (so weights and
activations develop the outlier structure that stresses int8/int4
quantization; random-init logits are near-uniform and would understate
the error), then scores held-out text through the serving forward
(:func:`llama.make_nll_fn`: paged cache, K2, the K3/K4 matmuls, the same
quantization code) under each quant config on ``--device``, and reports
the perplexity delta and the KL distortion against the float baseline,
with a known-bad control that must be detected.

The probe is :class:`ProbeLlama`, a plain PyTorch LLaMA with HF's
parameter names, trained by AdamW on next-token cross-entropy on
``--device`` from an explicit ``torch.Generator``; it runs no kernel.

    python -m ppl.llm.serving_tpu_torch.tools.eval_accuracy_delta \\
        --train-steps 300 --json-out acc.json [--device cpu]

Exit code 0 when both budget verdicts pass, 1 otherwise.
"""

import argparse
import json
import math
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ppl.llm.serving_tpu_torch.config import ModelConfig
from ppl.llm.serving_tpu_torch.models import llama
from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.ops.kv_cache import CacheSpec
from ppl.llm.serving_tpu_torch.resources import require_device

DEFAULT_TEXTS = ("README.md", "docs/performance.md", "SURVEY.md",
                 "COMPONENTS.md")
# the root of a checkout: ppl/llm/serving_tpu_torch/tools/<this file>
REPO_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))))))
_MATMULS = ("wqkv", "wo", "w_gate_up", "w_down")

# (name, eval_nll keywords): the float baseline first, then the configs
# whose distortion is measured against it
CONFIGS = [
    ("fp32", dict(quant_method="none", cache_quant=0,
                  quantize_lm_head=False, dtype="float32")),
    ("bf16", dict(quant_method="none", cache_quant=0,
                  quantize_lm_head=False, dtype="bfloat16")),
    ("bf16+kv8", dict(quant_method="none", cache_quant=8,
                      quantize_lm_head=False, dtype="bfloat16")),
    ("i8i8+kv8", dict(quant_method="online_i8i8", cache_quant=8,
                      quantize_lm_head=False, dtype="bfloat16")),
    ("i8i8+kv8+qhead", dict(quant_method="online_i8i8", cache_quant=8,
                            quantize_lm_head=True, dtype="bfloat16")),
    ("w4a8+kv8", dict(quant_method="online_w4a8", cache_quant=8,
                      quantize_lm_head=False, dtype="bfloat16")),
    # known-bad control (per-tensor int4 RTN weights), scored through the
    # plain float path
    ("CONTROL-int4-pt", dict(quant_method="none", cache_quant=0,
                             quantize_lm_head=False, dtype="float32")),
]


def load_corpus(paths, min_bytes: int = 1_500_000):
    """Byte-level training corpus. A probe model OVERFIT to a small
    corpus has no statistical power: quantization noise then acts as
    regularization and IMPROVES held-out perplexity. With a corpus large
    enough that training stays under ~one epoch, quantization deltas
    recover their real sign. So: the named docs first (relative paths
    from the checkout's root), then every source/test/doc file of the
    checkout in sorted order until ``min_bytes``."""
    root = REPO_ROOT
    text = ""
    for p in paths:
        fp = p if os.path.isabs(p) else os.path.join(root, p)
        if os.path.exists(fp):
            text += open(fp, encoding="utf-8").read() + "\n\n"
    if len(text) < min_bytes:
        extra = []
        for dirpath, dirnames, filenames in os.walk(root):
            dirnames[:] = [d for d in dirnames
                           if not d.startswith(".") and d != "__pycache__"]
            for fn in sorted(filenames):
                if fn.endswith((".py", ".md", ".cpp", ".proto", ".sh",
                                ".json", ".ini", ".txt")):
                    extra.append(os.path.join(dirpath, fn))
        for fp in sorted(extra):
            if len(text) >= min_bytes:
                break
            try:
                text += open(fp, encoding="utf-8").read() + "\n\n"
            except (OSError, UnicodeDecodeError):
                continue
    return text.encode("utf-8")  # byte-level tokens, vocab 256


# ---------------------------------------------------------------- the probe

class _RMSNorm(torch.nn.Module):
    def __init__(self, dim: int, eps: float):
        super().__init__()
        self.weight = torch.nn.Parameter(torch.ones(dim))
        self.eps = eps

    def forward(self, x):
        x32 = x.to(torch.float32)
        x32 = x32 * torch.rsqrt(x32.pow(2).mean(-1, keepdim=True) + self.eps)
        return self.weight * x32.to(x.dtype)


class _Attention(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, hd = cfg.hidden_dim, cfg.head_dim
        self.cfg = cfg
        self.q_proj = torch.nn.Linear(d, cfg.num_heads * hd, bias=False)
        self.k_proj = torch.nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.v_proj = torch.nn.Linear(d, cfg.num_kv_heads * hd, bias=False)
        self.o_proj = torch.nn.Linear(cfg.num_heads * hd, d, bias=False)

    def forward(self, x, cos, sin):
        b, t, _ = x.shape
        cfg, hd = self.cfg, self.cfg.head_dim

        def heads(y, n):
            return y.view(b, t, n, hd).transpose(1, 2)    # [B, n, T, hd]

        def rope(y):
            y1, y2 = y[..., :hd // 2], y[..., hd // 2:]
            return y * cos + torch.cat([-y2, y1], dim=-1) * sin

        q = rope(heads(self.q_proj(x), cfg.num_heads))
        k = rope(heads(self.k_proj(x), cfg.num_kv_heads))
        v = heads(self.v_proj(x), cfg.num_kv_heads)
        g = cfg.num_heads // cfg.num_kv_heads
        k = k.repeat_interleave(g, dim=1)
        v = v.repeat_interleave(g, dim=1)
        o = F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                           scale=hd ** -0.5)
        return self.o_proj(o.transpose(1, 2).reshape(b, t, -1))


class _MLP(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        d, i = cfg.hidden_dim, cfg.intermediate_dim
        self.gate_proj = torch.nn.Linear(d, i, bias=False)
        self.up_proj = torch.nn.Linear(d, i, bias=False)
        self.down_proj = torch.nn.Linear(i, d, bias=False)

    def forward(self, x):
        return self.down_proj(F.silu(self.gate_proj(x)) * self.up_proj(x))


class _Layer(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.self_attn = _Attention(cfg)
        self.mlp = _MLP(cfg)
        self.input_layernorm = _RMSNorm(cfg.hidden_dim, cfg.norm_eps)
        self.post_attention_layernorm = _RMSNorm(cfg.hidden_dim,
                                                 cfg.norm_eps)

    def forward(self, x, cos, sin):
        x = x + self.self_attn(self.input_layernorm(x), cos, sin)
        return x + self.mlp(self.post_attention_layernorm(x))


class _Body(torch.nn.Module):
    def __init__(self, cfg: ModelConfig):
        super().__init__()
        self.embed_tokens = torch.nn.Embedding(cfg.vocab_size,
                                               cfg.hidden_dim)
        self.layers = torch.nn.ModuleList(_Layer(cfg)
                                          for _ in range(cfg.num_layers))
        self.norm = _RMSNorm(cfg.hidden_dim, cfg.norm_eps)


class ProbeLlama(torch.nn.Module):
    """A plain PyTorch LLaMA with the parameter names of HF's
    ``LlamaForCausalLM`` (``model.layers.{i}.self_attn.q_proj.weight``,
    ...), so that :func:`hf_to_params` maps its state dict as the loader
    maps a checkpoint: rotate-half RoPE, GQA, RMSNorm, SiLU MLP, an untied
    lm_head. Weights start as HF's do (N(0, 0.02) for every matrix, ones
    for the norms), drawn from ``generator`` on the CPU."""

    def __init__(self, cfg: ModelConfig, generator: torch.Generator):
        super().__init__()
        self.cfg = cfg
        self.model = _Body(cfg)
        self.lm_head = torch.nn.Linear(cfg.hidden_dim, cfg.vocab_size,
                                       bias=False)
        with torch.no_grad():
            for name, p in self.named_parameters():
                if p.ndim == 2:
                    p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        """ids i64[B, T] -> logits f32[B, T, V]."""
        hd, t = self.cfg.head_dim, ids.shape[1]
        inv_freq = 1.0 / (self.cfg.rope_theta ** (torch.arange(
            0, hd, 2, dtype=torch.float32, device=ids.device) / hd))
        angles = torch.arange(t, dtype=torch.float32,
                              device=ids.device)[:, None] * inv_freq
        angles = torch.cat([angles, angles], dim=-1)
        cos, sin = angles.cos(), angles.sin()
        x = self.model.embed_tokens(ids)
        for layer in self.model.layers:
            x = layer(x, cos, sin)
        return self.lm_head(self.model.norm(x))


def train_probe(cfg: ModelConfig, data: bytes, steps: int, seq_len: int,
                batch: int, device, seed: int = 0) -> ProbeLlama:
    """Train a byte-level :class:`ProbeLlama` on ``device`` just long
    enough for realistic weight/activation distributions: AdamW (lr 3e-4)
    on next-token cross-entropy over random windows of ``data``, the
    initial weights and the windows drawn from generators seeded with
    ``seed``."""
    gen = torch.Generator().manual_seed(seed)
    model = ProbeLlama(cfg, gen).to(device)
    ids = torch.from_numpy(np.frombuffer(data, np.uint8).astype(np.int64))
    opt = torch.optim.AdamW(model.parameters(), lr=3e-4)
    t0 = time.time()
    for step in range(steps):
        starts = torch.randint(0, len(ids) - seq_len - 1, (batch,),
                               generator=gen)
        x = torch.stack([ids[s:s + seq_len] for s in starts]).to(device)
        y = torch.stack([ids[s + 1:s + seq_len + 1] for s in starts]).to(
            device)
        loss = F.cross_entropy(model(x).reshape(-1, cfg.vocab_size),
                               y.reshape(-1))
        opt.zero_grad()
        loss.backward()
        opt.step()
        if step % 50 == 0 or step == steps - 1:
            print(f"[train] step {step}  loss {loss.item():.3f}  "
                  f"({time.time() - t0:.0f}s)", file=sys.stderr)
    model.eval()
    return model


def hf_to_params(model, cfg: ModelConfig):
    """HF-named torch state dict -> the port's fused float32 parameters
    on the CPU (the mapping the loader uses for HF checkpoints,
    models/loader.py)."""
    sd = {k: v.detach().to("cpu", torch.float32)
          for k, v in model.state_dict().items()}
    d, hd = cfg.hidden_dim, cfg.head_dim
    n_kv, g = cfg.num_kv_heads, cfg.num_heads // cfg.num_kv_heads

    def get(name, transpose=True):
        w = sd[name]
        return (w.T if transpose else w).contiguous()

    def make_layer(i):
        pre = f"model.layers.{i}"
        wq = get(f"{pre}.self_attn.q_proj.weight").reshape(d, n_kv, g, hd)
        wk = get(f"{pre}.self_attn.k_proj.weight").reshape(d, n_kv, 1, hd)
        wv = get(f"{pre}.self_attn.v_proj.weight").reshape(d, n_kv, 1, hd)
        return {
            "attn_norm": get(f"{pre}.input_layernorm.weight",
                             transpose=False),
            "ffn_norm": get(f"{pre}.post_attention_layernorm.weight",
                            transpose=False),
            "wqkv": torch.cat([wq, wk, wv], dim=2),
            "wo": get(f"{pre}.self_attn.o_proj.weight"),
            "w_gate_up": torch.stack(
                [get(f"{pre}.mlp.gate_proj.weight"),
                 get(f"{pre}.mlp.up_proj.weight")], dim=1),
            "w_down": get(f"{pre}.mlp.down_proj.weight"),
        }

    return {
        "embedding": get("model.embed_tokens.weight", transpose=False),
        "layers": [make_layer(i) for i in range(cfg.num_layers)],
        "final_norm": get("model.norm.weight", transpose=False),
        "lm_head": get("lm_head.weight"),
    }


def degrade_params_int4_pertensor(params):
    """KNOWN-BAD control: RTN-quantize every transformer matmul weight to
    4-bit with a single PER-TENSOR scale (no channels, no groups). Per-
    tensor int4 on trained weights must produce a clearly detectable
    regression; if the harness cannot detect it, the probe has no
    statistical power and 'within budget' results are meaningless. The
    arithmetic is the JAX tool's, in numpy on the CPU."""
    out_layers = []
    for lp in params["layers"]:
        nl = dict(lp)
        for name in _MATMULS:
            w = lp[name].detach().cpu().numpy().astype(np.float32)
            s = np.abs(w).max() / 7.0
            nl[name] = torch.from_numpy(np.asarray(
                np.clip(np.round(w / s), -8, 7) * s, np.float32))
        out_layers.append(nl)
    return {**params, "layers": out_layers}


def eval_nll(cfg: ModelConfig, params, data: bytes, seq_len: int,
             max_chunks: int, quant_method: str, cache_quant: int,
             quantize_lm_head: bool, dtype: str, base_logprobs=None,
             device="cpu"):
    """Score ``data`` through the serving forward on ``device``. The
    float32 ``params`` are quantized with ``quant_method`` (from the f32
    weights), then their float tensors cast to ``dtype``. Returns
    (mean NLL, perplexity, tokens, per-chunk NLL sums, per-chunk token
    counts, per-chunk KL sums): the KL sums of per-position KL(fp32 ||
    this config) when ``base_logprobs`` (the fp32 run's per-chunk [n, V]
    log-softmax arrays) is given. The fp32 call passes
    ``base_logprobs=[]`` to collect its own logprobs."""
    device = torch.device(device)
    cfg = ModelConfig(**{**cfg.__dict__, "dtype": dtype,
                         "cache_quant_bit": cache_quant,
                         "cache_quant_group": 8 if cache_quant else 1})
    if quant_method != "none":
        params = llama.quantize_model_params(params, quant_method,
                                             quantize_lm_head)
    compute = llama.torch_dtype(dtype)

    def place(name, t):
        if name.endswith(("_q", "_s")):
            return t.to(device)
        return t.to(device, compute)

    params = {**{k: place(k, v) for k, v in params.items() if k != "layers"},
              "layers": [{k: place(k, v) for k, v in lp.items()}
                         for lp in params["layers"]]}
    pages = -(-seq_len // cfg.page_size)
    spec = CacheSpec(
        num_layers=cfg.num_layers, num_pages=pages,
        page_size=cfg.page_size, num_kv_heads=cfg.num_kv_heads,
        head_dim=cfg.head_dim, quant_bit=cache_quant,
        quant_group=8 if cache_quant else 1, dtype=compute)
    nll_fn = llama.make_nll_fn(cfg, spec, quant_method=quant_method,
                               return_logprobs=True)
    ids = np.frombuffer(data, np.uint8).astype(np.int32)
    page_table = torch.arange(pages, dtype=torch.int32,
                              device=device)[None, :]
    cache, scale = kv_ops.init_cache(spec, device)
    chunk_nll, chunk_tok, chunk_kl = [], [], []
    collect = base_logprobs == []
    for ci in range(max_chunks):
        chunk = ids[ci * seq_len:(ci + 1) * seq_len]
        if len(chunk) < 2:
            break
        padded = np.zeros(seq_len, np.int32)
        padded[:len(chunk)] = chunk
        with torch.no_grad():
            nll, mask, lps = nll_fn(params, cache, scale,
                                    torch.from_numpy(padded).to(device),
                                    len(chunk), page_table)
        nll, mask = nll.cpu().numpy(), mask.cpu().numpy()
        lps = lps.cpu().numpy()[mask]
        chunk_nll.append(float(nll[mask].sum()))
        chunk_tok.append(int(mask.sum()))
        if collect:
            base_logprobs.append(lps)
        elif base_logprobs is not None:
            b = base_logprobs[ci]
            chunk_kl.append(float(
                (np.exp(b) * (b - lps)).sum(axis=-1).sum()))
    chunk_nll, chunk_tok = np.asarray(chunk_nll), np.asarray(chunk_tok)
    mean = chunk_nll.sum() / max(chunk_tok.sum(), 1)
    return (mean, math.exp(mean), int(chunk_tok.sum()), chunk_nll,
            chunk_tok, np.asarray(chunk_kl))


def paired_bootstrap_delta(base_nll, base_tok, cfg_nll, cfg_tok,
                           n_boot: int = 2000, seed: int = 7):
    """95% CI of the perplexity delta vs the float baseline, by PAIRED
    bootstrap over held-out chunks: each replicate resamples chunk
    indices once and evaluates both configs on the same chunks, so
    chunk-difficulty variance (which dwarfs the quantization effect)
    cancels. Returns (delta_mean, lo95, hi95)."""
    n = len(base_nll)
    rng = np.random.RandomState(seed)
    idx = rng.randint(0, n, size=(n_boot, n))
    b_nll = base_nll[idx].sum(axis=1) / base_tok[idx].sum(axis=1)
    c_nll = cfg_nll[idx].sum(axis=1) / cfg_tok[idx].sum(axis=1)
    deltas = np.exp(c_nll) - np.exp(b_nll)
    point = (math.exp(cfg_nll.sum() / cfg_tok.sum())
             - math.exp(base_nll.sum() / base_tok.sum()))
    return point, float(np.percentile(deltas, 2.5)), \
        float(np.percentile(deltas, 97.5))


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the probe trains and every config is "
                        "scored: cuda launches the CUDA kernels, cpu runs "
                        "their plain PyTorch versions")
    p.add_argument("--hidden", type=int, default=256)
    p.add_argument("--layers", type=int, default=4)
    p.add_argument("--heads", type=int, default=8)
    p.add_argument("--kv-heads", type=int, default=4)
    p.add_argument("--intermediate", type=int, default=512)
    p.add_argument("--train-steps", type=int, default=300)
    p.add_argument("--seq-len", type=int, default=256)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--eval-chunks", type=int, default=64)
    p.add_argument("--text-files", nargs="*", default=list(DEFAULT_TEXTS))
    p.add_argument("--json-out", default="")
    return p


def run(args) -> dict:
    """Train the probe, score every config, bootstrap the deltas and KL,
    apply the gates. Returns the JSON document (``doc``), the probe's
    config, its float parameters and the held-out bytes."""
    device = require_device(args.device)
    cfg = ModelConfig(
        hidden_dim=args.hidden, intermediate_dim=args.intermediate,
        num_layers=args.layers, num_heads=args.heads,
        num_kv_heads=args.kv_heads, vocab_size=256, norm_eps=1e-5,
        rope_theta=10000.0, cache_mode=1, page_size=16, dtype="float32")

    data = load_corpus(args.text_files)
    split = int(len(data) * 0.85)
    train, heldout = data[:split], data[split:]
    print(f"[INFO] corpus {len(data)} bytes ({split} train / "
          f"{len(heldout)} heldout)", file=sys.stderr)
    model = train_probe(cfg, train, args.train_steps, args.seq_len,
                        args.batch, device)
    params = hf_to_params(model, cfg)
    del model
    config_params = {name: params for name, _ in CONFIGS}
    config_params["CONTROL-int4-pt"] = degrade_params_int4_pertensor(params)
    # Two probes per config (CIs by bootstrap over held-out chunks):
    #  - HELD-OUT ppl delta: the budget metric as defined (BASELINE.md).
    #    On a small probe model it is confounded: quantization noise can
    #    act as regularization and score NEGATIVE deltas. Reported, not
    #    the gate.
    #  - mean per-position KL(fp32 || config) in nats/token: the
    #    DISTORTION probe, measured against the fp32 model itself, so
    #    regularization cannot push it negative; it is the expected NLL
    #    delta on text drawn FROM the fp32 model. A +0.1 ppl regression
    #    at the probe's own perplexity P costs log((P+0.1)/P) nats/token;
    #    the power and budget gates run on this.
    results = {}
    base = None
    base_lps = []
    budget_nats = 0.0
    print(f"\n{'config':<18} {'ppl':>8} {'d_ppl':>8} {'KL n/tok':>9} "
          f"{'KL 95% CI':>22}")
    for name, kw in CONFIGS:
        mean, ppl, ntok, cn, ct, ckl = eval_nll(
            cfg, config_params[name], heldout, args.seq_len,
            args.eval_chunks, base_logprobs=base_lps, device=device, **kw)
        if base is None:
            base = (cn, ct)
            budget_nats = math.log((ppl + 0.1) / ppl)
            results[name] = {"mean_nll": mean, "ppl": ppl,
                             "delta_ppl": 0.0, "tokens": ntok}
            print(f"{name:<18} {ppl:>8.4f} {'—':>8} {'—':>9} "
                  f"{'(baseline)':>22}")
            continue
        d, lo, hi = paired_bootstrap_delta(base[0], base[1], cn, ct)
        # bootstrap CI of mean KL per token over chunks
        rng = np.random.RandomState(11)
        idx = rng.randint(0, len(ckl), size=(2000, len(ckl)))
        kl_boot = ckl[idx].sum(axis=1) / ct[idx].sum(axis=1)
        kl_mean = float(ckl.sum() / ct.sum())
        kl_lo, kl_hi = (float(np.percentile(kl_boot, 2.5)),
                        float(np.percentile(kl_boot, 97.5)))
        results[name] = {"mean_nll": mean, "ppl": ppl, "delta_ppl": d,
                         "ci95": [lo, hi], "kl_per_tok": kl_mean,
                         "kl_ci95": [kl_lo, kl_hi], "tokens": ntok}
        print(f"{name:<18} {ppl:>8.4f} {d:>+8.4f} {kl_mean:>9.6f} "
              f"[{kl_lo:>9.6f},{kl_hi:>9.6f}]")

    # statistical-power gate: the deliberately-broken control must show a
    # KL whose CI lower bound exceeds the budget-equivalent nats, or the
    # run FAILS regardless of the production configs
    ctrl = results.get("CONTROL-int4-pt")
    power_ok = bool(ctrl and ctrl["kl_ci95"][0] > budget_nats)
    # budget gate on the KL CI UPPER bound over the int8-family configs
    # (the budget is defined "at same bit-width", BASELINE.md; w4a8 gets
    # its own budget below)
    gated = {k: v for k, v in results.items()
             if k in ("bf16", "bf16+kv8", "i8i8+kv8", "i8i8+kv8+qhead")}
    worst_name = max(gated, key=lambda k: gated[k]["kl_ci95"][1])
    worst = gated[worst_name]["kl_ci95"][1]
    verdict = "PASS" if (worst <= budget_nats and power_ok) else "FAIL"
    print(f"\n[RESULT] budget {budget_nats:.6f} nats/tok "
          f"(= +0.1 ppl at ppl {results['fp32']['ppl']:.1f}); "
          f"control KL lower-CI "
          f"{ctrl['kl_ci95'][0] if ctrl else float('nan'):.6f} "
          f"({'ok' if power_ok else 'NO POWER'}); "
          f"worst int8-config KL upper-CI {worst:.6f} ({worst_name}) "
          f"-> {verdict}")
    # int4 gate: a stated, larger distortion budget for w4a8, +0.25
    # ppl-equivalent (2.5x the int8 allowance), with the same power
    # precondition
    budget4_nats = math.log((results["fp32"]["ppl"] + 0.25)
                            / results["fp32"]["ppl"])
    w4 = results.get("w4a8+kv8")
    verdict4 = ("PASS" if (w4 and w4["kl_ci95"][1] <= budget4_nats
                           and power_ok) else "FAIL")
    if w4:
        print(f"[RESULT-int4] budget {budget4_nats:.6f} nats/tok "
              f"(= +0.25 ppl); w4a8+kv8 KL upper-CI "
              f"{w4['kl_ci95'][1]:.6f} -> {verdict4}")
    doc = {"results": results, "worst_kl_ci95": worst,
           "worst_config": worst_name, "power_ok": power_ok,
           "budget_nats": budget_nats, "verdict": verdict,
           "budget4_nats": budget4_nats, "verdict_int4": verdict4,
           "model": cfg.__dict__, "train_steps": args.train_steps}
    return dict(doc=doc, cfg=cfg, params=params,
                control_params=config_params["CONTROL-int4-pt"],
                heldout=heldout)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    doc = run(args)["doc"]
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(doc, f, indent=1)
    return 0 if (doc["verdict"] == "PASS"
                 and doc["verdict_int4"] == "PASS") else 1


if __name__ == "__main__":
    sys.exit(main())
