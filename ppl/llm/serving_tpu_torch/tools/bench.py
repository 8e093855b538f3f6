#!/usr/bin/env python3
"""The port's headline bench: continuous-batching decode throughput of
the whole serving stack (generator, engine, CUDA-graph replayed steps,
the kernels), the counterpart of the JAX package's root ``bench.py``.

Prints ONE JSON line with the JAX bench's keys (``metric``
``output_tokens_per_sec_per_chip``, ``value``, ``unit``, ``vs_baseline``,
``config``, ``p50_ttft_ms``, ``elapsed_s``, ``roofline_tokens_per_sec``,
``backend``: ``"cuda"`` or ``"cpu"``) plus ``device`` and
``power_limit_w`` (``nvidia-smi``) and ``launches``: each kernel's
launches over the measured waves (``ops.kernels.launch_counts``).

Traffic, as the JAX bench's: warm-up of the measured shape, then
``BENCH_WAVES`` (3) measured waves of greedy requests of random tokens
drawn from ``RandomState(0)``; random weights (throughput does not
depend on their values). The JAX bench warms up with one wave, which
compiles every program the measured waves run; here a program key is
captured as a CUDA graph at its second visit, and a wave's one prefill
step visits its key once, so the warm-up is two waves of the measured
shape. ``BENCH_CONFIG``:

- ``i8i8`` (default): TinyLlama-1.1B widths (22 layers), int8 weights
  and int8 group-8 KV; ``bf16``: bf16 weights and KV; ``i8i8_w``: int8
  weights, bf16 KV; ``kv8``: bf16 weights, int8 KV; ``w4``: group-int4
  weights (w4a8), int8 KV. Batch 64, 128 prompt and 128 generated
  tokens, a 131,072-token KV pool.
- ``i8i8_7b`` (the north-star configuration) and ``w4_7b``: LLaMA-2-7B
  widths (32 layers), int8 KV, batch 48 (``BENCH_BATCH``), a
  16,384-token pool (``BENCH_KV_TOKENS``), prefill waves of 16.

Decode blocks of 16 steps (``BENCH_MULTI_STEP``), an int8 lm_head
(``BENCH_QUANT_LM_HEAD``), token buckets (prompt, 2 x prompt, 8192),
batch buckets (batch, 4 x batch). ``vs_baseline`` is the share of the
decode roofline: every step reads all weights and the batch's KV at
mid-generation, over the card's HBM bandwidth (by the card's name; an
unknown card raises). Other knobs keep the JAX bench's meaning:
``BENCH_MAX_PREFILL_BATCH``, ``BENCH_SPEC_BLOCKS``, ``BENCH_BLOCK_TAIL``,
``BENCH_WAVES``, ``BENCH_PROFILE`` (1: the generator's profile blocks, 2:
every step's), ``BENCH_TRACE_DIR`` / ``_START`` / ``_STEPS`` (a
torch.profiler trace of those generator steps, for ``trace_summary``)
and ``BENCH_DEADLINE`` (s; 600 on the card, 0 = none: a run cut by it
reports ``partial_warmup`` or ``partial_last_wave``; one cut before a
measured wave finished also has an ``error`` and exits 1). ``BENCH_AOT=1``,
``BENCH_QUANT_IMPL`` and ``BENCH_SEQ_BLOCK`` are refused (not yet
ported: CUDA graphs take the AOT store's place, and the kernels have no
impl or seq-block knob).

It runs on the card unless ``--device cpu`` is given, and then at the
JAX bench's tiny smoke widths (2 layers, hidden 64, batch 8, 16 in, 16
out; the 7B configs keep their quantization); without a GPU and without
``--device cpu`` it fails. Any failure prints the error JSON line
(``value`` 0) and exits 1.

    python -m ppl.llm.serving_tpu_torch.tools.bench [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from typing import Mapping, Optional, Sequence

import numpy as np

from ppl.llm.serving_tpu_torch.config import (ConfigError, GeneratorConfig,
                                              ModelConfig, ResourceConfig,
                                              not_ported)

METRIC = "output_tokens_per_sec_per_chip"
# waves of the measured shape before the measured ones: every program key
# they visit has then had its eager first visit and its graph capture
WARM_WAVES = 2
VARIANTS = ("i8i8", "bf16", "i8i8_w", "kv8", "w4", "w4_7b", "i8i8_7b")


def refuse_unported(env: Mapping[str, str]) -> None:
    """The JAX bench's knobs that have no counterpart here raise."""
    if env.get("BENCH_AOT", "0") == "1":
        raise not_ported("BENCH_AOT=1 (the AOT executable store)")
    if env.get("BENCH_QUANT_IMPL"):
        raise not_ported("BENCH_QUANT_IMPL (the quant-matmul impl knob)")
    if env.get("BENCH_SEQ_BLOCK"):
        raise not_ported("BENCH_SEQ_BLOCK (the attention seq-block knob)")


def bench_setup(device: str, env: Mapping[str, str]) -> dict:
    """``BENCH_CONFIG`` and the knobs of ``env`` -> the run's configs and
    shape, as the JAX bench builds them (``bench.py:112-196``)."""
    refuse_unported(env)
    variant = env.get("BENCH_CONFIG", "i8i8")
    if variant not in VARIANTS:
        raise ConfigError(f"unknown BENCH_CONFIG {variant!r} (one of "
                          f"{', '.join(VARIANTS)})")
    on_card = device != "cpu"
    model_name = "tinyllama1.1b"
    max_prefill = env.get("BENCH_MAX_PREFILL_BATCH")
    if on_card and variant in ("i8i8_7b", "w4_7b"):
        model_name = "llama2-7b"
        model_cfg = ModelConfig(
            hidden_dim=4096, intermediate_dim=11008, num_layers=32,
            num_heads=32, num_kv_heads=32, vocab_size=32000,
            cache_mode=1, page_size=128, dtype="bfloat16")
        batch = int(env.get("BENCH_BATCH", "48"))
        prompt_len, gen_len = 128, 128
        max_prefill = max_prefill or str(min(batch, 16))
        kv_tokens = int(env.get("BENCH_KV_TOKENS", 16 * 1024))
    elif on_card:
        model_cfg = ModelConfig(
            hidden_dim=2048, intermediate_dim=5632, num_layers=22,
            num_heads=32, num_kv_heads=4, vocab_size=32000,
            cache_mode=1, page_size=128, dtype="bfloat16")
        batch, prompt_len, gen_len = 64, 128, 128
        kv_tokens = 128 * 1024
    else:
        model_cfg = ModelConfig(
            hidden_dim=64, intermediate_dim=128, num_layers=2,
            num_heads=4, num_kv_heads=2, vocab_size=256,
            cache_mode=1, page_size=16, dtype="float32")
        batch, prompt_len, gen_len = 8, 16, 16
        kv_tokens = 4096
    quant = {"i8i8_7b": "i8i8", "w4_7b": "w4"}.get(variant, variant)
    if quant in ("i8i8", "kv8", "w4"):
        model_cfg.cache_quant_bit = 8
        model_cfg.cache_quant_group = 8
    resource_cfg = ResourceConfig(
        model_format="random", device=device,
        kv_cache_max_tokens=kv_tokens,
        token_buckets=(prompt_len, 2 * prompt_len, 8192),
        batch_buckets=(batch, 4 * batch),
        multi_step=int(env.get("BENCH_MULTI_STEP", "16")),
        quant_method=("online_i8i8" if quant in ("i8i8", "i8i8_w")
                      else "online_w4a8" if quant == "w4" else "none"),
        quantize_lm_head=bool(int(env.get("BENCH_QUANT_LM_HEAD", "1"))),
        block_tail=env.get("BENCH_BLOCK_TAIL", "auto"))
    profile = env.get("BENCH_PROFILE", "0")
    gen_cfg = GeneratorConfig(
        max_running_batch=4 * batch,
        max_prefill_batch=int(max_prefill or batch),
        max_tokens_per_step=max(8192, batch * prompt_len),
        max_input_tokens_per_request=4096,
        max_output_tokens_per_request=4096,
        max_total_tokens_per_request=8192,
        speculative_blocks=int(env.get("BENCH_SPEC_BLOCKS", "1")),
        enable_profiling=bool(int(profile)),
        profile_step_interval=1 if profile == "2" else 100,
        trace_dir=env.get("BENCH_TRACE_DIR", ""),
        trace_start_step=int(env.get("BENCH_TRACE_START", "3")),
        trace_num_steps=int(env.get("BENCH_TRACE_STEPS", "4")))
    config = (f"{model_name}-{variant}" if on_card else "tiny-smoke") + \
        f"-b{batch}-in{prompt_len}-out{gen_len}"
    return dict(model_cfg=model_cfg, resource_cfg=resource_cfg,
                gen_cfg=gen_cfg, quant=quant, batch=batch,
                prompt_len=prompt_len, gen_len=gen_len, config=config,
                waves=int(env.get("BENCH_WAVES", "3")),
                deadline=float(env.get("BENCH_DEADLINE",
                                       "600" if on_card else "0")))


def decode_roofline(model_cfg: ModelConfig, quant: str,
                    quantize_lm_head: bool, batch: int, prompt_len: int,
                    gen_len: int, bytes_per_s: float):
    """``(step_bytes, roofline tokens/s)`` of the JAX bench's decode
    roofline (``bench.py:347-368``): a decode step reads every matmul
    weight (int8: 1 byte, w4: 0.5, else 2), the lm_head (quantized with
    the weights when ``quantize_lm_head``), and the batch's KV at
    mid-generation (int8 with group-8 bf16 scales: 1 + 2/8 bytes a
    value, else 2)."""
    wbytes = (1 if quant in ("i8i8", "i8i8_w")
              else 0.5 if quant == "w4" else 2)
    kvbytes = (1 + 2 / model_cfg.cache_quant_group
               if model_cfg.cache_quant_bit == 8 else 2)
    head_wbytes = wbytes if quantize_lm_head else 2
    m = model_cfg
    param_bytes = (
        head_wbytes * m.vocab_size * m.hidden_dim
        + wbytes * m.num_layers * (
            m.hidden_dim * (m.num_heads + 2 * m.num_kv_heads) * m.head_dim
            + m.num_heads * m.head_dim * m.hidden_dim
            + 3 * m.hidden_dim * m.intermediate_dim))
    kv_bytes_per_seq = (m.num_layers * 2 * m.num_kv_heads * m.head_dim
                        * kvbytes * (prompt_len + gen_len / 2))
    step_bytes = param_bytes + batch * kv_bytes_per_seq
    return step_bytes, bytes_per_s / step_bytes * batch


def run(device: str, env: Mapping[str, str], t0: float) -> dict:
    """One bench run; returns its JSON record. Raises on any failure."""
    import torch

    from ppl.llm.serving_tpu_torch.connection import LocalConnection
    from ppl.llm.serving_tpu_torch.generator import LLMGenerator
    from ppl.llm.serving_tpu_torch.ops import kernels
    from ppl.llm.serving_tpu_torch.profiler import print_profiler
    from ppl.llm.serving_tpu_torch.request import Request
    from ppl.llm.serving_tpu_torch.resources import (create_engine,
                                                     require_device)
    from ppl.llm.serving_tpu_torch.tokenizer.factory import ByteTokenizer
    from ppl.llm.serving_tpu_torch.tools.common import (card_name_and_limit,
                                                        hbm_bytes_per_s)

    dev = require_device(device)
    s = bench_setup(dev.type, env)
    card, limit_w, bw = "cpu", None, None
    if dev.type == "cuda":
        card, limit = card_name_and_limit(dev.index or 0)
        limit_w = float(limit.split()[0])
        bw = hbm_bytes_per_s(card)
    model_cfg, gen_cfg = s["model_cfg"], s["gen_cfg"]
    batch, prompt_len, gen_len = s["batch"], s["prompt_len"], s["gen_len"]
    deadline = s["deadline"]

    def remaining(reserve=0.0):
        if deadline <= 0:
            return float("inf")
        return deadline - (time.monotonic() - t0) - reserve

    def log(msg):
        print(f"[bench] {msg} (t+{time.monotonic() - t0:.0f}s)",
              file=sys.stderr, flush=True)

    t_eng = time.perf_counter()
    engine, kv_max, _ = create_engine(model_cfg, s["resource_cfg"], gen_cfg)
    log(f"engine created in {time.perf_counter() - t_eng:.1f}s on {card}")
    first_token_ts = {}
    conn = LocalConnection(on_first_token=lambda tid: first_token_ts
                           .setdefault(tid, time.perf_counter()))
    if gen_cfg.enable_profiling:
        conn.on_profiling = lambda p: print_profiler(p, file=sys.stderr)
    gen = LLMGenerator(model_cfg, gen_cfg, engine, ByteTokenizer(), conn,
                       kv_max)
    rng = np.random.RandomState(0)

    def make_reqs(base, n):
        return [Request(id=base + i,
                        token_ids=rng.randint(
                            3, model_cfg.vocab_size - 1,
                            size=prompt_len).tolist(),
                        generation_length=gen_len, top_k=1,
                        early_stopping=False)
                for i in range(n)]

    record = dict(metric=METRIC, unit="tokens/s", config=s["config"],
                  backend=dev.type, device=card, power_limit_w=limit_w)
    try:
        # warm-up: the measured shape, so that every program key the
        # measured waves visit has had its eager first run and its graph
        # capture; budgeted by the deadline as the JAX bench's
        t_warm = time.perf_counter()
        for w in range(WARM_WAVES):
            warm = make_reqs(10_000 + w * batch, batch)
            conn.set_wanted(len(warm))
            for r in warm:
                gen.process(r)
            warm_ok = conn.wait(timeout=min(
                3300.0, max(90.0, remaining(reserve=150))))
            if not warm_ok and remaining(reserve=90) > 0:
                warm_ok = conn.wait(timeout=min(1200.0,
                                                remaining(reserve=90)))
            log(f"warmup wave {w + 1}/{WARM_WAVES} at "
                f"{time.perf_counter() - t_warm:.1f}s (completed={warm_ok})")
            if not warm_ok:
                break
        warm_elapsed = time.perf_counter() - t_warm
        if not warm_ok:
            warm_tokens = sum(len(v) for k, v in conn.tokens.items()
                              if k >= 10_000)
            return dict(record, value=round(warm_tokens / warm_elapsed, 2),
                        vs_baseline=0, partial_warmup=True,
                        error=f"warmup incomplete after {warm_elapsed:.0f}s "
                              f"(deadline {deadline:.0f}s); value measured "
                              "over the warmup wave")
        time.sleep(0.5)

        kernels.reset_launch_counts()
        elapsed, waves_done, ok = 0.0, 0, True
        wave0 = None
        for w in range(s["waves"]):
            if w > 0 and remaining(reserve=20) <= 0:
                break   # deadline: report the waves that finished
            reqs = make_reqs(w * batch, batch)
            t_start = time.perf_counter()
            if w == 0:
                wave0 = (reqs, t_start)
            conn.set_wanted(len(reqs))
            for r in reqs:
                gen.process(r)
            ok = conn.wait(timeout=min(1800.0, max(60.0, remaining())))
            elapsed += time.perf_counter() - t_start
            if not ok:
                break
            waves_done += 1
        log(f"measured {elapsed:.2f}s over {waves_done}/{s['waves']} waves")
    finally:
        gen.shutdown()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    record["launches"] = kernels.launch_counts()
    out_tokens = sum(len(v) for k, v in conn.tokens.items() if k < 10_000)
    tps = out_tokens / elapsed if elapsed > 0 else 0.0
    if waves_done == 0:
        return dict(record, value=round(tps, 2), vs_baseline=0,
                    partial_last_wave=True,
                    error="measured wave timed out; value is the partial "
                          "wave's tokens")
    reqs, t_start = wave0
    ttfts = sorted(first_token_ts[r.id] - t_start for r in reqs
                   if r.id in first_token_ts)
    p50_ttft_ms = ttfts[len(ttfts) // 2] * 1e3 if ttfts else -1
    roofline = vs = None
    if bw is not None:
        _, roofline = decode_roofline(
            model_cfg, s["quant"], s["resource_cfg"].quantize_lm_head, batch,
            prompt_len, gen_len, bw)
        roofline = round(roofline, 1)
        vs = round(tps / roofline, 4)
    return dict(record, value=round(tps, 2), vs_baseline=vs,
                p50_ttft_ms=round(p50_ttft_ms, 1),
                elapsed_s=round(elapsed, 2),
                roofline_tokens_per_sec=roofline,
                **({"partial_last_wave": True} if not ok else {}))


def main(argv: Optional[Sequence[str]] = None) -> int:
    t0 = time.monotonic()
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda",
                   help="cuda (default), cuda:N, or cpu (tiny smoke widths)")
    args = p.parse_args(argv)
    try:
        record = run(args.device, os.environ, t0)
    except Exception as e:  # noqa: BLE001 - the one JSON line, then exit 1
        traceback.print_exc()
        print(json.dumps({"metric": METRIC, "value": 0, "unit": "tokens/s",
                          "vs_baseline": 0,
                          "error": f"{type(e).__name__}: {e}"[:300]}),
              flush=True)
        return 1
    print(json.dumps(record), flush=True)
    # a deadline-cut warm-up or first wave carries an error: not a result
    return 1 if "error" in record else 0


if __name__ == "__main__":
    sys.exit(main())
