#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (ppl/llm/serving_tpu_torch).

Run from the root of a checkout on a machine with one NVIDIA H100:

    python3 chip_smoke.py

It imports nothing of JAX or of the JAX package, and runs in phases;
any failed phase exits non-zero and prints no result. Six serving paths
are driven: TinyLlama-1.1B widths with online_i8i8 weights over a bf16
paged KV cache (K1, K2, K3); LLaMA-2-7B widths with online_w4a8 weights,
an int4 lm_head and an int8 group-8 KV cache (K1 and K2 on int8 pages,
K4), per step (multi_step=1), in multi-step decode blocks of 8 (each
block a CUDA graph once its program key recurs), and in blocks with
block-tail mode (K1's tail phase); Baichuan-13B widths with ALiBi and
InternLM-7B widths with qkv/o biases, both online_i8i8 over int8 KV in
the default serving configuration (K1/K2's ALiBi branches on the first,
K3 on both); and Baichuan-13B again with the auto-sized KV pool, its
bucket grid validated before serving. Two more are served over gRPC by
the server tool's wiring: LLaMA-2-7B i8i8 over int8 KV with the prefix
cache (K2's prefix-hit rows), and TinyLlama i8i8 with chunked prefill.
A checkpoint path writes TinyLlama-1.1B widths as an HF checkpoint
(safetensors shards, their index, config.json) with a sentencepiece
tokenizer.model, both drawn here, loads it with online_i8i8 over int8 KV,
serves it and scores it with eval_ppl (K2, K3 at the NLL row's shape);
the accuracy harness (eval_accuracy_delta) trains its probe and scores
every quant config on the card. The KV-write microbench drives K5 through
its own entry point. Then the measuring tools run as a user runs them:
validate_kernels, the headline bench (TinyLlama b64, LLaMA-2-7B b48),
trace_summary, the microbenches, bench_cold_start and the host-turnaround
microbench, and the canonical qps benchmark twice: a first run that
records its program keys, and a restart that captures them.

1. the card's name and power limit (nvidia-smi);
2. builds every CUDA kernel from csrc/ (one nvcc per source, in parallel),
   prints each kernel's registers and spills, and counts the tensor-core
   instructions (cuobjdump -sass) of K3's and K4's two tiles each (IMMA)
   and K1's and K2's bf16 bodies (HMMA), and the bulk asynchronous copy
   (UBLKCP) in K5's kernel, failing if any is 0;
3. the launch floor (what the timer reads around one empty launch, a
   yardstick beside every row); one phase per kernel at each path's
   shapes: kernel vs its plain PyTorch version on the same inputs with
   the stated tolerance, kernel ms, plain ms, the least time the card could take (bound), and one
   PyTorch library call computing the same function as a yardstick
   (never called by the port; none exists for K4, which gets torch._int_mm
   on the unpacked int8 weight as an orientation figure only); K1 also in
   block-tail mode; K1/K2 with ALiBi (SDPA with the bias as its mask);
   K5 exact (at the microbench's geometry with 8 rows and all 128, and
   at 40 KV heads, whose page is no whole number of its chunks); K1's
   decode rows give each row pages of its own, as serving does; the
   canonical path's widths: K1 at LLaMA-2-7B over int8 KV at B=32 and
   64, K3 at 7B widths at T=32 and 64 and at TinyLlama's at T=64 (the
   b64 bench), and at 13B widths at T=8, 16 and 64 (the served decode
   bucket) as well as the prefill sizes; K1's rows print the context
   splits S of their grid, K3's their tile and split-K pieces S, K4's
   split-K rows their pieces S, each repeatable bit for bit;
   K2 also at the NLL forward's row (one row of 1,024 tokens at start 0,
   bf16 and int8 KV; yardstick SDPA with is_causal);
4. step cross-checks: 2-layer models at full width, same weights on cuda
   (kernels) and cpu (plain versions), one mixed decode+prefill step in
   float32: logits within tolerance, greedy tokens equal, written cache
   rows within tolerance (TinyLlama none and i8i8, Baichuan-13B and
   InternLM-7B i8i8 + int8 KV); at 7B i8i8 int8-KV also a prefix-hit
   step (start 8 pages) and a chunk step (start 512) over the cache a
   cold step wrote on the same device; then 4-step decode blocks at 7B (w4a8) and 13B
   (ALiBi, i8i8) width, block tail off and on, on cuda, where the block
   runs once eagerly and once as a captured CUDA graph from the same
   cache state, which must agree bit for bit, and the 13B block without
   the tail also on cpu, held to the cuda block; and
   make_nll_fn at 2 layers, 7B widths, f32, i8i8 + int8 KV, cuda against
   cpu (masks equal, NLL within the step check's rule); and one 8-step
   block at 7B widths and full depth in bf16, block tail on against the
   per-step writes, its logits within 3 times how far 2^-8 perturbations
   of the attention outputs move them (:func:`block_tail_bound`);
5. end to end, once per path: create_engine + LLMGenerator +
   LocalConnection serving 8 greedy requests (100-400 prompt tokens, 32
   new tokens each) at full depth (TinyLlama; the three LLaMA-2-7B w4a8
   paths at 16 of 32 layers, Baichuan-13B over an explicit pool at 20 of
   40, InternLM-7B at 16 of 32; the 13B auto-pool path at 40), after warm-up passes of the same shape
   (every program key eager once, then captured as a CUDA graph), with
   every kernel's launch counter set to 0 just before and read just
   after (also the engine's graph replays, the bytes its graph pools
   hold, and its device-fed or continuation dispatches; the weight
   build's own peak and the free memory after it); then a
   torch.profiler pass over the same traffic for the device-time
   breakdown. The six paths pin their KV pools and capture each program
   key at its second visit; the seventh sizes its pool after validating
   the bucket grid (create_engine with no kv_cache_max_tokens), prints
   the kept grid, the graph bytes, the pool and the serving peak against
   the card's memory, and fails if a graph is captured while serving;
   then two paths served over gRPC on a socket on 127.0.0.1 through
   tools/llm_server.build_server (the CLI's wiring; grpcio and protobuf
   are on the card's machine): LLaMA-2-7B i8i8 over int8 KV with the
   prefix cache (a cold prompt, 11 warm hits of its 1,024-token prefix
   and 4 other prompts as 4 concurrent streams, a full hit; gates: every
   stream ends with FINISH_REASON_LENGTH and 64 tokens, the exact hit
   count, K1/K2/K3 launched and K4/K5 not, K2 at start > 0, no capture
   while serving, a clean shutdown; printed: TTFT cold and warm,
   client_qps_measure's prefill and decode latency and tokens out/s),
   and TinyLlama i8i8 with 512-token chunked prefill (a 3,000-token
   prompt beside 7 decoding requests; gates: lengths, mixed decode +
   chunk steps, K2 at start > 0); then the checkpoint path
   (:func:`hf_checkpoint_path`: the loaded parameters byte-equal to a
   random engine's of the same seed, its greedy tokens equal too, K1-K3
   launched and K4 not; eval_ppl at --seq-len 1024 with K2 launched 22
   times a chunk) and the accuracy harness (:func:`accuracy_harness`:
   its verdicts printed as measured; every config's mean NLL on the card
   within the stated tolerance of the cpu's on the same weights);
6. the KV-write microbench at the 7B geometry: forms a-h timed, b-d and
   f-h held to (a)'s cache bytes, K5's launches counted over the run;
7. the measuring tools, each run as a user runs it (``python -m
   ppl.llm.serving_tpu_torch.tools.<tool>``), any failure failing the
   phase (:func:`tools_phase`): validate_kernels (all 22 cases ok, K5's
   page read included); the headline bench at TinyLlama i8i8 b64, traced,
   and at LLaMA-2-7B i8i8 b48 (one JSON line each, with a throughput, no
   error or partial wave, K1-K3 launched; their launches join the
   kernels line's ``launches_by_path``); trace_summary --group and
   --timeline over that trace; the K3/K4 microbench at 7B widths and
   T=32; the KV-append microbench at TinyLlama geometry;
   bench_cold_start at TinyLlama widths, 1 of its 22 layers, with the
   auto-sized KV pool and the warm-up manifest (nvcc runs on the cold
   start only; the cold start records at least one program key, the warm
   start captures every live key before it listens, and its probe runs
   no manifest key eagerly); the host-turnaround microbench
   (microbench_tunnel); one line timing the host allocators, the
   native host runtime against the port's Python classes, at the
   canonical pool (128 pages) and at the 13B auto pool (784 pages)
   (:func:`host_allocators`); and the library-embedding sample
   (``python -m ppl.llm.serving_tpu_torch.samples.embed_serving``, the
   demo model, 16 tokens on cuda);
8. the canonical qps benchmark, ``python -m
   ppl.llm.serving_tpu_torch.tools.bench_canonical --model 7b`` as a
   user runs it (:func:`canonical_phase`: LLaMA-2-7B i8i8 + int8 KV + an
   int8 lm_head, 256 ShareGPT-mix requests at rate inf, a warm pass and
   the measured pass, the program keys recorded in a manifest in the
   phase's temporary directory; its JSON line's numbers printed beside
   the card, the measured pass's eager dispatches among them); then the
   same server flags restart with that manifest and serve the first 64
   requests in one pass (every live manifest key captured before the
   server listens, none run eagerly, every request finished; startup,
   tokens out/s, TPOT and any key new to the manifest printed);
9. the ``kernels`` JSON line, then the device JSON line last.

``python3 chip_smoke.py --data-parallel N`` (a machine with N cards)
builds the kernels and serves TinyLlama through N replicas behind one
gRPC frontend, replica i on cuda:i (:func:`data_parallel_path`). It is a
separate run, made by hand on a machine with N cards; the run with no
arguments does not include it.

``python3 chip_smoke.py --tensor-parallel N`` (a machine with N cards,
one host) runs the tensor-parallel path (:func:`main_tensor_parallel`):
(1) the build and every rank's NCCL collectives; (2) a prefill and a
decode step at LLaMA-2-70B widths (4 layers) at tp=N, one process a card
(``--tp-rank``), against one card with the same weights: float weights
in f32 gated at 1e-3; i8i8 weights with int8 KV, in f32 and in bf16,
against one card computing the group's function (``emulate_tp=N``:
each rank's slice takes its own activation scale in the row-parallel
matmuls), gated at 3 times how far perturbing the attention outputs
(1e-6 in f32, 2^-8 in bf16) moves that card's logits, with the JAX
test's 5e-2 reported beside it and the distance from the tp=1 function
reported; and the i8i8
decode steps' CUDA graph replays, NCCL collectives inside, against their
eager runs bit for bit; (3) K1-K3 at one rank's LLaMA-2-70B shapes
against their plain versions; (4) LLaMA-2-70B i8i8 int8-KV at full depth
served by ``llm_server --tensor-parallel-size N`` over gRPC (17 streams,
4 at a time, prefix hits), with TTFT, TPOT, tokens out/s, each rank's
busy share, the NCCL kernels' share and the device time by kernel group
of rank 0 from a trace; with ``--one-card-share``, (5) one card serving
80/N layers at the whole width (one rank's share of the weights' bytes)
with the same traffic; then the kernels line and the device line with
``count`` N. It too is a separate run, made by hand.

``python3 chip_smoke.py --data-parallel 2 --tensor-parallel 2`` (four
cards) serves LLaMA-2-70B i8i8 int8-KV at full depth through
``llm_server --tensor-parallel-size 2 --data-parallel-size 2``: two
replicas of two-card groups behind one frontend
(:func:`dp_tp_server_path`); beside it, the four cards as one untraced
tp=4 server on the same requests; then the device line with ``count``
4. A separate run, made by hand.
"""

import contextlib
import dataclasses
import gc
import json
import re
import subprocess
import sys
import tempfile
import threading
import time

import numpy as np

SEED = 0
# TinyLlama-1.1B widths (bench.py:132-135)
TINY = dict(hidden_dim=2048, intermediate_dim=5632, num_layers=22,
            num_heads=32, num_kv_heads=4, vocab_size=32000, cache_mode=1,
            page_size=128, dtype="bfloat16")
# LLaMA-2-7B widths (bench.py:116-119) with int8 group-8 KV (:145-147)
LLAMA7B = dict(hidden_dim=4096, intermediate_dim=11008, num_layers=32,
               num_heads=32, num_kv_heads=32, vocab_size=32000, cache_mode=1,
               page_size=128, dtype="bfloat16", cache_quant_bit=8,
               cache_quant_group=8)
# Baichuan-13B widths (baichuan-inc/Baichuan-13B-Base config.json): 40
# layers, 40 heads (MHA), ALiBi; here with int8 group-8 KV
BAICHUAN13B = dict(hidden_dim=5120, intermediate_dim=13696, num_layers=40,
                   num_heads=40, num_kv_heads=40, vocab_size=64000,
                   norm_eps=1e-6, cache_mode=1, page_size=128,
                   dtype="bfloat16", cache_quant_bit=8, cache_quant_group=8,
                   model_type="baichuan", position_encoding="alibi")
# InternLM-7B widths (internlm/internlm-7b config.json): qkv/o biases
INTERNLM7B = dict(hidden_dim=4096, intermediate_dim=11008, num_layers=32,
                  num_heads=32, num_kv_heads=32, vocab_size=103168,
                  norm_eps=1e-6, cache_mode=1, page_size=128,
                  dtype="bfloat16", cache_quant_bit=8, cache_quant_group=8,
                  model_type="internlm", attn_bias=True)
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16 = 989e12            # dense tensor-core bf16 FLOP/s
PEAK_INT8 = 1979e12           # dense tensor-core int8 OP/s
PS = 128
KVP = 64                      # page-table width of the e2e plan (8192/128)
F32_TOL = 2e-5                # f32 attention atol and rtol, as the gpu tests
# f32 attention atol with ALiBi (the JAX package's ALiBi tolerance): the
# scores carry slope * k_pos, up to ~320 at 13B widths (f32 ulp ~3e-5)
ALIBI_F32_ATOL = 2e-4
BF16_TOL = 3e-2               # flat bf16 limit: holds the bf16 load/store path
# bf16 limit with ALiBi: the flat one plus a rounding of the output on
# either side (see attn_check)
ALIBI_BF16_TOL = f"{BF16_TOL}+2^-7|ref|"
W4_REL = 1e-5                 # K4 vs plain, of max|ref| (test_quant_w4.py)
PERTURB_SEEDS = 3             # draws of a sensitivity measure on the card
# draws of a sensitivity measure on the cpu (phase 4's step, prefix-hit,
# chunk and NLL checks; the accuracy harness's cpu scores): one, so that the
# no-argument run stays inside the chip call's time limit
CPU_PERTURB_SEEDS = 1
CARD = ["?"]                  # the card's name and power limit, once read


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*a):
    print(*a, flush=True)


def gpu_name_and_limit():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    check(out.returncode == 0, f"nvidia-smi failed: {out.stderr}")
    return out.stdout.strip().splitlines()[0]


# ------------------------------------------------------------------ timing

class Timer:
    """Per-launch CUDA-event timing of device time, with the L2 flushed
    before each launch (on the main path each layer's 40+ MB of weights
    pass through L2 between two calls of a kernel, so it finds its inputs
    cold)."""

    # ~3 ms of device spin before each timed launch: the host enqueues the
    # launch meanwhile, so the events bracket device time only, not the
    # wrapper's host-side latency
    SLEEP_CYCLES = 6_000_000

    def __init__(self, torch):
        self.torch = torch
        self.flush_buf = torch.empty(64 << 20, dtype=torch.uint8,
                                     device="cuda")

    def ms(self, fn, iters=10, warmup=2):
        torch = self.torch
        for _ in range(warmup):
            fn()
        torch.cuda.synchronize()
        starts = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        ends = [torch.cuda.Event(enable_timing=True) for _ in range(iters)]
        for i in range(iters):
            self.flush_buf.fill_(i & 0xFF)
            torch.cuda._sleep(self.SLEEP_CYCLES)
            starts[i].record()
            fn()
            ends[i].record()
        torch.cuda.synchronize()
        return float(np.mean([s.elapsed_time(e)
                              for s, e in zip(starts, ends)]))


def f32_excess(out, ref, atol=F32_TOL):
    """Largest |out - ref| / (atol + rtol * |ref|) at rtol = F32_TOL; the
    f32 case passes at 1 or less."""
    return float(((out - ref).abs() / (atol + F32_TOL * ref.abs())).max())


def report(kernel, c):
    """Log one phase-3 case as soon as it is measured."""
    lib = "n/a" if c["library_ms"] is None else f"{c['library_ms']:.4f}"
    splits = f", S={c['splits']}" if "splits" in c else ""
    if "ms_unsplit" in c:
        splits += (f" (unsplit {c['ms_unsplit']:.4f} ms; its counter "
                   f"memset alone {c['counter_memset_ms']:.4f} ms)")
    f32 = ("" if "f32_max_abs_err" not in c else
           f", f32 max|diff| {c['f32_max_abs_err']:.3g} (atol "
           f"{c['f32_tol']}, rtol {F32_TOL})")
    orient = c.get("orientation_int_mm_ms")
    if isinstance(orient, float):
        orient = f"{orient:.4f}"
    orient = ("" if orient is None else f", _int_mm on the unpacked weight "
              f"(orientation only) {orient} ms")
    log(f"[kernel] {kernel} {c['case']}{splits}: max|diff| "
        f"{c['max_abs_err']:.3g} "
        f"(tol {c['tol']}){f32}, kernel {c['ms']:.4f} ms, plain "
        f"{c['plain_ms']:.4f} ms, library {lib} ms{orient}, bound "
        f"{c['bound_ms']:.5f} ms ({c['bound_by']}) on {CARD[0]}")
    return c


def bound(bytes_moved, ops, peak_ops):
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak_ops * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations")


def tensor_core_check():
    """The tensor-core instructions in the SASS of the redesigned
    kernels: IMMA in both of K3's and both of K4's tiles, HMMA in K1's
    and K2's bf16 bodies."""
    from ppl.llm.serving_tpu_torch.ops.kernels import _build
    sass = {src: _build.sass_counts(src)
            for src in ("quant_matmul", "paged_attention")}
    for what, src, kernel, op in (
            ("K3 prefill tile", "quant_matmul", "i8i8_prefill_kernel", "IMMA"),
            ("K3 decode tile", "quant_matmul", "i8i8_decode_kernel", "IMMA"),
            ("K4 prefill tile", "quant_matmul", "w4a8_prefill_kernel", "IMMA"),
            ("K4 decode tile", "quant_matmul", "w4a8_decode_kernel", "IMMA"),
            ("K1 bf16 body", "paged_attention", "paged_decode_tc_kernel",
             "HMMA"),
            ("K1 f32 body (SIMT)", "paged_attention", "paged_decode_kernel",
             "HMMA"),
            ("K2 bf16 body", "paged_attention", "paged_prefill_tc_kernel",
             "HMMA"),
            ("K2 f32 body (SIMT)", "paged_attention", "paged_prefill_kernel",
             "HMMA")):
        fns = [c for fn, c in sass[src].items() if kernel in fn]
        n = sum(c[op] for c in fns)
        log(f"[build] {what}: {n} {op} instructions in {len(fns)} "
            f"instantiations (cuobjdump -sass)")
        if "SIMT" not in what:
            check(len(fns) > 0 and n > 0, f"{what}: no {op} in its SASS")


def bulk_copy_check():
    """The bulk asynchronous copy in K5's SASS: the cp.async.bulk that its
    kernel issues, which sm_90 runs as UBLKCP (the forms found are
    logged); a build that compiled the copy away fails."""
    from ppl.llm.serving_tpu_torch.ops.kernels import _build
    listing = _build.sass_listing("cache_read")
    fns = [c for fn, c in _build.parse_sass_counts(
        listing, ("UBLKCP",)).items() if "page_read_kernel" in fn]
    n = sum(c["UBLKCP"] for c in fns)
    forms = sorted(set(re.findall(r"\bUBLKCP(?:\.[A-Z0-9_]+)*", listing)))
    log(f"[build] K5 page read: {n} UBLKCP instructions "
        f"({', '.join(forms) or 'none'}) in {len(fns)} kernels "
        "(cuobjdump -sass)")
    if not n:
        ops = sorted(set(re.findall(
            r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)",
            listing)))
        log(f"[build] cache_read's SASS opcodes: {ops}")
    check(len(fns) == 1 and n > 0, "K5: no bulk copy (UBLKCP) in its SASS")


def launch_floor(torch, timer):
    """What :class:`Timer` reads around one launch that does no work
    (PyTorch's spin kernel for 0 cycles) and around no launch at all: a
    yardstick beside every kernel row, subtracted from none."""
    floor = dict(empty_launch_ms=timer.ms(lambda: torch.cuda._sleep(0),
                                          iters=50),
                 events_ms=timer.ms(lambda: None, iters=50))
    log(f"[kernel] launch floor: an empty launch "
        f"{floor['empty_launch_ms']:.4f} ms, the events alone "
        f"{floor['events_ms']:.4f} ms (the Timer: L2 flushed, device spin, "
        f"events around one launch, mean of 50) on {CARD[0]}")
    return floor


# ------------------------------------------------------------ kernel phases

def geometry(widths):
    hq, kvh = widths["num_heads"], widths["num_kv_heads"]
    return hq, kvh, widths["hidden_dim"] // hq, widths["num_layers"]


def random_cache(torch, kv_cache, spec, g):
    """A whole cache of random contents: N(0, 1) bf16 values, or N(0, 1)
    K/V quantized as the step quantizes them (int8 values and their bf16
    group scales), a slab of slots at a time."""
    dev = torch.device("cuda")
    kvh, n = spec.num_kv_heads, spec.num_layers * spec.num_slots
    if not spec.quantized:
        return torch.randn((kvh, n, spec.row_lanes), generator=g, device=dev,
                           dtype=torch.bfloat16), None
    cache, scale = kv_cache.init_cache(spec, dev)
    for r0 in range(0, n, 1 << 15):
        r1 = min(n, r0 + (1 << 15))
        k, v = torch.randn((2, r1 - r0, kvh, spec.head_dim), generator=g,
                           device=dev)
        qk, sk = kv_cache.quantize_kv(k, spec.quant_group)
        qv, sv = kv_cache.quantize_kv(v, spec.quant_group)
        cache[:, r0:r1] = kv_cache.pack_kv_rows(qk, qv, spec).permute(1, 0, 2)
        scale[r0:r1] = kv_cache.pack_scale_rows(sk, sv, spec)
    return cache, scale


def kv_bytes_per_token(spec):
    """Bytes one cached token occupies across the kv heads: its k|v rows
    and, under int8 KV, its bf16 group scales."""
    b = spec.num_kv_heads * 2 * spec.head_dim * (1 if spec.quantized else 2)
    if spec.quantized:
        b += spec.num_kv_heads * spec.scale_lane_stride * 2
    return b


def attn_check(name, out, ref, out32, ref32, alibi=False, rel=False):
    """bf16 within the flat limit; f32 within atol/rtol 2e-5, int8 KV
    too: the kernels dequantize int8 x bf16 scale exactly in f32, as the
    plain version does, so only the order of the softmax sums differs
    (tighter than the 1e-3/1e-2 the JAX package allows its bf16-dequant
    Pallas path, which would let a lost key of a 300-token row pass).
    With ALiBi the f32 atol is ``ALIBI_F32_ATOL``, and the bf16 limit
    ``ALIBI_BF16_TOL``: a head with a steep slope attends to its last few
    keys only, so its output is one v row, up to |4-8| at 13B widths,
    where one bf16 ulp is 0.031. ``rel`` takes that bf16 limit alone, for
    the cases added with tensor parallelism (one rank's LLaMA-2-70B
    shapes, GQA groups of 8 at head_dim 128), whose early prefill rows'
    outputs (a few v rows) also reach |4-8|; the f32 limit stays."""
    atol32 = ALIBI_F32_ATOL if alibi else F32_TOL
    diff = (out.float() - ref.float()).abs()
    err = float(diff.max())
    lim = BF16_TOL + (2.0 ** -7 * ref.float().abs() if alibi or rel
                      else 0.0)
    check(bool((diff <= lim).all()), f"{name}: max|diff| {err} beyond "
          f"{ALIBI_BF16_TOL if alibi or rel else BF16_TOL}")
    err32 = float((out32 - ref32).abs().max())
    check(f32_excess(out32, ref32, atol32) <= 1,
          f"{name} f32: max|diff| {err32} beyond atol {atol32} / rtol "
          f"{F32_TOL}")
    return err, err32


# K1 decode rows' contexts: [DECODE_CTX_LO, DECODE_CTX_HI) tokens
DECODE_CTX_LO, DECODE_CTX_HI = 100, 433


def decode_cases(torch, timer, pk, attn_ops, kv_cache, F, widths,
                 quantized, batches, label, rel=False):
    """K1 decode at batches ``batches``: each row's pages are its own, as
    in serving (no page read twice by one launch), so the pool holds
    every row's pages at the largest batch."""
    hq, kvh, hd, L = geometry(widths)
    pool = max(batches) * -(-DECODE_CTX_HI // PS)
    spec = kv_cache.CacheSpec(num_layers=L, num_pages=max(
                                  pool, 600 if not quantized else 64),
                              page_size=PS, num_kv_heads=kvh,
                              head_dim=hd, quant_bit=8 if quantized else 0,
                              quant_group=8 if quantized else 1,
                              dtype=torch.bfloat16)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    cache, scale = random_cache(torch, kv_cache, spec, g)
    rng = np.random.default_rng(SEED)
    cases = []
    for b in batches:
        ctx = rng.integers(DECODE_CTX_LO, DECODE_CTX_HI, b).astype(np.int32)
        ctx[rng.choice(b, max(1, b // 16), replace=False)] = 0  # padding
        pt = np.full((b, KVP), spec.trash_page, np.int32)
        free = iter(rng.permutation(spec.num_pages))
        for r in range(b):
            n_pages = -(-int(ctx[r]) // PS)
            pt[r, :n_pages] = [next(free) for _ in range(n_pages)]
        ctx_t = torch.from_numpy(ctx).to(dev)
        pt_t = torch.from_numpy(pt).to(dev)
        q = torch.randn((b, hq, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        fk = torch.randn((b, kvh, hd), generator=g, device=dev,
                         dtype=torch.bfloat16)
        fv = torch.randn((b, kvh, hd), generator=g, device=dev,
                         dtype=torch.bfloat16)
        layer = L - 1

        def kern(q=q, cache=cache, fk=fk, fv=fv, spec=spec, splits=None):
            return pk.paged_decode_attention(
                q, cache, scale, pt_t, ctx_t, spec, layer=layer, fresh_k=fk,
                fresh_v=fv, splits=splits)

        def plain(q=q, cache=cache, fk=fk, fv=fv, spec=spec):
            out = attn_ops.decode_attention_ref(
                q, cache, scale, pt_t, ctx_t, spec, layer=layer, fresh_k=fk,
                fresh_v=fv)
            return torch.where((ctx_t > 0)[:, None, None], out,
                               torch.zeros((), dtype=out.dtype, device=dev))

        out = kern()
        ref = plain()
        splits = decode_splits(torch, pk, b, kvh)
        # the same inputs in f32: bf16 rounding hides a lost key (a move of
        # about 1/ctx), the f32 limit does not
        f32 = dict(q=q.float(), fk=fk.float(), fv=fv.float(),
                   spec=dataclasses.replace(spec, dtype=torch.float32))
        if not quantized:
            f32["cache"] = cache.float()
        out32, ref32 = kern(**f32), plain(**f32)
        torch.cuda.synchronize()
        err, err32 = attn_check(f"K1 decode {label} B={b}", out, ref, out32,
                                ref32, rel=rel)
        del f32, out32, ref32
        # yardstick: SDPA over K/V gathered (and dequantized) beforehand
        lmax = int(ctx.max())
        k_d, v_d = kv_cache.gather_pages(cache, scale,
                                         pt_t[:, :-(-lmax // PS)], spec,
                                         torch.bfloat16, layer)
        k_d = k_d[:, :lmax].permute(0, 2, 1, 3).contiguous()
        v_d = v_d[:, :lmax].permute(0, 2, 1, 3).contiguous()
        mask = (torch.arange(lmax, device=dev)[None, :]
                < ctx_t[:, None])[:, None, None, :]
        q4 = q[:, :, None, :]

        def lib():
            return F.scaled_dot_product_attention(q4, k_d, v_d,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        live = ctx > 0
        n_live = int(live.sum())
        n_cached = int((ctx[live] - 1).sum())
        pages = int(sum(-(-(int(c) - 1) // PS) for c in ctx[live]))
        # q and fresh k/v of the live rows (a ctx 0 row writes zeros and
        # reads nothing), every output row, the cached k|v rows (and their
        # scales) and the page-table entries that hold them, context_len
        bytes_moved = ((n_live + b) * hq * hd * 2
                       + n_live * kvh * 2 * hd * 2
                       + n_cached * kv_bytes_per_token(spec)
                       + pages * 4 + b * 4)
        ops = 4 * hq * hd * (n_cached + n_live)
        bms, by = bound(bytes_moved, ops, PEAK_BF16)
        cases.append(report("paged_decode_attention", dict(
                          case=f"{label} B={b} bf16 ctx {int(ctx.min())}-"
                          f"{lmax}", path=label, max_abs_err=err,
                          splits=splits,
                          **split_costs(torch, timer, kern, splits, b, kvh),
                          tol=ALIBI_BF16_TOL if rel else BF16_TOL,
                          f32_max_abs_err=err32, f32_tol=F32_TOL,
                          ms=timer.ms(kern), plain_ms=timer.ms(plain, iters=5),
                          library_ms=timer.ms(lib, iters=5),
                          bound_ms=bms, bound_by=by)))
    return cases


def decode_splits(torch, pk, b, kvh):
    """The context splits S that K1's bf16 body runs at for this grid
    (the wrapper's own plan over the e2e page-table width)."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return pk.plan_decode_splits(b, kvh, KVP, sms)


def split_costs(torch, timer, kern, splits, b, kvh):
    """For a split K1 case: the same call unsplit (S = 1), and the zeroed
    arrival counters alone (the memset the split needs)."""
    if splits == 1:
        return {}
    return dict(ms_unsplit=timer.ms(lambda: kern(splits=1)),
                counter_memset_ms=timer.ms(lambda: torch.zeros(
                    b * kvh, dtype=torch.int32, device="cuda")))


def alibi_mask(torch, mask, slopes, k_pos, dtype):
    """The library yardstick's attention mask: ``mask`` [B, 1, Q, K]
    itself, or with ALiBi the float mask slope * k_pos where ``mask``
    holds and -inf elsewhere, [B, Hq, Q, K]."""
    if slopes is None:
        return mask
    bias = slopes[None, :, None, None] * k_pos.float()
    return torch.where(mask, bias, float("-inf")).to(dtype)


def tail_cases(torch, timer, pk, attn_ops, kv_cache, F, widths, quantized,
               tail_lens, label, alibi=False):
    """K1 on B=8 rows, contexts 0-383: in block-tail mode, with a side
    buffer of J=8 rows per (layer, row, head), ``tail_len`` of them live,
    or (``tail_len`` None) in plain deferred mode; with ``alibi`` the
    model's ALiBi slopes go in."""
    hq, kvh, hd, L = geometry(widths)
    b, jt = 8, 8
    spec = kv_cache.CacheSpec(num_layers=L, num_pages=64, page_size=PS,
                              num_kv_heads=kvh, head_dim=hd,
                              quant_bit=8 if quantized else 0,
                              quant_group=8 if quantized else 1,
                              dtype=torch.bfloat16)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 7)
    cache, scale = random_cache(torch, kv_cache, spec, g)
    # the side buffer: random K/V rows packed (and quantized) as the step
    # packs them
    k, v = torch.randn((2, L * b * jt, kvh, hd), generator=g, device=dev)
    if quantized:
        qk, sk = kv_cache.quantize_kv(k, spec.quant_group)
        qv, sv = kv_cache.quantize_kv(v, spec.quant_group)
        rows = kv_cache.pack_kv_rows(qk, qv, spec)
        tscale = kv_cache.pack_scale_rows(sk, sv, spec).reshape(
            L, b, jt, spec.scale_lanes).contiguous()
    else:
        rows = kv_cache.pack_kv_rows(k, v, spec).to(torch.bfloat16)
        tscale = None
    tkv = rows.reshape(L, b, jt, kvh, spec.row_lanes).permute(
        0, 1, 3, 2, 4).contiguous()
    del k, v, rows
    slopes = attn_ops.alibi_slopes(hq).to(dev) if alibi else None
    rng = np.random.default_rng(SEED + 7)
    layer = L - 1
    cases = []
    for tl in tail_lens:
        t = tl or 0                               # live tail rows
        ctx = rng.integers(0, 384, b).astype(np.int32)
        ctx[rng.choice(b, 1)] = 0                     # a padding row
        n_cached = np.maximum(ctx - 1 - t, 0)
        pt = np.full((b, KVP), spec.trash_page, np.int32)
        for r in range(b):
            n_pages = -(-int(n_cached[r]) // PS)
            pt[r, :n_pages] = rng.choice(spec.num_pages, n_pages,
                                         replace=False)
        ctx_t = torch.from_numpy(ctx).to(dev)
        pt_t = torch.from_numpy(pt).to(dev)
        tlen = torch.full((1,), t, dtype=torch.int32, device=dev)
        q = torch.randn((b, hq, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        fk = torch.randn((b, kvh, hd), generator=g, device=dev,
                         dtype=torch.bfloat16)
        fv = torch.randn((b, kvh, hd), generator=g, device=dev,
                         dtype=torch.bfloat16)

        def tail_kw(tkv):
            return ({} if tl is None else
                    dict(tail_kv=tkv, tail_scale=tscale, tail_len=tlen))

        def kern(q=q, cache=cache, fk=fk, fv=fv, tkv=tkv, spec=spec):
            return pk.paged_decode_attention(
                q, cache, scale, pt_t, ctx_t, spec, layer=layer, fresh_k=fk,
                fresh_v=fv, alibi=slopes, **tail_kw(tkv))

        def plain(q=q, cache=cache, fk=fk, fv=fv, tkv=tkv, spec=spec):
            out = attn_ops.decode_attention_ref(
                q, cache, scale, pt_t, ctx_t, spec, layer=layer, fresh_k=fk,
                fresh_v=fv, alibi=slopes, **tail_kw(tkv))
            return torch.where((ctx_t > 0)[:, None, None], out,
                               torch.zeros((), dtype=out.dtype, device=dev))

        out = kern()
        ref = plain()
        f32 = dict(q=q.float(), fk=fk.float(), fv=fv.float(),
                   spec=dataclasses.replace(spec, dtype=torch.float32))
        if not quantized:
            f32.update(cache=cache.float(), tkv=tkv.float())
        out32, ref32 = kern(**f32), plain(**f32)
        torch.cuda.synchronize()
        mode = "deferred" if tl is None else f"tail_len={tl}"
        err, err32 = attn_check(f"K1 {label} {mode}", out, ref, out32, ref32,
                                alibi)
        del f32, out32, ref32
        # yardstick: SDPA over the cache gathered (and dequantized)
        # beforehand, the live tail rows and the self-term, concatenated
        lmax = max(int(n_cached.max()), 1)
        k_c, v_c = kv_cache.gather_pages(cache, scale,
                                         pt_t[:, :-(-lmax // PS)], spec,
                                         torch.bfloat16, layer)
        n_c_t = torch.from_numpy(n_cached).to(dev)[:, None]
        ks, vs = [k_c[:, :lmax]], [v_c[:, :lmax]]
        mask = [torch.arange(lmax, device=dev)[None, :] < n_c_t]
        k_pos = [torch.arange(lmax, device=dev)[None, :].expand(b, lmax)]
        if tl is not None:
            k_t, v_t = attn_ops._tail_rows(
                tkv[layer], None if tscale is None else tscale[layer], spec,
                torch.bfloat16)
            ks.append(k_t)
            vs.append(v_t)
            mask.append((torch.arange(jt, device=dev) < tl)[None, :]
                        .expand(b, jt))
            k_pos.append(n_c_t + torch.arange(jt, device=dev)[None, :])
        k_all = torch.cat(ks + [fk[:, None]], 1).permute(0, 2, 1, 3)
        v_all = torch.cat(vs + [fv[:, None]], 1).permute(0, 2, 1, 3)
        k_all, v_all = k_all.contiguous(), v_all.contiguous()
        mask = torch.cat(mask + [torch.ones((b, 1), dtype=torch.bool,
                                            device=dev)], 1)
        k_pos = torch.cat(k_pos + [n_c_t + t], 1)
        mask = alibi_mask(torch, mask[:, None, None, :], slopes,
                          k_pos[:, None, None, :], torch.bfloat16)
        q4 = q[:, :, None, :]

        def lib():
            return F.scaled_dot_product_attention(q4, k_all, v_all,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        live = ctx > 0
        n_live = int(live.sum())
        n_c = int(n_cached[live].sum())
        pages = int(sum(-(-int(n) // PS) for n in n_cached[live]))
        keys = n_c + n_live * (min(t, jt) + 1)
        # q and fresh k/v of the live rows, every output row, the cached
        # rows walked (and their scales) with their page-table entries,
        # this layer's live tail rows (and scale rows), context_len,
        # tail_len and (ALiBi) the slopes
        bytes_moved = ((n_live + b) * hq * hd * 2
                       + n_live * kvh * 2 * hd * 2
                       + (n_c + n_live * min(t, jt))
                       * kv_bytes_per_token(spec)
                       + pages * 4 + b * 4 + (4 if tl is not None else 0)
                       + (hq * 4 if alibi else 0))
        # a q.k and a p.v product per key and head, and (ALiBi) one
        # multiply-add of the bias
        ops = (4 * hd + (2 if alibi else 0)) * hq * keys
        bms, by = bound(bytes_moved, ops, PEAK_BF16)
        case = (f"{label} deferred B={b}" if tl is None else
                f"{label} tail B={b} J={jt} tail_len={tl}")
        cases.append(report("paged_decode_attention", dict(
            case=f"{case} bf16 ctx {int(ctx.min())}-{int(ctx.max())}",
            path=label, max_abs_err=err,
            splits=decode_splits(torch, pk, b, kvh),
            tol=ALIBI_BF16_TOL if alibi else BF16_TOL, f32_max_abs_err=err32,
            f32_tol=ALIBI_F32_ATOL if alibi else F32_TOL, ms=timer.ms(kern),
            plain_ms=timer.ms(plain, iters=5),
            library_ms=timer.ms(lib, iters=5), bound_ms=bms, bound_by=by)))
    return cases


def prefill_cases(torch, timer, pk, attn_ops, kv_cache, F, widths,
                  quantized, which, label, alibi=False, nll=False,
                  rel=False):
    """K2 at the serving shapes (the first ``which`` of them), or with
    ``nll`` at the NLL forward's one: one row of 1,024 tokens at start 0
    (make_nll_fn's prefill row, eval_ppl's default --seq-len), whose
    yardstick is SDPA with ``is_causal``."""
    hq, kvh, hd, L = geometry(widths)
    spec = kv_cache.CacheSpec(num_layers=L, num_pages=200 if not quantized
                              else 64, page_size=PS, num_kv_heads=kvh,
                              head_dim=hd, quant_bit=8 if quantized else 0,
                              quant_group=8 if quantized else 1,
                              dtype=torch.bfloat16)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    cache, scale = random_cache(torch, kv_cache, spec, g)
    slopes = attn_ops.alibi_slopes(hq).to(dev) if alibi else None
    rng = np.random.default_rng(SEED + 1)
    # (label, Bp, Qp, start, new_len): the e2e prefill wave; a prefix hit
    # of 2 pages; the full-hit replay row (start = hit - 1, new_len = 1);
    # the server path's prefix hit (one row a step, 8 pages, a 192-token
    # tail)
    specs = [("start=0", 8, 512, np.zeros(8, np.int32),
              rng.integers(100, 401, 8).astype(np.int32)),
             ("start=2 pages", 8, 256, np.full(8, 2 * PS, np.int32),
              rng.integers(100, 257, 8).astype(np.int32)),
             ("replay row", 1, 128, np.array([2 * PS - 1], np.int32),
              np.array([1], np.int32)),
             ("start=8 pages served", 1, 192, np.array([8 * PS], np.int32),
              np.array([192], np.int32))][:which]
    if nll:
        specs = [("nll row start=0", 1, 1024, np.zeros(1, np.int32),
                  np.array([1024], np.int32))]
    cases = []
    for plabel, bp, qp, start, new_len in specs:
        width = -(-int((start + qp).max()) // PS)   # pages the rows span
        pt = np.stack([rng.choice(spec.num_pages, width, replace=False)
                       for _ in range(bp)]).astype(np.int32)
        pt_t = torch.from_numpy(pt).to(dev)
        st = torch.from_numpy(start).to(dev)
        nl = torch.from_numpy(new_len).to(dev)
        q = torch.randn((bp, qp, hq, hd), generator=g, device=dev,
                        dtype=torch.bfloat16)
        k_new = torch.randn((bp, qp, kvh, hd), generator=g, device=dev)
        v_new = torch.randn((bp, qp, kvh, hd), generator=g, device=dev)
        fscale = None
        if quantized:
            qk, sk = kv_cache.quantize_kv(k_new, 8)
            qv, sv = kv_cache.quantize_kv(v_new, 8)
            fresh = kv_cache.pack_kv_rows(qk, qv, spec)
            fscale = kv_cache.pack_scale_rows(sk, sv, spec).contiguous()
            fk = kv_cache.dequantize_kv(qk, sk, 8, torch.float32)
            fv = kv_cache.dequantize_kv(qv, sv, 8, torch.float32)
        else:
            fresh = kv_cache.pack_kv_rows(k_new, v_new, spec).to(
                torch.bfloat16)
            fk, fv = k_new.to(torch.bfloat16), v_new.to(torch.bfloat16)
        fresh = fresh.permute(0, 2, 1, 3).contiguous()
        layer = L - 1

        def kern(q=q, cache=cache, fresh=fresh, spec=spec):
            return pk.paged_prefill_attention(
                q, cache, scale, pt_t, st, nl, spec, layer=layer,
                fresh_kv=fresh, fresh_scale=fscale, alibi=slopes)

        def plain(q=q, cache=cache, fresh=fresh, spec=spec):
            return attn_ops.prefill_attention_ref(
                q, cache, scale, pt_t, st, nl, spec, layer=layer,
                fresh_k=fk.to(q.dtype), fresh_v=fv.to(q.dtype),
                alibi=slopes)

        out = kern()
        ref = plain()
        f32 = dict(q=q.float(), spec=dataclasses.replace(
            spec, dtype=torch.float32))
        if not quantized:
            f32.update(cache=cache.float(), fresh=fresh.float())
        out32, ref32 = kern(**f32), plain(**f32)
        torch.cuda.synchronize()
        err, err32 = attn_check(f"K2 prefill {label} {plabel}", out, ref,
                                out32, ref32, alibi, rel)
        del f32, out32, ref32
        # yardstick: SDPA over the dense prefix + fresh K/V with the
        # prefill mask
        s0 = int(start[0])
        fk_b, fv_b = fk.to(torch.bfloat16), fv.to(torch.bfloat16)
        if s0:
            k_c, v_c = kv_cache.gather_pages(cache, scale, pt_t, spec,
                                             torch.bfloat16, layer)
            k_all = torch.cat([k_c[:, :s0], fk_b], 1)
            v_all = torch.cat([v_c[:, :s0], fv_b], 1)
        else:
            k_all, v_all = fk_b, fv_b
        k_all = k_all.permute(0, 2, 1, 3).contiguous()
        v_all = v_all.permute(0, 2, 1, 3).contiguous()
        q4 = q.permute(0, 2, 1, 3).contiguous()
        kv_len = k_all.shape[2]
        mask = (torch.arange(kv_len, device=dev)[None, None, :]
                <= (s0 + torch.arange(qp, device=dev))[None, :, None])
        mask = alibi_mask(torch, mask[:, None], slopes,
                          torch.arange(kv_len, device=dev), torch.bfloat16)

        def lib():
            if nll:
                return F.scaled_dot_product_attention(q4, k_all, v_all,
                                                      is_causal=True,
                                                      enable_gqa=True)
            return F.scaled_dot_product_attention(q4, k_all, v_all,
                                                  attn_mask=mask,
                                                  enable_gqa=True)

        valid_q = int(new_len.sum())
        # keys each valid query row sees: start + i + 1
        keys = int(sum(int(s) * int(n) + int(n) * (int(n) + 1) // 2
                       for s, n in zip(start, new_len)))
        cached_read = int(start.sum())
        pages = int(sum(-(-int(s) // PS) for s in start))
        # q and fresh k|v (and scales) of the valid rows only (a row past
        # new_len writes zeros and is never attended), every output row,
        # the cached prefix and the page-table entries that hold it,
        # start, new_len, (ALiBi) the slopes
        bytes_moved = ((valid_q + bp * qp) * hq * hd * 2
                       + (valid_q + cached_read) * kv_bytes_per_token(spec)
                       + pages * 4 + 2 * bp * 4 + (hq * 4 if alibi else 0))
        ops = (4 * hd + (2 if alibi else 0)) * hq * keys
        bms, by = bound(bytes_moved, ops, PEAK_BF16)
        cases.append(report("paged_prefill_attention", dict(
                          case=f"{label} {plabel} Bp={bp} Qp={qp} new_len "
                          f"{int(new_len.min())}-{int(new_len.max())} "
                          f"({valid_q} rows) bf16", path=label,
                          max_abs_err=err,
                          tol=ALIBI_BF16_TOL if alibi or rel else BF16_TOL,
                          f32_max_abs_err=err32,
                          f32_tol=ALIBI_F32_ATOL if alibi else F32_TOL,
                          ms=timer.ms(kern), plain_ms=timer.ms(plain, iters=5),
                          library_ms=timer.ms(lib, iters=5),
                          bound_ms=bms, bound_by=by)))
    return cases


def i8i8_cases(torch, timer, qk, quant_ops, cfg, label, ts=(8, 1024),
               weights=None):
    """K3 at the widths of ``cfg`` (or at ``weights``, [(name, float
    shape)]): each weight at each T of ``ts`` (decode sizes, T=8 and up to
    the 64-row decode bucket; prefill sizes, T=1024, and 4,096 for the 13B
    prefill step), bf16 out, exact up to one bf16 rounding; f32 out equal
    to the plain version bit for bit; two runs equal bit for bit. Each row
    names the tile ``k3_tile`` routes it to and, on the decode tile, its
    split-K pieces S."""
    d, inter = cfg["hidden_dim"], cfg["intermediate_dim"]
    hq, kvh = cfg["num_heads"], cfg["num_kv_heads"]
    hd = d // hq
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    weights = weights or [("wqkv", (d, kvh, hq // kvh + 2, hd)),
                          ("wo", (d, d)), ("gate|up", (d, 2, inter)),
                          ("down", (inter, d))]
    cases = []
    for name, shape in weights:
        w = torch.randn(shape, generator=g, device=dev) * shape[0] ** -0.5
        wq, ws = quant_ops.quantize_weight(w)
        if wq.ndim == 3:                       # fused: C-leading [2, D, I]
            wq = wq.permute(1, 0, 2).contiguous()
        if wq.ndim == 3:
            c, k_dim, n = wq.shape
        else:
            c, k_dim = 1, wq.shape[0]
            n = wq.numel() // k_dim
        del w
        # the library yardstick multiplies the same int8 operands as one
        # [D, C*N] matrix, column-major as cuBLASLt's int8 path wants
        w2 = (wq.permute(1, 0, 2).reshape(k_dim, c * n) if wq.ndim == 3
              else wq.reshape(k_dim, n))
        w2_cm = w2.t().contiguous().t()
        for t in ts:
            x = torch.randn((t, k_dim), generator=g, device=dev,
                            dtype=torch.bfloat16)

            def kern():
                return qk.i8i8_matmul(x, wq, ws, out_dtype=torch.bfloat16)

            def plain():
                return quant_ops.i8i8_matmul(x, wq, ws).to(torch.bfloat16)

            out = kern()
            ref = plain()
            torch.cuda.synchronize()
            err = float((out.float() - ref.float()).abs().max())
            tol = float(ref.float().abs().max()) * 2.0 ** -8
            check(err <= tol,
                  f"K3 {label} {name} T={t}: max|diff| {err} > {tol}")
            again = kern()
            out32 = qk.i8i8_matmul(x.float(), wq, ws)
            ref32 = quant_ops.i8i8_matmul(x.float(), wq, ws)
            torch.cuda.synchronize()
            check(torch.equal(out.view(torch.int16), again.view(torch.int16)),
                  f"K3 {label} {name} T={t}: two runs differ")
            check(torch.equal(out32, ref32),
                  f"K3 {label} {name} T={t} f32: max|diff| "
                  f"{float((out32 - ref32).abs().max())}, not exact")
            del again, out32, ref32
            xq, _ = quant_ops.quantize_activation(x)
            rows = max(t, 32)   # _int_mm needs more than 16 rows
            xq_lib = torch.zeros((rows, k_dim), dtype=torch.int8,
                                 device=dev)
            xq_lib[:t] = xq
            lib_ms, lib_note = None, ""
            try:
                torch._int_mm(xq_lib, w2_cm)

                def lib():
                    return torch._int_mm(xq_lib, w2_cm)

                lib_ms = timer.ms(lib, iters=5)
                if rows != t:
                    lib_note = f" (_int_mm on {rows} rows)"
            except RuntimeError as e:
                lib_note = f" (_int_mm unavailable: {str(e)[:80]})"
            bytes_moved = (x.numel() * 2 + wq.numel() + ws.numel() * 4
                           + c * t * n * 2)
            ops = 2 * t * k_dim * c * n
            bms, by = bound(bytes_moved, ops, PEAK_INT8)
            tile = qk.k3_tile(t, n)
            pieces = {} if tile == "prefill" else {"splits": qk.plan_split_k(
                t, k_dim, n, c, torch.cuda.get_device_properties(
                    dev).multi_processor_count)[0]}
            cases.append(report("i8i8_matmul", dict(
                case=f"{label} {name} T={t} D={k_dim} N={c}x{n} bf16, "
                f"{tile} tile{lib_note}", path=label, tile=tile,
                max_abs_err=err, tol=tol, ms=timer.ms(kern),
                plain_ms=timer.ms(plain, iters=5), library_ms=lib_ms,
                bound_ms=bms, bound_by=by, **pieces)))
        del wq, ws, w2, w2_cm
        torch.cuda.empty_cache()
    return cases


# K5's time a launch in its first design (one CTA a head, its page pulled
# through registers; PERF.md's kernel table, NVIDIA H100 80GB HBM3, 700 W)
K5_EARLIER_MS = 0.0093


def page_read_cases(torch, timer, cache_read, floor):
    """K5 against its plain version, exact, with its chunk plan: at the
    microbench's geometry (LLaMA-2-7B int8 cache, 128 pages) reading 8
    rows and all PS rows (every chunk converts), and at Baichuan-13B's 40
    KV heads, whose page is no whole number of the plan's chunks (25 of 5
    rows, a last of 3)."""
    from ppl.llm.serving_tpu_torch.tools import microbench_scatter_7b as mb
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 8)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    big = torch.randint(-128, 128, (mb.KVH, mb.L * (mb.NPAGES + 1) * mb.PS,
                                    mb.R), generator=g, device=dev,
                        dtype=torch.int8)
    small = torch.randint(-128, 128, (40, 3 * mb.PS, mb.R), generator=g,
                          device=dev, dtype=torch.int8)
    cases = []
    for cache, rows, what in ((big, 8, "microbench 7B int8 cache"),
                              (big, mb.PS, "microbench 7B, rows = PS,"),
                              (small, 8, "13B's 40 kv heads")):
        kvh, _, r = cache.shape
        chunk_rows, n_chunks = cache_read.plan_page_read(kvh, mb.PS, r, sms)

        def kern(cache=cache, rows=rows):
            return cache_read.page_read(cache, rows=rows, page_size=mb.PS)

        def plain(cache=cache, rows=rows):
            return cache_read.page_read_ref(cache, rows)

        out, ref = kern(), plain()
        torch.cuda.synchronize()
        check(torch.equal(out, ref), f"K5 page read ({what}, rows {rows}) "
              "differs from its plain version: max|diff| "
              f"{float((out - ref).abs().max())}")
        # every head's page read once, the f32 rows written once
        bytes_moved = kvh * mb.PS * r + kvh * rows * r * 4
        bms, by = bound(bytes_moved, 0, PEAK_BF16)
        cases.append(report("page_read", dict(
            case=f"{what} {tuple(cache.shape)} page {mb.PS} rows -> f32 "
            f"[{kvh}, {rows}, {r}], {n_chunks} chunks of {chunk_rows} rows "
            f"a head ({kvh * n_chunks} CTAs)", path="microbench",
            chunks=n_chunks, chunk_rows=chunk_rows,
            max_abs_err=0.0, tol="exact", ms=timer.ms(kern),
            plain_ms=timer.ms(plain, iters=5),
            library_ms=timer.ms(lambda cache=cache, rows=rows:
                                cache[:, :rows].float(), iters=5),
            bound_ms=bms, bound_by=by)))
    c = cases[0]
    log(f"[kernel] page_read at the microbench: {c['ms']:.4f} ms with one "
        f"bulk copy a chunk over {mb.KVH * c['chunks']} CTAs; "
        f"{K5_EARLIER_MS} ms in the first design (one CTA a head); launch "
        f"floor {floor['empty_launch_ms']:.4f} ms, bound "
        f"{c['bound_ms']:.5f} ms, on {CARD[0]}")
    del big, small
    torch.cuda.empty_cache()
    return cases


def w4a8_cases(torch, timer, qk, quant_ops):
    """K4 at the LLaMA-2-7B widths: each weight at decode (T=1, 8, 16)
    and prefill (T=1024, and 4,096 for gate|up: the 7B prefill step)
    sizes, with bf16 and f32 out. f32 holds 1e-5 of max|ref| (the groups'
    partial sums are added in another order); bf16 2^-8 |ref| + 1e-5
    max|ref| per element (one bf16 rounding more). Where the decode tile
    cuts K into S > 1 pieces, two runs must give the same bits."""
    d, inter = LLAMA7B["hidden_dim"], LLAMA7B["intermediate_dim"]
    hq, kvh, hd, _ = geometry(LLAMA7B)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    weights = [("wqkv", (d, kvh, hq // kvh + 2, hd)), ("wo", (d, d)),
               ("gate|up", (d, 2, inter)), ("down", (inter, d)),
               ("lm_head", (d, LLAMA7B["vocab_size"]))]
    cases = []
    for name, shape in weights:
        w = torch.randn(shape, generator=g, device=dev) * shape[0] ** -0.5
        wp, ws = quant_ops.quantize_weight_int4(w)
        del w
        if wp.ndim == 3:                       # fused: C-leading
            wp = wp.permute(1, 0, 2).contiguous()
            ws = ws.permute(1, 0, 2).contiguous()
            c, d2, n = wp.shape
            groups = ws.shape[1]
        else:
            c, d2 = 1, wp.shape[0]
            n = wp.numel() // d2
            groups = ws.shape[0]
        k_dim = 2 * d2
        # orientation only: torch._int_mm on the unpacked int8 weight
        # [D, C*N], column-major as cuBLASLt's int8 path wants
        wu = (quant_ops.unpack_int4(wp.permute(1, 0, 2).reshape(d2, c * n))
              if wp.ndim == 3 else quant_ops.unpack_int4(wp.reshape(d2, n)))
        wu_cm = wu.t().contiguous().t()
        del wu
        for t in (1, 8, 16, 1024) + ((4096,) if name == "gate|up" else ()):
            x = torch.randn((t, k_dim), generator=g, device=dev,
                            dtype=torch.bfloat16)
            ref = quant_ops.w4a8_matmul(x, wp, ws)
            scale = float(ref.abs().max())
            splits, _ = qk.plan_split_k_w4(t, d2, n, c, sms, k_dim // groups)
            xq, _ = quant_ops.quantize_activation(x)
            rows = max(t, 32)   # _int_mm needs more than 16 rows
            xq_lib = torch.zeros((rows, k_dim), dtype=torch.int8, device=dev)
            xq_lib[:t] = xq
            try:
                torch._int_mm(xq_lib, wu_cm)
                orient = timer.ms(lambda: torch._int_mm(xq_lib, wu_cm),
                                  iters=5)
            except RuntimeError as e:
                orient = f"unavailable: {str(e)[:60]}"
            for out_dtype in (torch.bfloat16, torch.float32):
                def kern(out_dtype=out_dtype):
                    return qk.w4a8_matmul(x, wp, ws, out_dtype=out_dtype)

                def plain(out_dtype=out_dtype):
                    return quant_ops.w4a8_matmul(x, wp, ws).to(out_dtype)

                out, again = kern(), kern()
                torch.cuda.synchronize()
                bf = out_dtype == torch.bfloat16
                if splits > 1:
                    bits = torch.int16 if bf else torch.int32
                    check(torch.equal(out.view(bits), again.view(bits)),
                          f"K4 {name} T={t} S={splits}: two runs differ")
                out = out.float()
                diff = (out - ref).abs()
                err = float(diff.max())
                lim = W4_REL * scale + (2.0 ** -8 * ref.abs() if bf else 0.0)
                check(bool((diff <= lim).all()),
                      f"K4 {name} T={t} {'bf16' if bf else 'f32'}: max|diff| "
                      f"{err} beyond {'2^-8 |ref| + ' if bf else ''}"
                      f"{W4_REL:g} * max|ref| ({scale:.4g})")
                del out, again, diff
                osz = 2 if bf else 4
                bytes_moved = (k_dim * c * n // 2 + c * groups * n * 4
                               + t * k_dim * 2 + c * t * n * osz)
                ops = 2 * t * k_dim * c * n
                bms, by = bound(bytes_moved, ops, PEAK_INT8)
                cases.append(report("w4a8_matmul", dict(
                    case=f"{name} T={t} D={k_dim} N={c}x{n} G={groups} "
                    f"{'bf16' if bf else 'f32'} out", path="llama2-7b w4a8",
                    max_abs_err=err, rel_err=err / scale,
                    tol=f"{'2^-8|ref|+' if bf else ''}{W4_REL:g}*max|ref|",
                    ms=timer.ms(kern), plain_ms=timer.ms(plain, iters=5),
                    library_ms=None, orientation_int_mm_ms=orient,
                    bound_ms=bms, bound_by=by,
                    **({"splits": splits}
                       if t <= qk.W4_DECODE_MAX_T else {}))))
            del ref, xq_lib
        del wp, ws, wu_cm
        torch.cuda.empty_cache()
    return cases


# ------------------------------------------------------- step cross-check

class perturbed_attention:
    """Within the block, the attention wrappers' outputs are multiplied by
    (1 + eps * N(0, 1)) in f32, the noise drawn on ``gen``'s device: a
    stand-in for the kernels' different summation order, to measure how
    far that alone moves the logits."""

    def __init__(self, torch, pk, eps, gen):
        self.torch, self.pk, self.eps, self.gen = torch, pk, eps, gen

    def __enter__(self):
        self.saved = (self.pk.paged_decode_attention,
                      self.pk.paged_prefill_attention)

        def wrap(fn):
            def run(*a, **k):
                out = fn(*a, **k)
                noise = self.torch.randn(out.shape, generator=self.gen,
                                         device=self.gen.device)
                return (out.float() * (1 + self.eps * noise)).to(out.dtype)
            # a CUDA wrapper counts its launches on the module's attribute,
            # which is this one meanwhile
            run.__dict__.update(fn.__dict__)
            return run

        self.pk.paged_decode_attention = wrap(self.saved[0])
        self.pk.paged_prefill_attention = wrap(self.saved[1])
        return self

    def __exit__(self, *exc):
        for fn, name in zip(self.saved, ("paged_decode_attention",
                                         "paged_prefill_attention")):
            fn.__dict__.update(getattr(self.pk, name).__dict__)
            setattr(self.pk, name, fn)
        return False


def dequantized(cache, scale, spec):
    """The cache as f32 values: itself, or int8 x its group scales."""
    if scale is None:
        return cache
    kvh, n, _ = cache.shape
    g = spec.scale_groups
    s = scale[:, :kvh * 2 * g].float().reshape(n, kvh, 2 * g)
    s = s.permute(1, 0, 2).repeat_interleave(spec.quant_group, dim=-1)
    return cache.float() * s


def step_cross_check(torch, port, quant_method, widths):
    """One mixed step, f32, the same weights on cuda (kernels) and cpu
    (plain versions); quantized weights are quantized once, on the card,
    and the same bytes copied to the cpu. Tolerance on the logits: for
    float weights 1e-4 of the largest logit (f32 summation order over two
    layers); for quantized weights three times the largest move that a
    1e-6 relative perturbation of the attention outputs causes on the cpu
    over CPU_PERTURB_SEEDS draws, measured here: any difference upstream of an
    int8 activation (or int8 KV) quantization flips some roundings, and
    each flip moves a logit by about one quantization step. The written
    cache rows (dequantized under int8 KV) are held the same way."""
    llama, kv, samp = port["llama"], port["kv"], port["samp"]
    ModelConfig = port["ModelConfig"]
    cfg = ModelConfig(**dict(widths, num_layers=2, dtype="float32"))
    npages = 24
    spec = kv.CacheSpec(num_layers=2, num_pages=npages, page_size=PS,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        quant_bit=cfg.cache_quant_bit,
                        quant_group=cfg.cache_quant_group,
                        dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    p_gpu = llama.init_params(cfg, gen, dtype=torch.float32, device="cuda")
    if quant_method != "none":
        p_gpu = llama.quantize_model_params(
            p_gpu, quant_method,
            quantize_lm_head=quant_method == "online_w4a8")

    p_cpu = params_to_cpu(p_gpu)
    rng = np.random.default_rng(SEED + 3)
    shape = (spec.num_kv_heads, 2 * spec.num_slots, spec.row_lanes)
    if spec.quantized:
        cache0 = torch.from_numpy(rng.integers(-127, 128, shape).astype(
            np.int8))
        scale0 = torch.from_numpy(rng.uniform(
            0.005, 0.03, (shape[1], spec.scale_lanes)).astype(
                np.float32)).to(torch.bfloat16)
    else:
        cache0 = torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32))
        scale0 = None
    # decode rows: 3 live + 1 padding; prefill rows: a fresh 200-token
    # prompt and a 100-token continuation after a 1-page prefix hit
    bd, bp, qp, kvp = 4, 2, 256, 4
    b = bd + bp
    pt = np.full((b, kvp), npages, np.int32)
    pt[0, :2], pt[1, :1], pt[2, :4] = [0, 1], [2], [3, 4, 5, 6]
    pt[4, :2], pt[5, :2] = [7, 8], [9, 10]
    f = dict(decode_tokens=rng.integers(3, cfg.vocab_size, bd),
             decode_pos=np.array([129, 40, 400, 0]),
             prefill_tokens=rng.integers(3, cfg.vocab_size, (bp, qp)),
             prefill_start=np.array([0, PS]),
             prefill_len=np.array([200, 100]), page_table=pt,
             context_len=np.array([130, 41, 401, 0, 200, PS + 100]),
             batch_slots=np.zeros(b))
    live = np.array([True, True, True, False, True, True])

    def make_input(dev):
        t = {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
             for k, v in f.items()}
        ones = torch.ones(b, device=dev)
        zeros = torch.zeros(b, device=dev)
        sp = samp.SamplingParams(ones, torch.ones(b, dtype=torch.int32,
                                                  device=dev), zeros,
                                 torch.zeros(b, dtype=torch.bool,
                                             device=dev), ones, zeros, zeros)
        return llama.StepInput(sampling=sp, **t)

    step = llama.make_step_fn(cfg, spec, return_logits=True,
                              quant_method=quant_method, greedy_only=True)

    def clone(x, dev="cpu"):
        return None if x is None else x.to(dev, copy=True)

    c_gpu, s_gpu = cache0.cuda(), clone(scale0, "cuda")
    out_g = step(p_gpu, c_gpu, s_gpu,
                 torch.zeros((1, 1), dtype=torch.int32, device="cuda"),
                 make_input("cuda"))
    torch.cuda.synchronize()
    c_cpu, s_cpu = cache0.clone(), clone(scale0)
    cm_cpu = torch.zeros((1, 1), dtype=torch.int32)
    out_c = step(p_cpu, c_cpu, s_cpu, cm_cpu, make_input("cpu"))
    lc = out_c.logits.numpy()[live]
    v_cpu = dequantized(c_cpu, s_cpu, spec)
    # every slot but the trash page's, whose padding writes race
    keep = torch.ones(2 * spec.num_slots, dtype=torch.bool)
    for layer in range(2):
        lo = layer * spec.num_slots + spec.trash_page * PS
        keep[lo:lo + PS] = False
    quantized = quant_method != "none" or spec.quantized
    sens, cache_sens = [], []
    for seed in (range(CPU_PERTURB_SEEDS) if quantized else ()):
        c_p, s_p = cache0.clone(), clone(scale0)
        with perturbed_attention(torch, port["pk"], 1e-6,
                                 torch.Generator().manual_seed(seed)):
            out_p = step(p_cpu, c_p, s_p, cm_cpu, make_input("cpu"))
        sens.append(float(np.abs(out_p.logits.numpy()[live] - lc).max()))
        v_p = dequantized(c_p, s_p, spec)
        cache_sens.append(float((v_p - v_cpu)[:, keep].abs().max()))
    lg = out_g.logits.cpu().numpy()[live]
    check(np.isfinite(lg).all(), "step logits not finite on cuda")
    err = float(np.abs(lg - lc).max())
    scale = float(np.abs(lc).max())
    tol = 3 * max(sens, default=0.0) + 1e-4 * scale
    label = (quant_method + (" + int8 KV" if spec.quantized else "")
             + (" + ALiBi" if cfg.position_encoding == "alibi" else "")
             + (" + qkv/o bias" if cfg.attn_bias else ""))
    check(err <= tol, f"step {label} logits: max|diff| {err} > {tol}")
    v_gpu = dequantized(c_gpu.cpu(), clone(s_gpu), spec)
    cache_err = float((v_gpu - v_cpu)[:, keep].abs().max())
    cache_tol = (3 * max(cache_sens, default=0.0)
                 + 1e-4 * float(v_cpu[:, keep].abs().max()))
    check(cache_err <= cache_tol, f"step {label} cache: max|diff| "
          f"{cache_err} > {cache_tol}")
    tg, tc = out_g.tokens.cpu().numpy()[live], out_c.tokens.numpy()[live]
    top2 = np.sort(lc, axis=-1)[:, -2:]
    decided = (top2[:, 1] - top2[:, 0]) > 2 * err
    check((tg[decided] == tc[decided]).all(),
          f"greedy tokens differ: cuda {tg} cpu {tc}")
    return dict(quant=label, width=cfg.hidden_dim, logit_max_abs_err=err,
                logit_scale=scale, sensitivity=sens, tol=tol,
                cache_max_abs_err=cache_err, cache_tol=cache_tol,
                tokens_cuda=tg.tolist(),
                tokens_cpu=tc.tolist(), rows_decided=int(decided.sum()),
                rows=int(live.sum()))


def params_to_cpu(p):
    """A copy of a model's parameters on the cpu (the same bytes)."""
    out = {k: v.cpu() for k, v in p.items() if k != "layers"}
    out["layers"] = [{k: v.cpu() for k, v in lp.items()}
                     for lp in p["layers"]]
    return out


def prefix_chunk_cross_check(torch, port, widths):
    """The served prefix-hit and chunk steps, cuda (kernels) against cpu
    (plain versions), at ``widths`` with 2 layers, online_i8i8 weights and
    int8 KV, in float32. On each device a cold step first prefills a
    1,024-token prompt (8 pages) beside 3 live decode rows and 1 padding
    row; from the cache that step wrote, (hit) a 192-token tail at
    prefill_start = 8 pages, and (chunk) a 512-token chunk at
    prefill_start = 512 over the prompt's first 4 pages, each beside the
    same decode rows. Gates as ``step_cross_check``'s: logits within 3x the
    largest move that 1e-6 perturbations of the attention outputs cause
    on the cpu (over the cold step and the step checked) plus 1e-4 of the
    largest logit, greedy tokens equal on the rows whose top-2 margin
    exceeds twice the error, and the written cache rows (dequantized)
    within the same rule. This holds the numbers that the served prefix
    path cannot give exactly (a hit reads its prefix from int8 pages)."""
    llama, kv, samp = port["llama"], port["kv"], port["samp"]
    quant_method = "online_i8i8"
    cfg = port["ModelConfig"](**dict(widths, num_layers=2, dtype="float32"))
    npages = 24
    spec = kv.CacheSpec(num_layers=2, num_pages=npages, page_size=PS,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        quant_bit=cfg.cache_quant_bit,
                        quant_group=cfg.cache_quant_group,
                        dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    p_gpu = llama.quantize_model_params(
        llama.init_params(cfg, gen, dtype=torch.float32, device="cuda"),
        quant_method)
    p_cpu = params_to_cpu(p_gpu)
    rng = np.random.default_rng(SEED + 5)
    shape = (spec.num_kv_heads, 2 * spec.num_slots, spec.row_lanes)
    cache0 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    scale0 = torch.from_numpy(rng.uniform(
        0.005, 0.03, (shape[1], spec.scale_lanes)).astype(
            np.float32)).to(torch.bfloat16)
    V = cfg.vocab_size
    prompt = rng.integers(3, V, 1024 + 192)
    chunk = rng.integers(3, V, 512)
    bd, kvp = 4, 16
    pt_dec = np.full((bd, kvp), npages, np.int32)
    pt_dec[0, :2], pt_dec[1, :1], pt_dec[2, :4] = [0, 1], [2], [3, 4, 5, 6]
    prefix_pages = list(range(7, 15))
    # (qp, tokens, start, pages of the prefill row)
    steps = {"cold": (1024, prompt[:1024], 0, prefix_pages),
             "hit": (256, prompt[1024:], 1024, prefix_pages + [15, 16]),
             "chunk": (512, chunk, 512, prefix_pages[:4] + [17, 18, 19, 20])}
    dec_tokens = rng.integers(3, V, bd)
    dec_pos = np.array([129, 40, 400, 0])
    live = np.array([True, True, True, False, True])

    def make_input(name, dev):
        qp, toks, start, pages = steps[name]
        pt = np.full((bd + 1, kvp), npages, np.int32)
        pt[:bd] = pt_dec
        pt[bd, :len(pages)] = pages
        ptok = np.zeros((1, qp), np.int32)
        ptok[0, :len(toks)] = toks
        f = dict(decode_tokens=dec_tokens, decode_pos=dec_pos,
                 prefill_tokens=ptok, prefill_start=np.array([start]),
                 prefill_len=np.array([len(toks)]), page_table=pt,
                 context_len=np.array([130, 41, 401, 0, start + len(toks)]),
                 batch_slots=np.zeros(bd + 1))
        t = {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
             for k, v in f.items()}
        b = bd + 1
        ones, zeros = torch.ones(b, device=dev), torch.zeros(b, device=dev)
        sp = samp.SamplingParams(ones, torch.ones(b, dtype=torch.int32,
                                                  device=dev), zeros,
                                 torch.zeros(b, dtype=torch.bool,
                                             device=dev), ones, zeros, zeros)
        return llama.StepInput(sampling=sp, **t)

    step = llama.make_step_fn(cfg, spec, return_logits=True,
                              quant_method=quant_method, greedy_only=True)

    def run(name, params, cache, scale, dev):
        cm = torch.zeros((1, 1), dtype=torch.int32, device=dev)
        return step(params, cache, scale, cm, make_input(name, dev))

    def after_cold(params, dev, perturb=None):
        """(cache, scale) after the cold step on ``dev``."""
        c, sc = cache0.to(dev, copy=True), scale0.to(dev, copy=True)
        if perturb is None:
            run("cold", params, c, sc, dev)
        else:
            with perturbed_attention(torch, port["pk"], 1e-6, perturb):
                run("cold", params, c, sc, dev)
        return c, sc

    keep = torch.ones(2 * spec.num_slots, dtype=torch.bool)
    for layer in range(2):
        lo = layer * spec.num_slots + spec.trash_page * PS
        keep[lo:lo + PS] = False
    cold_g, cold_c = after_cold(p_gpu, "cuda"), after_cold(p_cpu, "cpu")
    torch.cuda.synchronize()
    cold_p = [after_cold(p_cpu, "cpu", torch.Generator().manual_seed(sd))
              for sd in range(CPU_PERTURB_SEEDS)]
    out = {}
    for name in ("hit", "chunk"):
        c_g, s_g = (t.clone() for t in cold_g)
        out_g = run(name, p_gpu, c_g, s_g, "cuda")
        c_c, s_c = (t.clone() for t in cold_c)
        out_c = run(name, p_cpu, c_c, s_c, "cpu")
        lc = out_c.logits.numpy()[live]
        v_cpu = dequantized(c_c, s_c, spec)
        sens, cache_sens = [], []
        for sd, (c0, s0) in enumerate(cold_p):
            c_p, s_p = c0.clone(), s0.clone()
            with perturbed_attention(torch, port["pk"], 1e-6,
                                     torch.Generator().manual_seed(
                                         100 + sd)):
                out_p = run(name, p_cpu, c_p, s_p, "cpu")
            sens.append(float(np.abs(out_p.logits.numpy()[live]
                                     - lc).max()))
            cache_sens.append(float((dequantized(c_p, s_p, spec)
                                     - v_cpu)[:, keep].abs().max()))
        lg = out_g.logits.cpu().numpy()[live]
        check(np.isfinite(lg).all(), f"{name} step logits not finite")
        err = float(np.abs(lg - lc).max())
        scale = float(np.abs(lc).max())
        tol = 3 * max(sens) + 1e-4 * scale
        check(err <= tol, f"{name} step logits: max|diff| {err} > {tol}")
        v_gpu = dequantized(c_g.cpu(), s_g.cpu(), spec)
        cache_err = float((v_gpu - v_cpu)[:, keep].abs().max())
        cache_tol = (3 * max(cache_sens)
                     + 1e-4 * float(v_cpu[:, keep].abs().max()))
        check(cache_err <= cache_tol, f"{name} step cache: max|diff| "
              f"{cache_err} > {cache_tol}")
        tg = out_g.tokens.cpu().numpy()[live]
        tc = out_c.tokens.numpy()[live]
        top2 = np.sort(lc, axis=-1)[:, -2:]
        decided = (top2[:, 1] - top2[:, 0]) > 2 * err
        check((tg[decided] == tc[decided]).all(),
              f"{name} step greedy tokens differ: cuda {tg} cpu {tc}")
        out[name] = dict(start=steps[name][2], new=len(steps[name][1]),
                         logit_max_abs_err=err, tol=tol, logit_scale=scale,
                         sensitivity=sens, cache_max_abs_err=cache_err,
                         cache_tol=cache_tol, tokens_cuda=tg.tolist(),
                         tokens_cpu=tc.tolist(),
                         rows_decided=int(decided.sum()),
                         rows=int(live.sum()))
    return out


def block_cross_check(torch, port, block_tail, step, widths, quant_method,
                      against_cpu=True):
    """A 4-step decode block at ``widths`` (2 layers, f32, int8 KV) with
    ``quant_method`` weights (w4a8 with an int4 lm_head): 8 rows (two
    padding, one crossing a page mid-block). The block runs on cpu (plain
    versions; only ``against_cpu``) and on cuda through
    the engine's runner: its first call runs the block eagerly, its second
    captures it as a CUDA graph and replays it, from the same cache state.
    Eager and replay must agree bit for bit on the live rows' tokens and
    logprobs and on every cache and scale byte outside the trash page.
    The padding rows are out of it: their duplicate writes land on the
    trash page in any order, and in per-step mode they read it back, so
    their (discarded) outputs vary from run to run, eager or replayed
    alike. Against the cpu: greedy tokens equal on the live
    rows, logprobs within twice the same widths' step check's logit
    tolerance (``step``) and the written cache rows (dequantized) within
    its cache tolerance."""
    llama, kv = port["llama"], port["kv"]
    cfg = port["ModelConfig"](**dict(widths, num_layers=2,
                                     dtype="float32"))
    npages, n_steps, bd, kvp = 24, 4, 8, 4
    spec = kv.CacheSpec(num_layers=2, num_pages=npages, page_size=PS,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        quant_bit=8, quant_group=8, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 6)
    p_gpu = llama.quantize_model_params(
        llama.init_params(cfg, gen, dtype=torch.float32, device="cuda"),
        quant_method, quantize_lm_head=quant_method == "online_w4a8")
    rng = np.random.default_rng(SEED + 6)
    shape = (spec.num_kv_heads, 2 * spec.num_slots, spec.row_lanes)
    cache0 = torch.from_numpy(rng.integers(-127, 128, shape).astype(np.int8))
    scale0 = torch.from_numpy(rng.uniform(
        0.005, 0.03, (shape[1], spec.scale_lanes)).astype(
            np.float32)).to(torch.bfloat16)
    # contexts incl. the current token; 0 = padding row. Row 5 crosses
    # from page 0 into page 1 inside the block.
    ctx = np.array([130, 41, 300, 0, 257, 127, 0, 5], np.int32)
    pt = np.full((bd, kvp), npages, np.int32)
    nxt = 0
    for r, c in enumerate(ctx):
        if c:
            n = -(-(int(c) + n_steps - 1) // PS)
            pt[r, :n] = np.arange(nxt, nxt + n)
            nxt += n
    live = ctx > 0
    f = dict(decode_tokens=rng.integers(3, cfg.vocab_size, bd),
             decode_pos=np.maximum(ctx - 1, 0),
             prefill_tokens=np.zeros((0, 1)), prefill_start=np.zeros(0),
             prefill_len=np.zeros(0), page_table=pt, context_len=ctx,
             batch_slots=np.zeros(bd))

    def make_input(dev):
        t = {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
             for k, v in f.items()}
        ones, zeros = torch.ones(bd, device=dev), torch.zeros(bd, device=dev)
        sp = port["samp"].SamplingParams(
            ones, torch.ones(bd, dtype=torch.int32, device=dev), zeros,
            torch.zeros(bd, dtype=torch.bool, device=dev), ones, zeros, zeros)
        return llama.StepInput(sampling=sp, **t)

    block = llama.make_multi_step_fn(cfg, spec, n_steps,
                                     block_tail=block_tail,
                                     quant_method=quant_method,
                                     greedy_only=True)
    c_gpu, s_gpu = cache0.cuda(), scale0.cuda()
    cm = torch.zeros((1, 1), dtype=torch.int32, device="cuda")
    inp = make_input("cuda")
    runner = port["engine"]._Runner(
        lambda: block(p_gpu, c_gpu, s_gpu, cm, inp), torch.device("cuda"))
    snap = (c_gpu.clone(), s_gpu.clone())
    t_e, l_e = [x.clone() for x in runner()]          # eager
    eager = (c_gpu.clone(), s_gpu.clone())
    c_gpu.copy_(snap[0])
    s_gpu.copy_(snap[1])
    t_g, l_g = [x.clone() for x in runner()]          # captured, replayed
    torch.cuda.synchronize()
    check(runner.graph is not None and runner.replays == 1,
          f"block {block_tail}: the second visit did not replay a graph")
    keep = torch.ones(2 * spec.num_slots, dtype=torch.bool, device="cuda")
    for layer in range(2):
        lo = layer * spec.num_slots + spec.trash_page * PS
        keep[lo:lo + PS] = False
    lv = torch.from_numpy(live).cuda()
    same = {"tokens": torch.equal(t_e[:, lv], t_g[:, lv]),
            "logprobs": torch.equal(l_e[:, lv].view(torch.int32),
                                    l_g[:, lv].view(torch.int32)),
            "cache": torch.equal(eager[0][:, keep], c_gpu[:, keep]),
            "scales": torch.equal(eager[1][keep].view(torch.int16),
                                  s_gpu[keep].view(torch.int16))}
    check(all(same.values()), f"block {block_tail}: graph replay differs "
          f"from the eager block: equal {same}")
    tg = t_g.cpu().numpy()
    if not against_cpu:
        return dict(block_tail=block_tail, tokens=tg[:, live].tolist(),
                    graph_launches=runner.launches)
    p_cpu = {k: v.cpu() for k, v in p_gpu.items() if k != "layers"}
    p_cpu["layers"] = [{k: v.cpu() for k, v in lp.items()}
                       for lp in p_gpu["layers"]]
    c_cpu, s_cpu = cache0.clone(), scale0.clone()
    t_c, l_c = block(p_cpu, c_cpu, s_cpu,
                     torch.zeros((1, 1), dtype=torch.int32),
                     make_input("cpu"))
    tc = t_c.numpy()
    check((tg[:, live] == tc[:, live]).all(),
          f"block {block_tail}: tokens cuda {tg[:, live].tolist()} cpu "
          f"{tc[:, live].tolist()}")
    lp_err = float(np.abs(l_g.cpu().numpy()[:, live]
                          - l_c.numpy()[:, live]).max())
    check(lp_err <= 2 * step["tol"], f"block {block_tail}: logprobs "
          f"max|diff| {lp_err} > {2 * step['tol']}")
    keep_c = keep.cpu()
    v_gpu = dequantized(c_gpu.cpu(), s_gpu.cpu(), spec)[:, keep_c]
    v_cpu = dequantized(c_cpu, s_cpu, spec)[:, keep_c]
    written = (v_cpu != dequantized(cache0, scale0, spec)[:, keep_c]).any(
        dim=(0, 2))
    cache_err = float((v_gpu - v_cpu)[:, written].abs().max())
    check(cache_err <= step["cache_tol"], f"block {block_tail}: written "
          f"cache max|diff| {cache_err} > {step['cache_tol']}")
    return dict(block_tail=block_tail, tokens=tg[:, live].tolist(),
                logprob_max_abs_err=lp_err, cache_max_abs_err=cache_err,
                rows_written=int(written.sum()),
                graph_launches=runner.launches)


BLOCK_TAIL_EPS = 2.0 ** -8    # the block-tail bound's perturbation (bf16)


def first_divergence(ta, tb):
    """Per row: the steps up to and including the first whose greedy
    tokens differ between two blocks (their later steps see other
    inputs), as a [N, B] mask."""
    same = np.cumprod(ta == tb, axis=0).astype(bool)
    return np.concatenate([np.ones_like(same[:1]), same[:-1]], axis=0)


def block_tail_bound(torch, port):
    """One 8-step decode block at LLaMA-2-7B widths and full depth (32
    layers) in bf16 (w4a8 weights, an int4 lm_head, int8 group-8 KV: the
    block-tail path of phase 5) on cuda, run with block_tail on and with
    the per-step cache writes, from the same cache and tokens. Each live
    row's logits are compared up to and including its first step whose
    greedy token differs (after it the rows are fed other tokens). The
    bound is phase 4's perturbation measure at the block's dtype: how far
    multiplying the per-step block's attention outputs by (1 + eps N(0,
    1)) moves its logits, over PERTURB_SEEDS draws, with eps = 2^-8 (half
    a bf16 ulp at 1; the steps' 1e-6 lies below bf16's resolution and
    moves nothing). The block-tail logits must lie within 3 times that."""
    llama, kv = port["llama"], port["kv"]
    cfg = port["ModelConfig"](**LLAMA7B)
    n_steps, bd, npages = 8, 8, 24
    spec = kv.CacheSpec(num_layers=cfg.num_layers, num_pages=npages,
                        page_size=PS, num_kv_heads=cfg.num_kv_heads,
                        head_dim=cfg.head_dim, quant_bit=8, quant_group=8,
                        dtype=torch.bfloat16)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(SEED + 12)
    params = llama.init_params(cfg, gen, dtype=torch.bfloat16, device=dev,
                               quantize="online_w4a8", quantize_lm_head=True)
    cache0, scale0 = random_cache(torch, kv, spec, gen)
    rng = np.random.default_rng(SEED + 12)
    ctx = np.array([130, 41, 300, 0, 257, 127, 0, 5], np.int32)
    pt = np.full((bd, 4), npages, np.int32)
    nxt = 0
    for r, c in enumerate(ctx):
        if c:
            n = -(-(int(c) + n_steps - 1) // PS)
            pt[r, :n] = np.arange(nxt, nxt + n)
            nxt += n
    live = ctx > 0
    f = dict(decode_tokens=rng.integers(3, cfg.vocab_size, bd),
             decode_pos=np.maximum(ctx - 1, 0),
             prefill_tokens=np.zeros((0, 1)), prefill_start=np.zeros(0),
             prefill_len=np.zeros(0), page_table=pt, context_len=ctx,
             batch_slots=np.zeros(bd))
    t = {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
         for k, v in f.items()}
    ones, zeros = torch.ones(bd, device=dev), torch.zeros(bd, device=dev)
    inp = llama.StepInput(sampling=port["samp"].SamplingParams(
        ones, torch.ones(bd, dtype=torch.int32, device=dev), zeros,
        torch.zeros(bd, dtype=torch.bool, device=dev), ones, zeros, zeros),
        **t)
    cm = torch.zeros((1, 1), dtype=torch.int32, device=dev)

    def run(block_tail, seed=None):
        block = llama.make_multi_step_fn(
            cfg, spec, n_steps, block_tail=block_tail,
            quant_method="online_w4a8", greedy_only=True, return_logits=True)
        cache, scale = cache0.clone(), scale0.clone()
        if seed is None:
            toks, _, logits = block(params, cache, scale, cm, inp)
        else:
            with perturbed_attention(
                    torch, port["pk"], BLOCK_TAIL_EPS,
                    torch.Generator(device=dev).manual_seed(seed)):
                toks, _, logits = block(params, cache, scale, cm, inp)
        torch.cuda.synchronize()
        return toks.cpu().numpy()[:, live], logits.float().cpu().numpy()[
            :, live]

    def diff(a, b):
        keep = first_divergence(a[0], b[0])
        return float(np.abs(a[1] - b[1])[keep].max()), int(keep.sum())

    per_step = run("off")
    tail = run("on")
    check(np.isfinite(tail[1]).all(), "block-tail logits not finite")
    err, compared = diff(tail, per_step)
    sens = [diff(run("off", seed), per_step)[0]
            for seed in range(PERTURB_SEEDS)]
    tol = 3 * max(sens)
    same = int((tail[0] == per_step[0]).all(axis=0).sum())
    check(err <= tol, f"block tail at 7B full depth: logits max|diff| "
          f"{err} from the per-step block > {tol} (3 x the perturbation "
          f"measure {sens})")
    del params, cache0, scale0
    torch.cuda.empty_cache()
    return dict(err=err, tol=tol, sensitivity=sens, compared=compared,
                rows=int(live.sum()), steps=n_steps, rows_equal=same,
                scale=float(np.abs(per_step[1]).max()))


# ---------------------------------------------------------- the microbench

def microbench(torch, kernels, name_limit):
    """The KV-write microbench through its entry point at the LLaMA-2-7B
    geometry (4.3 GB int8 cache): forms a-h timed, b-d held to (a)'s
    cache bytes and f-h to 16 writes of (a); K5's launches counted over
    the run, the counts set to 0 just before it."""
    from ppl.llm.serving_tpu_torch.tools import microbench_scatter_7b as mb
    gc.collect()
    torch.cuda.empty_cache()
    kernels.reset_launch_counts()
    out = mb.run(device="cuda", log=lambda line: log(f"[microbench] {line}"))
    counts = kernels.launch_counts()
    log(f"[microbench] on {name_limit}; launch counts over the run: "
        f"{counts}")
    differ = sorted(k for k, same in out["same"].items() if not same)
    check(not differ, f"microbench: forms {differ} leave other cache bytes "
          "than (a) does")
    check(counts["page_read"] > 0, "microbench: K5 was never launched")
    torch.cuda.empty_cache()
    return dict(out, path="microbench", launches=counts)


# ------------------------------------------------------------ the tools

TOOLS = "ppl.llm.serving_tpu_torch.tools."
SAMPLES = "ppl.llm.serving_tpu_torch.samples."
# the bench's gate: these kernels launched over its measured waves
BENCH_LAUNCHED = ("paged_decode_attention", "paged_prefill_attention",
                  "i8i8_matmul")
COLD_START_LAYERS = 1
# host allocator pools, in pages of 128 tokens: the canonical 7B branch's
# 16,384-token pool and the 13B auto pool (100,352 tokens, PERF.md)
ALLOC_POOLS = (("canonical 7B", 128), ("13B auto", 784))
# (path label, BENCH_CONFIG): TinyLlama b64 (traced) and the north star
BENCHES = (("bench tinyllama i8i8 b64", "i8i8"),
           ("bench llama2-7b i8i8 b48", "i8i8_7b"))


def run_tree(cmd, timeout, env=None):
    """Run ``cmd`` from the checkout's root in a process group of its
    own, its output captured. Past ``timeout`` the whole group (the
    servers it started too) is killed, then TimeoutExpired raised."""
    import os
    import signal
    proc = subprocess.Popen(cmd, cwd=os.path.dirname(os.path.abspath(
        __file__)), stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True, start_new_session=True,
        env=dict(os.environ, **(env or {})))
    try:
        out, err = proc.communicate(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()
        raise
    return subprocess.CompletedProcess(cmd, proc.returncode, out, err)


def run_tool(args, timeout, env=None, package=TOOLS):
    """``python -m`` one tool (or sample) of the port
    (:func:`run_tree`)."""
    return run_tree([sys.executable, "-m", package + args[0], *args[1:]],
                    timeout, env)


def tool(label, args, timeout, env=None, package=TOOLS):
    """Run one tool as a user does (:func:`run_tool`); its output is
    logged line by line and returned. A non-zero exit fails the phase."""
    t0 = time.perf_counter()
    proc = run_tool(args, timeout, env, package)
    for line in proc.stdout.splitlines():
        log(f"[{label}] {line}")
    if proc.returncode:
        for line in proc.stderr.splitlines()[-40:]:
            log(f"[{label} stderr] {line}")
    log(f"[{label}] exit {proc.returncode} in {time.perf_counter() - t0:.1f} "
        "s")
    check(proc.returncode == 0, f"{label}: exit {proc.returncode}")
    return proc.stdout


def bench_line(stdout, label):
    """The bench's one JSON line, gated: a throughput, no error or partial
    wave, K1-K3 launched."""
    lines = [ln for ln in stdout.splitlines() if ln.startswith("{")]
    check(len(lines) == 1, f"{label}: {len(lines)} JSON lines, not one")
    rec = json.loads(lines[0])
    check(rec.get("value", 0) > 0, f"{label}: no throughput: {rec}")
    bad = sorted(k for k in rec if k == "error" or k.startswith("partial"))
    check(not bad, f"{label}: {bad} in {rec}")
    for name in BENCH_LAUNCHED:
        check(rec["launches"][name] > 0, f"{label}: {name} never launched")
    check(rec["backend"] == "cuda" and rec["vs_baseline"] > 0,
          f"{label}: not a card run: {rec}")
    return rec


def tools_phase(name_limit, tmp):
    """Phase 7: the measuring tools through their entry points.
    validate_kernels (every case ok); the headline bench at TinyLlama i8i8
    b64 with a trace of the generator's steps 3-6, and at LLaMA-2-7B i8i8
    b48, each gated by :func:`bench_line`; trace_summary --group and
    --timeline over the TinyLlama trace; the K3/K4 microbench at 7B widths
    and T=32; the KV-append microbench; bench_cold_start at TinyLlama
    widths (1 layer) with the warm-up manifest
    (:func:`cold_start_manifest`); the host-turnaround microbench; the
    host allocators' line (:func:`host_allocators`); the library-embedding
    sample (``samples.embed_serving``, the demo model, 16 tokens on cuda).
    Returns the benches' records, whose launches join the kernels line's
    ``launches_by_path``."""
    import os
    out = {}
    ok = [ln for ln in tool("tools validate_kernels", ["validate_kernels"],
                            900).splitlines() if ln.startswith("  ok ")]
    check(len(ok) == 22, f"validate_kernels: {len(ok)} cases ok, not 22")
    trace = os.path.join(tmp, "bench_trace")
    for label, config in BENCHES:
        env = {"BENCH_CONFIG": config}
        if config == "i8i8":
            env["BENCH_TRACE_DIR"] = trace
        rec = bench_line(tool(label, ["bench"], 900, env), label)
        log(f"[{label}] {rec['value']} generated tok/s, vs_baseline "
            f"{rec['vs_baseline']} of {rec['roofline_tokens_per_sec']}, p50 "
            f"TTFT {rec['p50_ttft_ms']} ms, on {name_limit}")
        out[label] = dict(rec, path=label)
    tool("tools trace_summary", ["trace_summary", trace, "--group",
                                 "--timeline"], 300)
    for method in ("i8i8", "w4a8"):
        tool(f"tools microbench {method} T=32",
             ["microbench_quant_matmul", "--method", method, "--t", "32"],
             300)
    tool("tools microbench_scatter", ["microbench_scatter"], 300)
    cold_start_manifest(name_limit, tmp, out)
    tunnel = json.loads(tool("tools microbench_tunnel",
                             ["microbench_tunnel"], 300).splitlines()[-1])
    check(tunnel["graph"] and tunnel["replay_call_ms"] is not None
          and [d["depth"] for d in tunnel["depth"]] == [1, 2, 3, 4],
          f"microbench_tunnel: not a card run: {tunnel}")
    out["microbench_tunnel"] = tunnel
    host_allocators(name_limit)
    # the library-embedding sample as a user runs it: the demo model
    lines = tool("samples embed_serving", ["embed_serving"], 300,
                 package=SAMPLES).splitlines()
    check(lines[-1:] == ["16 tokens on cuda"],
          f"embed_serving: not 16 tokens on cuda: {lines[-1:]}")
    return out


def cold_start_manifest(name_limit, tmp, out):
    """Phase 7's bench_cold_start with the warm-up manifest; its record
    goes into ``out``."""
    import os
    params = os.path.join(tmp, "tinyllama_params.json")
    # TinyLlama widths at 1 of its 22 layers: each start validates the
    # server's default grid, whose captures scale with the depth; the
    # auto-sized pool, so that the manifest's keys are warmed up on the
    # provisional engine too
    write_params_json(dict(TINY, num_layers=COLD_START_LAYERS), params)
    cold = json.loads(tool("tools bench_cold_start", [
        "bench_cold_start", "--params", params, "--kv-cache-max-tokens",
        "0", "--extra", "--quant-method online_i8i8", "--timeout", "600"],
        1300).splitlines()[-1])
    check(set(cold["cold"]["nvcc_s"]) == {"paged_attention", "quant_matmul",
                                          "cache_read"},
          f"bench_cold_start: cold nvcc runs {cold['cold']['nvcc_s']}")
    check(not cold["warm"]["nvcc_s"], "bench_cold_start: nvcc ran on the "
          f"warm start: {cold['warm']['nvcc_s']}")
    check(cold["cold"]["manifest_keys"] >= 1, "bench_cold_start: the cold "
          f"start recorded no program key: {cold['cold']}")
    warm = cold["warm"]
    stats = warm["manifest"] or {}
    check(warm["prewarm_before_listening"] and stats.get("live", 0) >= 1
          and stats["prewarmed"] == stats["captured"] == stats["live"],
          f"bench_cold_start: the warm start did not capture every live "
          f"manifest key before it listened: {stats}")
    check(warm["eager_manifest_visits"] == 0, "bench_cold_start: the warm "
          f"probe ran a manifest key eagerly: {warm}")
    log(f"[tools bench_cold_start] manifest: the cold start recorded "
        f"{cold['cold']['manifest_keys']} program keys (its probe "
        f"{cold['cold']['eager_visits']} eager dispatches); the warm start "
        f"captured {stats['captured']} of {stats['live']} live keys in "
        f"{stats['seconds']:.1f} s before it listened (listening after "
        f"{warm['listen_s']} s, against {cold['cold']['listen_s']} s "
        f"cold), its probe {warm['eager_visits']} eager dispatches, "
        f"{warm['eager_manifest_visits']} of them manifest keys; first "
        f"token {warm['first_token_s']} s warm, "
        f"{cold['cold']['first_token_s']} s cold, on {name_limit}")
    out["bench_cold_start"] = cold


def host_allocators(name_limit, rounds=5):
    """Phase 7's allocator line: µs an operation on this host of the
    native host runtime's classes against the port's Python classes, one
    pool size at a time (:data:`ALLOC_POOLS`), each workload the least of
    ``rounds`` runs and both sides fed the same seeded operations, whose
    results must agree: the page manager (admissions of 1-8 pages until
    the pool is full, then every admission freed), the index manager (the
    same over contiguous ranges) and the prefix cache (a cycle of 8
    hashes: 8 inserts, a release, a reference and a release)."""
    import random
    from ppl.llm.serving_tpu_torch.utils import _native
    from ppl.llm.serving_tpu_torch.utils.index_manager import IndexManager
    from ppl.llm.serving_tpu_torch.utils.page_manager import PageManager
    from ppl.llm.serving_tpu_torch.utils.prefix_cache import (
        PrefixCacheManager)
    classes = {"native": (_native.get_index_manager_cls(),
                          _native.get_page_manager_cls(),
                          _native.get_prefix_cache_cls()),
               "python": (IndexManager, PageManager, PrefixCacheManager)}

    def pages(cls, n_pages, sizes):
        pm, held, out = cls(n_pages * PS, PS), [], []
        for n in sizes:
            got = pm.alloc(n)
            if got is None:
                break
            held.append(got)
            out.append(list(got))
        for got in held:
            pm.free(got)
        return len(held) * 2 + 1, out

    def index(cls, n_pages, sizes):
        im, held, out = cls(n_pages), [], []
        for n in sizes:
            start = im.alloc(n)
            out.append(start)
            if start == _native.load().INVALID_INDEX:
                break
            held.append((start, n))
        for start, n in held:
            im.free(start, n)
        return len(held) * 2 + 1, out

    def prefix(cls, n_pages, _):
        pc, out = cls(), []
        for c in range(n_pages // 8):
            hs = [(c << 3 | i) * 0x9E3779B97F4A7C15 % (1 << 63)
                  for i in range(8)]
            out += [pc.insert(h, c * 8 + i) for i, h in enumerate(hs)]
            pc.dec_ref_count(hs)
            pc.inc_ref_count(hs)
            pc.dec_ref_count(hs)
        return n_pages // 8, out + [pc.evictable_count, len(pc)]

    parts = []
    for label, n_pages in ALLOC_POOLS:
        sizes = random.Random(SEED).choices(range(1, 9), k=n_pages)
        cells = []
        for what, fn, pos, unit in (("page", pages, 1, "an op"),
                                    ("index", index, 0, "an op"),
                                    ("prefix", prefix, 2, "a cycle of 8")):
            us, results = {}, {}
            for impl, cls in classes.items():
                best = None
                for _ in range(rounds):
                    t0 = time.perf_counter()
                    n_ops, results[impl] = fn(cls[pos], n_pages, sizes)
                    dt = time.perf_counter() - t0
                    best = dt if best is None else min(best, dt)
                us[impl] = best * 1e6 / n_ops
            check(results["native"] == results["python"],
                  f"host allocators: the native {what} manager disagrees "
                  f"with the Python one at {n_pages} pages")
            cells.append(f"{what} {us['native']:.2f} vs {us['python']:.2f} "
                         f"µs {unit} ({us['python'] / us['native']:.2f}x)")
        parts.append(f"{label} pool ({n_pages} pages): " + ", ".join(cells))
    log(f"[tools host allocators] native vs Python, results equal: "
        + "; ".join(parts) + f"; on the host of {name_limit}")


# phase 8: the canonical qps benchmark's 7B branch (bench_canonical.sh's
# MODEL=7b): LLaMA-2-7B widths, 32 layers, i8i8 + int8 group-8 KV + int8
# lm_head, page 128, 256 ShareGPT-mix requests at rate inf, twice; then a
# restart with the first run's manifest, serving the first 64 requests
CANONICAL_LABEL = "canonical 7B i8i8 int8-KV"
RESTART_LABEL = "canonical 7B restart with its manifest"
CANONICAL_REQUESTS = 256
RESTART_REQUESTS = 64
CANONICAL_IDLE = ("w4a8_matmul", "page_read", "paged_decode_attention_tail",
                  "paged_decode_attention_alibi",
                  "paged_prefill_attention_alibi")
PROGRAM_KEYS = "[INFO] program keys while serving: "
WARMUP_MANIFEST = "[INFO] warm-up manifest: "


def canonical_run(label, args, timeout):
    """``bench_canonical`` as a user runs it; returns its JSON line's
    record. Gates: exit 0, one JSON line and nothing else on stdout."""
    t0 = time.perf_counter()
    proc = run_tool(["bench_canonical", *args], timeout)
    for line in proc.stderr.splitlines():
        if line.startswith(("[bench_canonical]", "[RESULT] finished",
                            "[RESULT] benchmark time",
                            "[RESULT] tokens out per sec")):
            log(f"[{label}] {line}")
    if proc.returncode:
        for line in proc.stderr.splitlines()[-40:]:
            log(f"[{label} stderr] {line}")
    log(f"[{label}] exit {proc.returncode} in {time.perf_counter() - t0:.1f} "
        "s")
    check(proc.returncode == 0, f"{label}: exit {proc.returncode}")
    lines = proc.stdout.splitlines()
    check(len(lines) == 1 and lines[0].startswith("{"),
          f"{label}: stdout is not one JSON line: {lines[:3]}")
    return json.loads(lines[0])


def server_line(server_log, prefix):
    """The JSON of the last line of ``server_log`` that starts with
    ``prefix``, and where it starts (None, -1 without one)."""
    at = server_log.rfind("\n" + prefix)
    if at < 0:
        return None, -1
    end = server_log.find("\n", at + 1)
    return json.loads(server_log[at + 1 + len(prefix):end]), at + 1


def canonical_phase(name_limit, tmp):
    """Phase 8: ``python -m ppl.llm.serving_tpu_torch.tools.bench_canonical
    --model 7b`` as a user runs it (its server a process of its own; the
    kernels this run built are found, not rebuilt), its program keys
    recorded in a manifest in ``tmp``. Gates: exit 0; one JSON line and
    nothing else on stdout; 256 of 256 requests finished and 0 failed in
    the warm pass and in the measured pass; tokens out/s above 0; the
    server's log has its "bucket grid validated before serving" line
    before it listens; K1-K3 launched while serving and K4, K5, K1's tail
    and the ALiBi branches not (the server's counts over both passes);
    the manifest holds the server's keys. Then :func:`canonical_restart`.
    No speed gate. Returns both runs' records."""
    import os
    label = f"phase 8 {CANONICAL_LABEL}"
    work = os.path.join(tmp, "canonical")
    manifest = os.path.join(tmp, "canonical_manifest.json")
    rec = canonical_run(label, ["--model", "7b", "--work-dir", work,
                                "--manifest", manifest], 900)
    n = CANONICAL_REQUESTS
    check(rec["requests"] == n and rec["finished"] == n
          and rec["warm_finished"] == n, f"{label}: finished "
          f"{rec['warm_finished']} (warm) and {rec['finished']} of "
          f"{rec['requests']}, want {n} of {n}")
    check(rec["failed"] == 0 and rec["warm_failed"] == 0,
          f"{label}: {rec['warm_failed']} (warm) and {rec['failed']} failed")
    check(rec["tokens_out_per_s"] > 0, f"{label}: no throughput: {rec}")
    check(rec["device"] == "cuda" and rec["card"] != "cpu",
          f"{label}: not a card run: {rec}")
    with open(os.path.join(work, "server.log")) as f:
        server_log = f.read()
    validated = server_log.find("bucket grid validated before serving")
    listening = server_log.find("listening on port")
    check(0 <= validated < listening, f"{label}: the server log has no "
          "bucket grid validated before it listens")
    grid = server_log[validated:server_log.index("\n", validated)]
    launches = rec["launches"]
    check(launches is not None, f"{label}: the server printed no launches")
    for name in ATTN + ("i8i8_matmul",):
        check(launches[name] > 0, f"{label}: {name} never launched")
    for name in CANONICAL_IDLE:
        check(launches[name] == 0,
              f"{label}: {name} launched {launches[name]} times")
    keys, _ = server_line(server_log, PROGRAM_KEYS)
    check(keys is not None and rec["manifest_keys"] >= 1
          and keys["manifest_keys"] == rec["manifest_keys"],
          f"{label}: the manifest holds no program key: {keys}")
    log(f"[{label}] {grid}")
    log(f"[{label}] measured pass: {rec['finished']} of {n} finished, "
        f"{rec['failed']} failed (warm pass {rec['warm_finished']} / "
        f"{rec['warm_failed']}); tokens out/s {rec['tokens_out_per_s']:.1f}"
        f" ({rec['tokens_out_per_s_per_chip']:.1f} a card), p50 TTFT "
        f"{rec['ttft_p50_ms']:.1f} ms, p50 TPOT {rec['tpot_p50_ms']:.2f} ms, "
        f"time per token {rec['time_per_token_ms']:.3f} ms; startup "
        f"{rec['startup_s']:.1f} s, warm pass {rec['warm_s']:.1f} s, "
        f"measured pass {rec['measured_s']:.1f} s; the server's launches "
        f"over both passes {launches}; on {rec['card']}, "
        f"{rec['power_limit_w']} W ({name_limit})")
    log(f"[{label}] program keys: the manifest holds "
        f"{rec['manifest_keys']}, {len(keys['new_keys'])} of them met first "
        f"while serving; eager dispatches (no graph to replay) "
        f"{rec['eager_visits']} in the measured pass, "
        f"{keys['eager_visits']} over both passes, by key "
        f"{keys['eager_keys']}")
    restart = canonical_restart(name_limit, tmp, manifest)
    return {CANONICAL_LABEL: dict(rec, path=CANONICAL_LABEL),
            RESTART_LABEL: dict(restart, path=RESTART_LABEL)}


def canonical_restart(name_limit, tmp, manifest):
    """Phase 8's restart: the same server flags with the first run's
    manifest, one pass of the first 64 requests (no warm pass). Gates:
    every request finished, none failed; the server's log has its
    warm-up line before it listens, with every live manifest key
    captured; no manifest key ran eagerly while serving (the server's
    report at its stop). Prints the startup, tokens out/s, TPOT and the
    keys new to the manifest. Returns the run's record."""
    import os
    label = f"phase 8 {RESTART_LABEL}"
    work = os.path.join(tmp, "canonical_restart")
    n = RESTART_REQUESTS
    rec = canonical_run(label, ["--model", "7b", "--work-dir", work,
                                "--manifest", manifest, "--num-requests",
                                str(n), "--warm-requests", "0"], 600)
    check(rec["finished"] == n and rec["failed"] == 0,
          f"{label}: finished {rec['finished']} of {n}, {rec['failed']} "
          "failed")
    with open(os.path.join(work, "server.log")) as f:
        server_log = f.read()
    stats, at = server_line(server_log, WARMUP_MANIFEST)
    listening = server_log.find("listening on port")
    check(stats is not None and 0 <= at < listening,
          f"{label}: no warm-up before the server listened")
    check(stats["live"] >= 1 and stats["captured"] == stats["prewarmed"]
          == stats["live"], f"{label}: not every live manifest key was "
          f"captured before listening: {stats}")
    keys, _ = server_line(server_log, PROGRAM_KEYS)
    check(keys is not None and keys["eager_manifest_visits"] == 0,
          f"{label}: a manifest key ran eagerly: {keys}")
    log(f"[{label}] {n} of {n} finished, 0 failed; startup "
        f"{rec['startup_s']:.1f} s with {stats['captured']} of "
        f"{stats['live']} live manifest keys captured in "
        f"{stats['seconds']:.1f} s ({stats['stale']} stale, "
        f"{stats['off_grid']} off the grid); tokens out/s "
        f"{rec['tokens_out_per_s']:.1f} a card, p50 TTFT "
        f"{rec['ttft_p50_ms']:.1f} ms, p50 TPOT {rec['tpot_p50_ms']:.2f} ms;"
        f" eager dispatches {keys['eager_visits']}, of manifest keys "
        f"{keys['eager_manifest_visits']}; keys new to the manifest "
        f"{keys['new_keys']}; on {rec['card']}, {rec['power_limit_w']} W "
        f"({name_limit})")
    return rec


# --------------------------------------------------------------- end to end

# the paths phase 5 drives: (label, widths, ResourceConfig fields,
# kernels that must launch, kernels that must not). The 7B block paths
# serve the 7B path's workload and weights in decode blocks of 8. The
# model-family paths run the default serving configuration (blocks of
# 8, block_tail "auto", one speculative block); the last path is the
# 13B one with the default auto-sized KV pool, sized after create_engine
# validates the bucket grid. No serving path reads the cache with K5,
# and only the ALiBi paths launch K1/K2's ALiBi branches.
W4_7B = dict(quant_method="online_w4a8", quantize_lm_head=True,
             kv_cache_max_tokens=16384)
I8_16K = dict(quant_method="online_i8i8", kv_cache_max_tokens=16384)
ATTN = ("paged_decode_attention", "paged_prefill_attention")
W4_LAUNCHED = ATTN + ("w4a8_matmul",)
ALIBI = ("paged_decode_attention_alibi", "paged_prefill_attention_alibi")
NEVER = ALIBI + ("page_read",)
# the depth cuts that keep the whole run well inside the 1,200 s limit
# on a busy host: the 7B w4a8 paths (off the main path: K4) at 16 of 32
# layers, the Baichuan-13B path over an explicit pool (ALiBi) at 20 of
# 40 and the InternLM-7B path (biases) at 16 of 32; TinyLlama serves at
# full depth, and so do the 13B auto-pool path (its memory sizing is
# what it checks) and the gRPC, checkpoint and canonical paths
LLAMA7B_W4_E2E = dict(LLAMA7B, num_layers=16)
BAICHUAN13B_E2E = dict(BAICHUAN13B, num_layers=20)
INTERNLM7B_E2E = dict(INTERNLM7B, num_layers=16)
PATHS = [
    ("tinyllama i8i8", TINY,
     dict(quant_method="online_i8i8", kv_cache_max_tokens=32768,
          multi_step=1),
     ATTN + ("i8i8_matmul",),
     ("w4a8_matmul", "paged_decode_attention_tail") + NEVER),
    ("llama2-7b w4a8 int8-kv", LLAMA7B_W4_E2E, dict(W4_7B, multi_step=1),
     W4_LAUNCHED, ("i8i8_matmul", "paged_decode_attention_tail") + NEVER),
    ("llama2-7b w4a8 int8-kv blocks", LLAMA7B_W4_E2E,
     dict(W4_7B, multi_step=8, block_tail="auto"), W4_LAUNCHED,
     ("i8i8_matmul", "paged_decode_attention_tail") + NEVER),
    ("llama2-7b w4a8 int8-kv block-tail", LLAMA7B_W4_E2E,
     dict(W4_7B, multi_step=8, block_tail="on"),
     W4_LAUNCHED + ("paged_decode_attention_tail",),
     ("i8i8_matmul",) + NEVER),
    ("baichuan-13b i8i8 int8-kv alibi", BAICHUAN13B_E2E, I8_16K,
     ATTN + ("i8i8_matmul",) + ALIBI,
     ("w4a8_matmul", "paged_decode_attention_tail", "page_read")),
    ("internlm-7b i8i8 int8-kv bias", INTERNLM7B_E2E, I8_16K,
     ATTN + ("i8i8_matmul",),
     ("w4a8_matmul", "paged_decode_attention_tail") + NEVER),
    ("baichuan-13b i8i8 int8-kv alibi auto-pool", BAICHUAN13B,
     dict(quant_method="online_i8i8"), ATTN + ("i8i8_matmul",) + ALIBI,
     ("w4a8_matmul", "paged_decode_attention_tail", "page_read")),
]


def end_to_end(torch, port, name_limit, label, widths, resource, launched,
               idle):
    """Serve the 8-request workload on the card through the user's entry
    points, on one path. A path without ``kv_cache_max_tokens`` takes the
    auto-sized pool: create_engine validates the bucket grid, and no graph
    may be captured after that."""
    cfgs = port["config"]
    kernels = port["kernels"]
    model_cfg = cfgs.ModelConfig(**widths)
    gen_cfg = cfgs.GeneratorConfig(
        max_running_batch=16, max_prefill_batch=8, max_tokens_per_step=8192,
        max_input_tokens_per_request=4096,
        max_output_tokens_per_request=256,
        max_total_tokens_per_request=8192)
    rcfg = cfgs.ResourceConfig(model_format="random", **resource)
    auto = not rcfg.kv_cache_max_tokens
    gc.collect()                 # the previous path's engine and graphs
    torch.cuda.empty_cache()
    free, total = torch.cuda.mem_get_info()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    engine, kv_max, max_running_batch = port["create_engine"](
        model_cfg, rcfg, gen_cfg, rng_seed=SEED)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    gen_cfg.max_running_batch = max_running_batch
    nbytes = sum(t.numel() * t.element_size() for t in
                 [v for k, v in engine._params.items() if k != "layers"]
                 + [v for lp in engine._params["layers"] for v in lp.values()])
    kv_bytes = sum(t.numel() * t.element_size()
                   for t in (engine.kv_cache, engine.kv_scale)
                   if t is not None)
    graphs_ready = engine.graph_stats()
    log(f"[e2e {label}] engine ready in {setup_s:.1f} s; weights "
        f"{nbytes / 1e9:.2f} GB, KV pool {kv_max} tokens in "
        f"{kv_bytes / 1e9:.2f} GB ({engine.kv_cache.dtype}) "
        f"({'auto-sized' if auto else 'explicit'}); free {free >> 20} MiB "
        f"of {total >> 20} MiB before weights; peak "
        f"{torch.cuda.max_memory_allocated() >> 20} MiB while building")
    # the weight build (each layer quantized as it is drawn): its own
    # peak, and what stays missing from the free memory after it
    free_wb = engine.free_before_weights_bytes
    free_wa = engine.free_after_weights_bytes
    missing = free_wb - nbytes - free_wa
    log(f"[e2e {label}] weight build: its own peak "
        f"{engine.weight_build_peak_bytes >> 20} MiB for {nbytes >> 20} MiB "
        f"of weights; free {free_wa >> 20} MiB after the weights, "
        f"{free_wb >> 20} MiB before less the weights would be "
        f"{(free_wb - nbytes) >> 20} MiB ({missing >> 20} MiB missing) on "
        f"{name_limit}")
    if auto:
        log(f"[e2e {label}] bucket grid validated before serving: batch "
            f"buckets {engine.batch_buckets}, max_running_batch "
            f"{max_running_batch}, max_prefill_rows "
            f"{engine.max_prefill_rows or 'none capped'}; "
            f"{graphs_ready['graphs']} CUDA graphs in one shared pool of "
            f"{graphs_ready['pool_bytes'] >> 20} MiB (budget "
            f"{engine.graph_budget_bytes >> 20} MiB: the provisional "
            f"engine's peak above the weights); validation peak "
            f"{engine.validation_peak_bytes >> 20} MiB above the KV pool, "
            f"on {name_limit}")
    # from here: the serving peak (warm-up, graph captures, the runs)
    gc.collect()
    torch.cuda.empty_cache()
    free_w = torch.cuda.mem_get_info()[0] + kv_bytes   # after the weights
    reserved0 = torch.cuda.memory_reserved()
    torch.cuda.reset_peak_memory_stats()
    conn = port["LocalConnection"]()
    gen = port["LLMGenerator"](model_cfg, gen_cfg, engine,
                               port["ByteTokenizer"](), conn, kv_max)
    rng = np.random.default_rng(SEED + 4)
    V = model_cfg.vocab_size

    def serve(n_req, gen_len, id0):
        lens = rng.integers(100, 401, n_req)
        reqs = [port["Request"](id=id0 + i,
                                token_ids=rng.integers(3, V, int(n)).tolist(),
                                generation_length=gen_len, top_k=1,
                                early_stopping=False)
                for i, n in enumerate(lens)]
        conn.set_wanted(n_req)
        t = time.perf_counter()
        for r in reqs:
            gen.process(r)
        check(conn.wait(timeout=600), "e2e: generation timed out")
        return time.perf_counter() - t, reqs

    def no_new_graphs(when):
        # a validated grid captures nothing while serving
        if auto:
            n = engine.graph_stats()["graphs"]
            check(n == graphs_ready["graphs"], f"e2e {label}: {n} CUDA "
                  f"graphs {when}, {graphs_ready['graphs']} after "
                  "validation: a capture ran while serving")

    try:
        # warm-up: first launches, then the main run's shapes twice, so
        # that every program key it visits has had its eager first run
        # and its CUDA graph capture (or, on a validated grid, stays the
        # eager key or the graph validation made); the main run replays
        serve(2, 4, 1000)
        warm = [serve(8, 32, 2000 + 100 * i)[0] for i in range(2)]
        log(f"[e2e {label}] warm-up passes of the main run's shape: "
            + ", ".join(f"{w:.3f} s" for w in warm))
        no_new_graphs("after the warm-up passes")
        graphs0 = engine.graph_stats()
        if not auto:
            # what create_engine's auto-sizing would serve with this
            # path's graphs: the same function, over the memory free
            # after the weights less what the warm-up reached above them
            would = port["kv_pool_tokens"](
                model_cfg, cfgs.ResourceConfig(), free_w,
                torch.cuda.max_memory_reserved() - reserved0)
            log(f"[e2e {label}] the auto-sized pool would be {would} tokens "
                f"({free_w >> 20} MiB free after the weights, less the "
                f"{(torch.cuda.max_memory_reserved() - reserved0) >> 20} "
                f"MiB that the warm-up's graphs and eager visits reached)")
        dispatches0 = dict(engine.dispatch_counts)
        kernels.reset_launch_counts()
        elapsed, reqs = serve(8, 32, 0)
        counts = kernels.launch_counts()
        no_new_graphs("after the main run")
        graphs = engine.graph_stats()
        replays = graphs["replays"] - graphs0["replays"]
        dispatches = {k: v - dispatches0[k]
                      for k, v in engine.dispatch_counts.items()}
        log(f"[e2e {label}] launch counts over the main-path run: {counts}")
        peak, held, peak_held = (torch.cuda.max_memory_allocated() >> 20,
                                 torch.cuda.memory_reserved() >> 20,
                                 torch.cuda.max_memory_reserved() >> 20)
        pools = graphs["pool_bytes"] >> 20
        log(f"[e2e {label}] dispatches {dispatches}; CUDA graphs "
            f"{graphs['graphs']} captured, {replays} replays in the run, "
            f"their shared pool {pools} MiB; device memory while serving: "
            f"peak allocated {peak} MiB, held by the allocator (graph pool "
            f"included) {held} MiB, at most {peak_held} MiB, of the card's "
            f"{total >> 20} MiB on {name_limit}")
        check(peak_held < total >> 20, f"e2e {label}: the serving peak "
              f"{peak_held} MiB is not under the card's {total >> 20} MiB")
        if engine.multi_step_block > 1:
            check(dispatches["fed"] + dispatches["continuation"] > 0,
                  f"e2e {label}: no device-fed or continuation dispatch")
            check(replays > 0, f"e2e {label}: no CUDA graph replayed")
        for r in reqs:
            toks = conn.tokens.get(r.id, [])
            check(r.id not in conn.failures,
                  f"e2e: request {r.id} failed: {conn.failures.get(r.id)}")
            check(conn.finish_flags.get(r.id) is not None,
                  f"e2e: request {r.id} did not finish")
            check(len(toks) == 32 and all(0 <= t < V for t in toks),
                  f"e2e: request {r.id} tokens {toks}")
            check(np.isfinite(conn.logprobs[r.id]).all(),
                  f"e2e: request {r.id} logprobs not finite")
        for name in launched:
            check(counts[name] > 0,
                  f"e2e {label}: kernel {name} was never launched")
        for name in idle:
            check(counts[name] == 0,
                  f"e2e {label}: kernel {name} launched {counts[name]} times")
        n_tok = 8 * 32
        prompt_tok = sum(len(r.token_ids) for r in reqs)
        log(f"[e2e {label}] 8 requests, {prompt_tok} prompt tokens, {n_tok} "
            f"generated in {elapsed:.3f} s: {n_tok / elapsed:.1f} "
            f"generated tok/s on {name_limit}")

        # device-time breakdown of the same traffic under torch.profiler
        acts = torch.profiler.ProfilerActivity
        with torch.profiler.profile(activities=[acts.CPU, acts.CUDA]) as prof:
            # the wall runs until the device drains: a speculative block
            # still in flight after the last token is device time too
            t_p = time.perf_counter()
            serve(8, 32, 100)
            torch.cuda.synchronize()
            p_elapsed = time.perf_counter() - t_p
        no_new_graphs("after the profiled run")
        rows = []
        for ev in prof.key_averages():
            if getattr(ev, "device_type", None) != \
                    torch.autograd.DeviceType.CUDA:
                continue
            dev_us = getattr(ev, "self_device_time_total", None)
            if dev_us is None:
                dev_us = getattr(ev, "self_cuda_time_total", 0)
            if dev_us:
                rows.append((dev_us, ev.key, ev.count))
        rows.sort(reverse=True)
        busy_ms = sum(r[0] for r in rows) / 1e3
        log(f"[e2e {label} profile] wall {p_elapsed * 1e3:.1f} ms, device "
            f"busy {busy_ms:.1f} ms ({100 * busy_ms / (p_elapsed * 1e3):.1f}%"
            f" of wall) on {name_limit}; top device kernels (self ms, "
            f"calls):")
        for dev_us, key, cnt in rows[:12]:
            log(f"[e2e {label} profile]   {dev_us / 1e3:9.2f} ms  {cnt:6d}  "
                f"{key[:90]}")
        return dict(path=label, launches=counts, elapsed_s=elapsed,
                    weight_build_peak_mib=engine.weight_build_peak_bytes >> 20,
                    free_after_weights_mib=free_wa >> 20,
                    weights_missing_mib=missing >> 20,
                    gen_tok_per_s=n_tok / elapsed, prompt_tokens=prompt_tok,
                    setup_s=setup_s, profiled_wall_ms=p_elapsed * 1e3,
                    device_busy_ms=busy_ms, dispatches=dispatches,
                    graphs=graphs["graphs"], graph_replays=replays,
                    graph_pool_mib=pools, serving_peak_mib=peak,
                    held_mib=held, peak_held_mib=peak_held,
                    total_mib=total >> 20, kv_tokens=kv_max,
                    kv_gb=kv_bytes / 1e9,
                    batch_buckets=list(engine.batch_buckets),
                    max_prefill_rows=dict(engine.max_prefill_rows),
                    max_running_batch=max_running_batch,
                    tokens={r.id: list(conn.tokens[r.id]) for r in reqs})
    finally:
        gen.shutdown()
        del engine, gen
        torch.cuda.empty_cache()


# ------------------------------------------------------ the server paths


def write_params_json(widths, path):
    """An exporter params.json for ``widths`` (what llm_server reads)."""
    doc = dict(num_heads=widths["num_heads"],
               num_kv_heads=widths["num_kv_heads"],
               num_layers=widths["num_layers"],
               hidden_dim=widths["hidden_dim"],
               intermediate_dim=widths["intermediate_dim"],
               vocab_size=widths["vocab_size"],
               cache_quant_bit=widths.get("cache_quant_bit", 0),
               cache_quant_group=widths.get("cache_quant_group", 1),
               cache_layout=0, cache_mode=widths["cache_mode"],
               page_size=widths["page_size"], dynamic_batching=True,
               auto_causal=True)
    with open(path, "w") as f:
        json.dump(doc, f)


def plan_recorder(engine):
    """Record every plan the engine dispatches: its decode rows and the
    start and length of each live prefill row (the generate thread calls
    dispatch_plan; the list is read after the run)."""
    plans = []
    real = engine.dispatch_plan

    def spy(plan, profiler=None):
        a = plan["arrays"]
        live = a["prefill_len"] > 0
        plans.append((len(plan["decode_idx"]),
                      a["prefill_start"][live].tolist(),
                      a["prefill_len"][live].tolist()))
        return real(plan, profiler)

    engine.dispatch_plan = spy
    return plans


class Served:
    """A server built by llm_server.build_server from ``argv`` and
    started; ``close()`` stops the gRPC server, shuts the generator down
    and fails unless every thread they ran has ended."""

    def __init__(self, port, argv):
        self.server, self.gen, self.engine = port["llm_server"].build_server(
            argv)
        self.server.start()
        self.target = f"127.0.0.1:{self.server.port}"

    def close(self):
        self.server.stop()
        self.gen.shutdown()
        left = [t.name for t in threading.enumerate()
                if t.name in ("generate", "grpc-aio-loop") and t.is_alive()]
        check(not left, f"threads still alive after shutdown: {left}")


def stream_one(port, stub, stats, rid, ids, n, copies=1):
    """One token-in request as its own stream on a blocking channel,
    recorded into client_qps_measure's Stats as its client records them
    (the client's asyncio channel is not used here: grpc.aio in two event
    loops of one process, the server's and a client's, trips over the
    shared completion queue). ``copies`` > 1: that many copies of it in
    the stream's one BatchedRequest, client ids ``rid * copies + r``,
    which a data-parallel router deals to ``copies`` replicas in turn."""
    import grpc
    pb = port["llm_pb2"]
    batched = pb.BatchedRequest()
    cids = [rid * copies + r for r in range(copies)]
    for cid in cids:
        req = batched.req.add()
        req.id = cid
        req.tokens.ids.extend(ids)
        req.stopping_parameters.max_new_tokens = n
        req.stopping_parameters.ignore_eos_token = True
        stats.send_ts[cid] = time.perf_counter()
        stats.in_tokens[cid] = len(ids)
        stats.out_tokens[cid] = 0
        stats.token_ids[cid] = []
    try:
        for b in stub(batched, timeout=600):
            now = time.perf_counter()
            for rsp in b.rsp:
                cid = rsp.id
                if rsp.status == pb.FAILED:
                    stats.failed_ids.add(cid)
                    stats.finish_ts[cid] = now
                    continue
                stats.first_ts.setdefault(cid, now)
                stats.out_tokens[cid] += max(1, len(rsp.tokens.ids))
                stats.token_ids[cid].extend(rsp.tokens.ids)
                if rsp.status == pb.FINISHED:
                    stats.finish_ts[cid] = now
                    stats.finish_reason[cid] = rsp.detail.finish_reason
    except grpc.RpcError:
        for cid in cids:
            stats.failed_ids.add(cid)
            stats.finish_ts[cid] = time.perf_counter()


def stream_requests(port, target, reqs, concurrency, first=(), copies=1):
    """Send ``reqs`` [(rid, token ids, new tokens)] as token-in streams,
    at most ``concurrency`` at a time; ``first`` (the same form) goes out
    before them, and ``reqs`` once every one of ``first`` has its first
    token. ``copies``: that many copies of each request in its stream
    (:func:`stream_one`). Returns (the Stats of ``reqs``, seconds from
    their first send to their last finish, the Stats of ``first``)."""
    import grpc
    from concurrent.futures import ThreadPoolExecutor
    qps, pb = port["client_qps_measure"], port["llm_pb2"]
    stats, lead_stats = qps.Stats(), qps.Stats()
    with grpc.insecure_channel(target) as ch, \
            ThreadPoolExecutor(max(len(first), 1)) as lead_pool:
        stub = ch.unary_stream(
            "/ppl.llm.proto.LLMService/Generation",
            request_serializer=pb.BatchedRequest.SerializeToString,
            response_deserializer=pb.BatchedResponse.FromString)
        lead = [lead_pool.submit(stream_one, port, stub, lead_stats, *r,
                                 copies) for r in first]
        t_end = time.perf_counter() + 600
        while (len(lead_stats.first_ts) < len(first) * copies
               and not any(f.done() for f in lead)
               and time.perf_counter() < t_end):
            time.sleep(0.002)
        t0 = time.perf_counter()
        with ThreadPoolExecutor(concurrency) as workers:
            for f in [workers.submit(stream_one, port, stub, stats, *r,
                                     copies) for r in reqs]:
                f.result()
        elapsed = time.perf_counter() - t0
        for f in lead:
            f.result()
    return stats, elapsed, lead_stats


def check_streams(stats, reqs, label, copies=1):
    for rid, _, n in reqs:
        for cid in range(rid * copies, (rid + 1) * copies):
            toks = stats.token_ids.get(cid, [])
            check(cid not in stats.failed_ids,
                  f"{label}: request {cid} failed")
            check(stats.finish_reason.get(cid) == 0 and len(toks) == n,
                  f"{label}: request {cid} ended with finish reason "
                  f"{stats.finish_reason.get(cid)} after {len(toks)} "
                  f"tokens, want FINISH_REASON_LENGTH after {n}")


def serving_gates(torch, port, served, label, graphs0, counts, plans,
                  launched, idle):
    n_layers = served.engine.model_cfg.num_layers
    graphs = served.engine.graph_stats()["graphs"]
    check(graphs == graphs0, f"{label}: {graphs} CUDA graphs after serving, "
          f"{graphs0} after startup: a capture ran while serving")
    for name in launched:
        check(counts[name] > 0, f"{label}: kernel {name} never launched")
    for name in idle:
        check(counts[name] == 0,
              f"{label}: kernel {name} launched {counts[name]} times")
    hit_steps = sum(any(st > 0 for st in starts) for _, starts, _ in plans)
    return hit_steps * n_layers


def server_prefix_path(torch, port, name_limit, tmp):
    """LLaMA-2-7B widths, online_i8i8 weights, int8 group-8 KV, the prefix
    cache on, served by llm_server's wiring over a socket: one request of
    a 1,024-token shared prefix and a 128-token tail (cold, 9 full
    pages), and once its first token is out, 11 requests of the prefix
    and distinct 64-192-token tails with 4 requests of no shared prefix,
    as 4 concurrent streams; last, the first request's prompt again alone
    (a full hit). 64 greedy new tokens each, ignore_eos."""
    label = "server-7B i8i8 prefix"
    kernels = port["kernels"]
    params = f"{tmp}/llama2_7b_params.json"
    write_params_json(LLAMA7B, params)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = Served(port, [
        "--device", "cuda", "--model-format", "random",
        "--model-param-path", params, "--tokenizer-type", "dummy",
        "--dtype", "bfloat16", "--quant-method", "online_i8i8",
        "--kv-cache-max-tokens", "16384", "--enable-prefix-cache",
        "--max-running-batch", "8", "--token-buckets",
        "256,512,1024,2048", "--max-tokens-per-step", "2048",
        "--max-input-tokens-per-request", "2048",
        "--max-total-tokens-per-request", "4096", "--host", "127.0.0.1",
        "--port", "0"])
    try:
        engine, gen = served.engine, served.gen
        setup_s = time.perf_counter() - t0
        graphs0 = engine.graph_stats()
        log(f"[e2e {label}] llm_server build_server ready in {setup_s:.1f} "
            f"s: {graphs0['graphs']} CUDA graphs "
            f"({graphs0['pool_bytes'] >> 20} MiB pool), batch buckets {engine.batch_buckets}, multi_step "
            f"{engine.multi_step_block}, KV pool "
            f"{gen.kv_cache_max_tokens} tokens ({engine.kv_cache.dtype}); "
            f"peak {torch.cuda.max_memory_allocated() >> 20} MiB on "
            f"{name_limit}")
        V = LLAMA7B["vocab_size"]
        rng = np.random.default_rng(SEED + 8)
        prefix = rng.integers(3, V, 1024).tolist()
        cold = (0, prefix + rng.integers(3, V, 128).tolist(), 64)
        shared = [(1 + i, prefix + rng.integers(3, V, int(n)).tolist(), 64)
                  for i, n in enumerate(rng.integers(64, 193, 11))]
        alone = [(20 + i, rng.integers(3, V, int(n)).tolist(), 64)
                 for i, n in enumerate(rng.integers(256, 1153, 4))]
        mixed = shared[:3] + alone[:1] + shared[3:6] + alone[1:2] + \
            shared[6:9] + alone[2:3] + shared[9:] + alone[3:]
        full = (40, list(cold[1]), 64)
        plans = plan_recorder(engine)
        hits0 = gen.profiler.global_.cache_hit_count
        kernels.reset_launch_counts()
        loop0 = dataclasses.replace(gen.profiler.global_)
        st_main, elapsed, st_cold = stream_requests(
            port, served.target, mixed, 4, first=[cold])
        loop1 = dataclasses.replace(gen.profiler.global_)
        st_full, _, _ = stream_requests(port, served.target, [full], 1)
        counts = kernels.launch_counts()
        hits = gen.profiler.global_.cache_hit_count - hits0
        log(f"[e2e {label}] launch counts over the served run: {counts}")
        check_streams(st_cold, [cold], label)
        check_streams(st_main, mixed, label)
        check_streams(st_full, [full], label)
        want_hits = 11 * 1024 + len(full[1])
        check(hits == want_hits, f"{label}: the prefix cache hit {hits} "
              f"tokens, the prompts imply {want_hits} (11 x 1,024 + the "
              f"full hit's {len(full[1])})")
        k2_hit = serving_gates(
            torch, port, served, label, graphs0["graphs"], counts, plans,
            ATTN + ("i8i8_matmul",), ("w4a8_matmul", "page_read") + ALIBI)
        check(k2_hit > 0, f"{label}: K2 never ran at start > 0")
        qps = port["client_qps_measure"]
        m = qps.summarize(st_main, elapsed)
        cold_ttft = (st_cold.first_ts[0] - st_cold.send_ts[0]) * 1e3
        warm_ttft = (st_full.first_ts[40] - st_full.send_ts[40]) * 1e3
        same = sum(a == b for a, b in zip(st_full.token_ids[40],
                                          st_cold.token_ids[0]))
        graphs = engine.graph_stats()
        n_layers = engine.model_cfg.num_layers
        log(f"[e2e {label}] 17 streams finished with 64 tokens each "
            f"(FINISH_REASON_LENGTH); prefix-cache hits {hits} tokens "
            f"(= 11 x 1,024 + {len(full[1])}); no capture while serving "
            f"({graphs['graphs']} graphs, {graphs['replays']} replays); "
            f"dispatches {engine.dispatch_counts}; "
            f"K2 launches at start > 0: {k2_hit} ({k2_hit // n_layers} steps "
            f"x {n_layers} layers, from the plans) of "
            f"{counts['paged_prefill_attention']}")
        stages = {k: round((getattr(loop1, k + "_cost")
                            - getattr(loop0, k + "_cost")) / 1e3, 1)
                  for k in ("total", "prepare", "set_input", "model_forward",
                            "choose_token", "post_process")}
        log(f"[e2e {label}] rank 0's generator loop over the cold stream and "
            f"the 15 concurrent streams: {loop1.step_cnt - loop0.step_cnt} "
            f"steps, ms by stage {stages} (choose_token: the wait for the "
            f"device's tokens; total less the stages: the plan channel and "
            f"the loop's own Python)")
        log(f"[e2e {label}] TTFT cold {cold_ttft:.1f} ms (1,152-token "
            f"prompt, no hit), warm full hit {warm_ttft:.1f} ms (the same "
            f"prompt, 1,152 tokens hit), client-side over the socket on "
            f"{name_limit}")
        log(f"[e2e {label}] client_qps_measure over the 15 concurrent "
            f"streams (4 at a time): avg prefill latency "
            f"{m['avg_prefill_ms']:.1f} ms, avg decode latency per token "
            f"{m['avg_decode_ms']:.2f} ms, tokens out per sec "
            f"{m['tokens_out_per_s']:.1f}, benchmark time {elapsed:.3f} s "
            f"on {name_limit}")
        log(f"[e2e {label}] the full hit's greedy tokens against the cold "
            f"run of the same prompt: {same} of 64 equal (reported, not "
            f"gated: the hit reads its prefix from int8 pages, the cold "
            f"step its fresh K/V)")
        return dict(path=label, launches=counts, setup_s=setup_s,
                    hits=hits, k2_start_gt0_launches=k2_hit,
                    cold_ttft_ms=cold_ttft, warm_ttft_ms=warm_ttft,
                    avg_prefill_ms=m["avg_prefill_ms"],
                    avg_decode_ms=m["avg_decode_ms"],
                    tokens_out_per_s=m["tokens_out_per_s"],
                    elapsed_s=elapsed, full_hit_tokens_equal=same,
                    graphs=graphs["graphs"], graph_replays=graphs["replays"],
                    dispatches=dict(engine.dispatch_counts),
                    peak_mib=torch.cuda.max_memory_allocated() >> 20)
    finally:
        served.close()
        del served
        gc.collect()
        torch.cuda.empty_cache()


def server_chunked_path(torch, port, name_limit, tmp):
    """TinyLlama-1.1B widths, online_i8i8, chunked prefill of 512 tokens,
    served by llm_server's wiring over a socket: 7 short requests (128
    new tokens each), and once each has its first token, one 3,000-token
    prompt (32 new tokens), fed in 512-token chunks beside the 7 decode
    rows."""
    label = "TinyLlama chunked"
    kernels = port["kernels"]
    params = f"{tmp}/tinyllama_params.json"
    write_params_json(TINY, params)
    gc.collect()
    torch.cuda.empty_cache()
    served = Served(port, [
        "--device", "cuda", "--model-format", "random",
        "--model-param-path", params, "--tokenizer-type", "dummy",
        "--dtype", "bfloat16", "--quant-method", "online_i8i8",
        "--kv-cache-max-tokens", "32768", "--prefill-chunk-tokens", "512",
        "--max-running-batch", "8", "--token-buckets", "256,512,1024",
        "--host", "127.0.0.1", "--port", "0"])
    try:
        engine = served.engine
        graphs0 = engine.graph_stats()
        V = TINY["vocab_size"]
        rng = np.random.default_rng(SEED + 9)
        short = [(i, rng.integers(3, V, int(n)).tolist(), 128)
                 for i, n in enumerate(rng.integers(100, 201, 7))]
        long = (7, rng.integers(3, V, 3000).tolist(), 32)
        plans = plan_recorder(engine)
        kernels.reset_launch_counts()
        t0 = time.perf_counter()
        st_long, _, stats = stream_requests(port, served.target, [long], 1,
                                            first=short)
        elapsed = time.perf_counter() - t0
        counts = kernels.launch_counts()
        log(f"[e2e {label}] launch counts over the served run: {counts}")
        check_streams(stats, short, label)
        check_streams(st_long, [long], label)
        k2_hit = serving_gates(
            torch, port, served, label, graphs0["graphs"], counts, plans,
            ATTN + ("i8i8_matmul",), ("w4a8_matmul", "page_read") + ALIBI)
        mixed = sum(n_dec > 0 and any(st > 0 for st in starts)
                    for n_dec, starts, _ in plans)
        chunks = sum(any(ln == 512 for ln in lens) for _, _, lens in plans)
        check(mixed > 0, f"{label}: no step carried decode rows beside a "
              "prompt chunk")
        check(k2_hit > 0, f"{label}: K2 never ran at start > 0")
        ttft = (st_long.first_ts[7] - st_long.send_ts[7]) * 1e3
        graphs = engine.graph_stats()
        log(f"[e2e {label}] 8 streams finished with their lengths; "
            f"{chunks} steps fed a 512-token chunk; {mixed} steps fed a "
            f"chunk at start > 0 beside decode rows; K2 launches at "
            f"start > 0: {k2_hit} of "
            f"{counts['paged_prefill_attention']}; the long prompt's TTFT "
            f"{ttft:.1f} ms; {elapsed:.3f} s in all; {graphs['graphs']} "
            f"CUDA graphs, {graphs['replays']} replays, dispatches "
            f"{engine.dispatch_counts} on {name_limit}")
        return dict(path=label, launches=counts, mixed_chunk_steps=mixed,
                    chunk_steps=chunks, k2_start_gt0_launches=k2_hit,
                    long_prompt_ttft_ms=ttft, elapsed_s=elapsed)
    finally:
        served.close()
        del served
        gc.collect()
        torch.cuda.empty_cache()


def stream_batch(port, target, reqs):
    """All of ``reqs`` [(client id, token ids, new tokens)] in ONE
    BatchedRequest on one stream: the server hands them to the generator
    in this order (so a data-parallel router deals them round robin in
    this order). Returns (token ids, finish reasons) by client id."""
    import grpc
    pb = port["llm_pb2"]
    batched = pb.BatchedRequest()
    for cid, ids, n in reqs:
        req = batched.req.add()
        req.id = cid
        req.tokens.ids.extend(ids)
        req.stopping_parameters.max_new_tokens = n
        req.stopping_parameters.ignore_eos_token = True
    toks, reasons = {}, {}
    with grpc.insecure_channel(target) as ch:
        stub = ch.unary_stream(
            "/ppl.llm.proto.LLMService/Generation",
            request_serializer=pb.BatchedRequest.SerializeToString,
            response_deserializer=pb.BatchedResponse.FromString)
        for b in stub(batched, timeout=600):
            for rsp in b.rsp:
                check(rsp.status != pb.FAILED,
                      f"request {rsp.id} failed: {rsp.generated}")
                toks.setdefault(rsp.id, []).extend(rsp.tokens.ids)
                if rsp.status == pb.FINISHED:
                    reasons[rsp.id] = rsp.detail.finish_reason
    return toks, reasons


def data_parallel_path(torch, port, name_limit, tmp, n_rep):
    """``--data-parallel-size n_rep`` behind one gRPC frontend, replica i
    on cuda:i, TinyLlama i8i8 with its own weights drawn from the same
    seed on every card. Served twice: with the grid validated at startup
    (every capture on the main thread, before any generate thread runs,
    in the default "global" capture mode), and with
    ``--validate-bucket-grid 0``, where each replica captures a key at its
    second visit on its own generate thread while the others dispatch
    (the engines' "thread_local" capture mode). The same 4
    prompts go to every replica in one BatchedRequest (dealt round
    robin). Gates: every request ends with FINISH_REASON_LENGTH and its
    32 tokens; each replica runs on its own card and dispatched; the
    validated run captures nothing while serving and the other one
    captures on every replica; every replica gives every prompt the same
    greedy tokens, in both runs."""
    label = f"data-parallel x{n_rep}"
    params = f"{tmp}/tinyllama_dp_params.json"
    write_params_json(TINY, params)
    V = TINY["vocab_size"]
    rng = np.random.default_rng(SEED + 10)
    prompts = [rng.integers(3, V, int(n)).tolist()
               for n in rng.integers(100, 401, 4)]
    reqs = [(p * n_rep + r, prompts[p], 32) for p in range(4)
            for r in range(n_rep)]
    tokens = {}
    for validate in (1, 0):
        gc.collect()
        torch.cuda.empty_cache()
        served = Served(port, [
            "--device", "cuda", "--model-format", "random",
            "--model-param-path", params, "--tokenizer-type", "dummy",
            "--dtype", "bfloat16", "--quant-method", "online_i8i8",
            "--kv-cache-max-tokens", "32768", "--max-running-batch", "8",
            "--token-buckets", "256,512", "--data-parallel-size",
            str(n_rep), "--validate-bucket-grid", str(validate),
            "--host", "127.0.0.1", "--port", "0"])
        try:
            engines = [g.engine for g in served.gen._gens]
            devices = [str(e.device) for e in engines]
            check(devices == [f"cuda:{i}" for i in range(n_rep)],
                  f"{label}: replicas on {devices}")
            modes = [e.capture_error_mode for e in engines]
            check(modes == ["global" if validate else "thread_local"]
                  * n_rep, f"{label}: capture modes {modes}")
            graphs0 = [e.graph_stats()["graphs"] for e in engines]
            t0 = time.perf_counter()
            toks, reasons = stream_batch(port, served.target, reqs)
            elapsed = time.perf_counter() - t0
            for cid, _, n in reqs:
                check(reasons.get(cid) == 0 and len(toks.get(cid, [])) == n,
                      f"{label}: request {cid} ended with "
                      f"{reasons.get(cid)} after {len(toks.get(cid, []))} "
                      f"tokens")
            graphs = [e.graph_stats()["graphs"] for e in engines]
            dispatched = [sum(e.dispatch_counts.values()) for e in engines]
            check(all(d > 0 for d in dispatched),
                  f"{label}: dispatches by replica {dispatched}")
            if validate:
                check(graphs == graphs0, f"{label}: graphs {graphs0} -> "
                      f"{graphs} while serving a validated grid")
            else:
                check(all(g > 0 for g in graphs), f"{label}: captured "
                      f"graphs by replica {graphs} with lazy capture")
            for p in range(4):
                same = [toks[p * n_rep + r] for r in range(n_rep)]
                check(all(t == same[0] for t in same), f"{label}: prompt "
                      f"{p}'s tokens differ between replicas")
            tokens[validate] = {p: toks[p * n_rep] for p in range(4)}
            log(f"[e2e {label}] validate-bucket-grid {validate}: "
                f"{len(reqs)} requests on {devices}, dispatches by replica "
                f"{dispatched}, CUDA graphs by replica {graphs0} at startup"
                f" -> {graphs} after serving, {elapsed:.3f} s; each "
                f"prompt's 32 tokens equal on every replica, on "
                f"{name_limit}")
        finally:
            served.close()
            del served
    check(tokens[1] == tokens[0], f"{label}: the validated and the lazily "
          "captured runs differ")
    return dict(path=label, replicas=n_rep)


# ------------------------------------------ a checkpoint, served and scored

# the HF checkpoint path (phase 5): TinyLlama-1.1B's published widths at
# full depth, i8i8 weights over int8 group-8 KV, the weights written as an
# HF checkpoint and a sentencepiece tokenizer.model, both drawn here
HF_LABEL = "TinyLlama hf i8i8 int8-KV"
# the repository's texts the tokenizer's pieces are drawn from
SP_TEXTS = ("README.md", "SURVEY.md", "COMPONENTS.md", "PAPER.md",
            "PAPERS.md", "SNIPPETS.md", "docs/performance.md",
            "docs/llama_guide.md")
SP_SPACE = "▁"
# sentencepiece piece types (sentencepiece_model.proto)
SP_NORMAL, SP_UNKNOWN, SP_CONTROL, SP_BYTE = 1, 2, 3, 6


def hf_state_dict(params, widths):
    """The loader's mapping inverted: the port's float parameters (fused
    layouts) -> HF llama tensors by name, as HF publishes them (untied
    lm_head, q/k/v/o projections, [out, in] matrices)."""
    d, n_q, n_kv = (widths["hidden_dim"], widths["num_heads"],
                    widths["num_kv_heads"])
    hd, g = d // n_q, n_q // n_kv
    sd = {"model.embed_tokens.weight": params["embedding"]}
    for i, lp in enumerate(params["layers"]):
        pre = f"model.layers.{i}"
        wqkv = lp["wqkv"]                       # [D, KVH, G+2, hd]
        sd.update({
            f"{pre}.self_attn.q_proj.weight":
                wqkv[:, :, :g].reshape(d, n_q * hd).T,
            f"{pre}.self_attn.k_proj.weight":
                wqkv[:, :, g].reshape(d, n_kv * hd).T,
            f"{pre}.self_attn.v_proj.weight":
                wqkv[:, :, g + 1].reshape(d, n_kv * hd).T,
            f"{pre}.self_attn.o_proj.weight": lp["wo"].T,
            f"{pre}.mlp.gate_proj.weight": lp["w_gate_up"][:, 0].T,
            f"{pre}.mlp.up_proj.weight": lp["w_gate_up"][:, 1].T,
            f"{pre}.mlp.down_proj.weight": lp["w_down"].T,
            f"{pre}.input_layernorm.weight": lp["attn_norm"],
            f"{pre}.post_attention_layernorm.weight": lp["ffn_norm"],
        })
        if "bqkv" in lp:
            b = lp["bqkv"]                      # [KVH, G+2, hd]
            sd.update({f"{pre}.self_attn.q_proj.bias": b[:, :g].reshape(-1),
                       f"{pre}.self_attn.k_proj.bias": b[:, g].reshape(-1),
                       f"{pre}.self_attn.v_proj.bias":
                           b[:, g + 1].reshape(-1),
                       f"{pre}.self_attn.o_proj.bias": lp["bo"]})
    sd["model.norm.weight"] = params["final_norm"]
    sd["lm_head.weight"] = params["lm_head"].T
    return sd


def write_safetensors(torch, tensors, path):
    """``tensors`` (name -> tensor, any device) as one safetensors file:
    an 8-byte little-endian header length, the JSON header padded to 8
    bytes, then each tensor's bytes, written one tensor at a time."""
    names = {torch.bfloat16: "BF16", torch.float16: "F16",
             torch.float32: "F32"}
    header, offset = {"__metadata__": {"format": "pt"}}, 0
    for name, t in tensors.items():
        n = t.numel() * t.element_size()
        header[name] = {"dtype": names[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    raw = json.dumps(header).encode()
    raw += b" " * (-len(raw) % 8)
    with open(path, "wb") as f:
        f.write(len(raw).to_bytes(8, "little"))
        f.write(raw)
        for t in tensors.values():
            t = t.detach().contiguous().cpu()
            f.write(t.view(torch.uint8).numpy().tobytes())
    return offset


def write_hf_checkpoint(torch, params, widths, out_dir, n_shards=2):
    """An HF llama checkpoint directory from the port's float parameters:
    ``config.json``, ``n_shards`` safetensors shards split by bytes in
    name order, and ``model.safetensors.index.json``."""
    import os
    sd = hf_state_dict(params, widths)
    total = sum(t.numel() * t.element_size() for t in sd.values())
    shards, acc = [[] for _ in range(n_shards)], 0
    for name, t in sd.items():
        shards[min(n_shards - 1, acc * n_shards // total)].append(name)
        acc += t.numel() * t.element_size()
    weight_map = {}
    for i, names in enumerate(shards):
        fn = f"model-{i + 1:05d}-of-{n_shards:05d}.safetensors"
        write_safetensors(torch, {n: sd[n] for n in names},
                          os.path.join(out_dir, fn))
        weight_map.update({n: fn for n in names})
    with open(os.path.join(out_dir, "model.safetensors.index.json"),
              "w") as f:
        json.dump({"metadata": {"total_size": total},
                   "weight_map": weight_map}, f, indent=1)
    doc = {"architectures": ["LlamaForCausalLM"], "model_type": "llama",
           "hidden_size": widths["hidden_dim"],
           "intermediate_size": widths["intermediate_dim"],
           "num_hidden_layers": widths["num_layers"],
           "num_attention_heads": widths["num_heads"],
           "num_key_value_heads": widths["num_kv_heads"],
           "vocab_size": widths["vocab_size"],
           "rms_norm_eps": widths.get("norm_eps", 1e-5),
           "rope_theta": 10000.0, "max_position_embeddings": 2048,
           "tie_word_embeddings": False, "torch_dtype": "bfloat16",
           "bos_token_id": 1, "eos_token_id": 2}
    with open(os.path.join(out_dir, "config.json"), "w") as f:
        json.dump(doc, f, indent=1)
    return total


def _pb_varint(v):
    v &= (1 << 64) - 1
    out = bytearray()
    while True:
        b = v & 0x7F
        v >>= 7
        out.append(b | (0x80 if v else 0))
        if not v:
            return bytes(out)


def _pb_field(num, wire, payload):
    if wire == 2:
        payload = _pb_varint(len(payload)) + payload
    return _pb_varint((num << 3) | wire) + payload


def sp_model_bytes(pieces):
    """A sentencepiece ModelProto: the pieces (piece, score, type), a
    TrainerSpec (unigram, byte fallback, unk/bos/eos 0/1/2, no pad) and
    an identity NormalizerSpec with the dummy prefix and whitespace
    escaping, in protobuf's wire format."""
    import struct
    out = b"".join(_pb_field(1, 2, _pb_field(1, 2, p.encode())
                             + _pb_field(2, 5, struct.pack("<f", s))
                             + _pb_field(3, 0, _pb_varint(t)))
                   for p, s, t in pieces)
    trainer = (_pb_field(3, 0, _pb_varint(1))       # model_type UNIGRAM
               + _pb_field(35, 0, _pb_varint(1))    # byte_fallback
               + _pb_field(40, 0, _pb_varint(0)) + _pb_field(41, 0,
                                                            _pb_varint(1))
               + _pb_field(42, 0, _pb_varint(2))
               + _pb_field(43, 0, _pb_varint(-1)))
    normalizer = (_pb_field(1, 2, b"identity")
                  + _pb_field(3, 0, _pb_varint(1))
                  + _pb_field(4, 0, _pb_varint(0))
                  + _pb_field(5, 0, _pb_varint(1)))
    return out + _pb_field(2, 2, trainer) + _pb_field(3, 2, normalizer)


def sp_pieces(root, vocab_size, texts=SP_TEXTS):
    """A llama-style piece table of ``vocab_size`` pieces: <unk>, <s>,
    </s>, the 256 <0xNN> byte pieces, then NORMAL pieces drawn from the
    repository's ``texts`` under ``root``: each word (most frequent
    first), lower-cased and capitalized, with and without the space
    marker, then their prefixes (with
    and without it) and suffixes, and last every printable ASCII
    character; the NORMAL pieces score
    -log(rank + 2), distinct and falling with rank."""
    import collections
    import math
    import os
    words = collections.Counter()
    for rel in texts:
        with open(os.path.join(root, rel), encoding="utf-8") as f:
            words.update(re.findall(r"[A-Za-z0-9_]+", f.read()))
    ranked = sorted(words, key=lambda w: (-words[w], w))
    singles = [c for c in (chr(i) for i in range(33, 127))]
    singles += [SP_SPACE + c for c in singles] + [SP_SPACE]
    want = vocab_size - 3 - 256 - len(singles)
    seen, normal = set(singles), []
    for cands in ([SP_SPACE + w, w, SP_SPACE + w.lower(), w.lower(),
                   SP_SPACE + w.capitalize(), w.capitalize()]
                  for w in ranked):
        for c in cands:
            if len(c) > 1 and c not in seen and len(normal) < want:
                seen.add(c)
                normal.append(c)
    for w in ranked:
        for k in range(2, len(w)):
            for c in (w[:k], SP_SPACE + w[:k], w[-k:]):
                if c not in seen and len(normal) < want:
                    seen.add(c)
                    normal.append(c)
    check(len(normal) == want, f"tokenizer: {len(normal)} pieces drawn "
          f"from the texts, {want} wanted")
    pieces = [("<unk>", 0.0, SP_UNKNOWN), ("<s>", 0.0, SP_CONTROL),
              ("</s>", 0.0, SP_CONTROL)]
    pieces += [(f"<0x{b:02X}>", 0.0, SP_BYTE) for b in range(256)]
    pieces += [(p, -math.log(r + 2), SP_NORMAL)
               for r, p in enumerate(normal + singles)]
    return pieces


def same_bytes(torch, a, b):
    """Two parameter sets equal byte for byte: the same keys, and every
    tensor of the same dtype, shape and bytes."""
    bits = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}
    if isinstance(a, dict):
        return (isinstance(b, dict) and list(a) == list(b)
                and all(same_bytes(torch, a[k], b[k]) for k in a))
    if isinstance(a, list):
        return (isinstance(b, list) and len(a) == len(b)
                and all(same_bytes(torch, x, y) for x, y in zip(a, b)))
    return (a.dtype == b.dtype and a.shape == b.shape and torch.equal(
        a.contiguous().view(bits[a.element_size()]),
        b.contiguous().view(bits[b.element_size()])))


def serve_prompts(port, engine, model_cfg, gen_cfg, kv_max, tokenizer,
                  prompts, gen_len, id0):
    """Serve ``prompts`` (text) as greedy requests of ``gen_len`` tokens
    through LLMGenerator; returns (seconds, {id: tokens})."""
    conn = port["LocalConnection"]()
    gen = port["LLMGenerator"](model_cfg, gen_cfg, engine, tokenizer, conn,
                               kv_max)
    try:
        reqs = [port["Request"](id=id0 + i, prompt=p,
                                generation_length=gen_len, top_k=1,
                                early_stopping=False)
                for i, p in enumerate(prompts)]
        conn.set_wanted(len(reqs))
        t = time.perf_counter()
        for r in reqs:
            gen.process(r)
        check(conn.wait(timeout=600), "hf path: generation timed out")
        elapsed = time.perf_counter() - t
        for r in reqs:
            toks = conn.tokens.get(r.id, [])
            check(r.id not in conn.failures, f"hf path: request {r.id} "
                  f"failed: {conn.failures.get(r.id)}")
            check(len(toks) == gen_len, f"hf path: request {r.id} gave "
                  f"{len(toks)} tokens")
        return elapsed, {r.id - id0: list(conn.tokens[r.id]) for r in reqs}
    finally:
        gen.shutdown()


def hf_checkpoint_path(torch, port, name_limit, tmp):
    """A user's checkpoint, served and scored on the card. TinyLlama-1.1B
    widths at full depth: the float weights drawn from SEED on the card
    (``init_params``, the draws a random engine of that seed makes) and
    written as an HF checkpoint (two safetensors shards and their index)
    beside a 32,000-piece sentencepiece ``tokenizer.model``; then

    1. an engine built from the checkpoint through the CLI's wiring
       (``--model-format hf``, online_i8i8, ``--cache-quant-bit 8``), its
       quantized parameters byte-equal to a ``random`` engine's of the
       same seed; the load's wall time and its build peak printed;
    2. 8 prompts of the repository's text, encoded by the sentencepiece
       tokenizer, served greedily on both engines: equal tokens, K1, K2
       and K3 launched, K4 not;
    3. ``eval_ppl`` over SURVEY.md at --seq-len 1024 (at most 16 chunks)
       for none and for online_i8i8 + int8 KV: K2 launched 22 times a
       chunk, the NLL finite."""
    import os
    cfgs, kernels, llama = port["config"], port["kernels"], port["llama"]
    widths = dict(TINY)
    ckpt = os.path.join(tmp, "tinyllama-hf")
    os.makedirs(ckpt)
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    floats = llama.init_params(cfgs.ModelConfig(**widths), gen,
                               dtype=torch.bfloat16, device="cuda")
    nbytes = write_hf_checkpoint(torch, floats, widths, ckpt)
    del floats
    pieces = sp_pieces(".", widths["vocab_size"])
    with open(os.path.join(ckpt, "tokenizer.model"), "wb") as f:
        f.write(sp_model_bytes(pieces))
    gc.collect()
    torch.cuda.empty_cache()
    log(f"[{HF_LABEL}] wrote {nbytes / 1e9:.2f} GB of bf16 weights in 2 "
        f"safetensors shards and a {len(pieces)}-piece tokenizer.model in "
        f"{time.perf_counter() - t0:.1f} s")

    common = port["common"]
    parser = __import__("argparse").ArgumentParser()
    common.add_model_args(parser)
    common.add_generator_args(parser)
    args = parser.parse_args([
        "--device", "cuda", "--model-format", "hf", "--model-dir", ckpt,
        "--quant-method", "online_i8i8", "--cache-quant-bit", "8",
        "--kv-cache-max-tokens", "32768", "--max-running-batch", "16",
        "--max-prefill-batch", "8", "--max-output-tokens-per-request",
        "256"])
    model_cfg, rcfg, gen_cfg = common.build_configs(args)
    check(model_cfg.num_layers == 22 and model_cfg.cache_quant_bit == 8
          and rcfg.model_format == "hf", f"hf path: configs {model_cfg}")
    tokenizer = port["create_tokenizer"]("llama", rcfg.tokenizer_path)
    t0 = time.perf_counter()
    engine, kv_max, _ = port["create_engine"](model_cfg, rcfg, gen_cfg)
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    peak = engine.weight_build_peak_bytes
    log(f"[{HF_LABEL}] engine from the checkpoint in {load_s:.2f} s "
        f"(safetensors read, each layer quantized as it is read); weight "
        f"build peak {peak >> 20} MiB on {name_limit}")
    rand, _, _ = port["create_engine"](
        model_cfg, dataclasses.replace(rcfg, model_format="random"), gen_cfg,
        rng_seed=SEED)
    check(same_bytes(torch, engine._params, rand._params),
          "hf path: the loaded parameters differ from the random engine's "
          "of the same seed")
    log(f"[{HF_LABEL}] loaded online_i8i8 parameters equal a random "
        f"engine's (seed {SEED}) byte for byte")

    # the first 8 paragraphs of SURVEY.md of 100-400 tokens
    with open("SURVEY.md", encoding="utf-8") as f:
        paragraphs = f.read().split("\n\n")
    prompts, n_prompt = [], []
    for text in paragraphs:
        n = len(tokenizer.encode(text))
        if 100 <= n <= 400 and len(prompts) < 8:
            prompts.append(text)
            n_prompt.append(n)
    check(len(prompts) == 8, f"hf path: {len(prompts)} prompts")
    # warm-up: each program key of the run visited twice (its eager first
    # run, then its CUDA graph capture), so that the measured run replays
    for i in range(2):
        serve_prompts(port, engine, model_cfg, gen_cfg, kv_max, tokenizer,
                      prompts, 32, 1000 + 100 * i)
    kernels.reset_launch_counts()
    elapsed, toks = serve_prompts(port, engine, model_cfg, gen_cfg, kv_max,
                                  tokenizer, prompts, 32, 0)
    counts = kernels.launch_counts()
    _, toks_rand = serve_prompts(port, rand, model_cfg, gen_cfg, kv_max,
                                 tokenizer, prompts, 32, 0)
    check(toks == toks_rand, "hf path: greedy tokens differ from the "
          "random engine's")
    for name in ATTN + ("i8i8_matmul",):
        check(counts[name] > 0, f"hf path: {name} never launched")
    check(counts["w4a8_matmul"] == 0, "hf path: w4a8_matmul launched")
    log(f"[{HF_LABEL}] 8 prompts of {min(n_prompt)}-{max(n_prompt)} "
        f"sentencepiece tokens ({sum(n_prompt)} in all), 32 greedy tokens "
        f"each in {elapsed:.3f} s: {256 / elapsed:.1f} generated tok/s on "
        f"{name_limit}; equal to the random engine's; launches {counts}")
    sample = tokenizer.decode(toks[0][:12])
    log(f"[{HF_LABEL}] request 0 decodes to {sample!r}")
    del engine, rand
    gc.collect()
    torch.cuda.empty_cache()
    out = {HF_LABEL: dict(path=HF_LABEL, launches=counts, load_s=load_s,
                          weight_build_peak_mib=peak >> 20,
                          gen_tok_per_s=256 / elapsed,
                          prompt_tokens=sum(n_prompt))}

    for quant, extra in (("none", []),
                         ("online_i8i8", ["--cache-quant-bit", "8"])):
        label = f"eval_ppl {quant}" + (" int8-KV" if extra else "")
        gc.collect()
        torch.cuda.empty_cache()
        kernels.reset_launch_counts()
        r = port["eval_ppl"].main([
            "--device", "cuda", "--model-dir", ckpt, "--quant-method", quant,
            "--text-file", "SURVEY.md", "--seq-len", "1024",
            "--max-chunks", "16"] + extra)
        torch.cuda.synchronize()
        counts = kernels.launch_counts()
        layers = widths["num_layers"]
        check(np.isfinite(r["mean_nll"]) and r["tokens"] > 0,
              f"{label}: NLL {r['mean_nll']} over {r['tokens']} tokens")
        check(counts["paged_prefill_attention"] == layers * r["chunks"],
              f"{label}: K2 launched {counts['paged_prefill_attention']} "
              f"times for {r['chunks']} chunks of {layers} layers")
        check((counts["i8i8_matmul"] > 0) == (quant == "online_i8i8")
              and counts["w4a8_matmul"] == 0, f"{label}: launches {counts}")
        steady = r["chunk_ms"][1:] or r["chunk_ms"]
        log(f"[{label}] tokens {r['tokens']}, mean NLL "
            f"{r['mean_nll']:.4f}, perplexity {r['perplexity']:.4f} "
            f"(random weights), {r['chunks']} chunks of 1,024 tokens: "
            f"{sum(steady) / len(steady):.2f} ms a chunk after the first "
            f"({r['chunk_ms'][0]:.1f} ms) on {name_limit}; K2 launched "
            f"{counts['paged_prefill_attention']} times at Qp=1024 "
            f"({layers} a chunk); launches {counts}")
        out[label] = dict(path=label, launches=counts, tokens=r["tokens"],
                          mean_nll=r["mean_nll"],
                          perplexity=r["perplexity"],
                          ms_per_chunk=sum(steady) / len(steady))
    return out


def nll_cross_check(torch, port, widths):
    """make_nll_fn at 2 layers and ``widths``, f32, online_i8i8 weights
    and int8 KV: cuda (K2 at Qp = 512, K3) against cpu (plain versions) on
    the same weights and tokens, 500 valid of 512. The masks must be
    equal and the per-position NLLs within the step cross-check's
    tolerance: three times the largest move that a 1e-6 relative
    perturbation of the attention outputs causes on the cpu (over
    CPU_PERTURB_SEEDS draws), plus 1e-4 of the largest NLL."""
    llama, kv = port["llama"], port["kv"]
    cfg = port["ModelConfig"](**dict(widths, num_layers=2,
                                     dtype="float32"))
    length, n_valid = 512, 500
    pages = length // PS
    spec = kv.CacheSpec(num_layers=2, num_pages=pages, page_size=PS,
                        num_kv_heads=cfg.num_kv_heads, head_dim=cfg.head_dim,
                        quant_bit=8, quant_group=8, dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)
    p_gpu = llama.quantize_model_params(
        llama.init_params(cfg, gen, dtype=torch.float32, device="cuda"),
        "online_i8i8")
    p_cpu = params_to_cpu(p_gpu)
    rng = np.random.default_rng(SEED + 13)
    toks = np.zeros(length, np.int32)
    toks[:n_valid] = rng.integers(3, cfg.vocab_size, n_valid)
    nll_fn = llama.make_nll_fn(cfg, spec, quant_method="online_i8i8")

    def run(params, dev):
        cache, scale = kv.init_cache(spec, dev)
        pt = torch.arange(pages, dtype=torch.int32, device=dev)[None]
        nll, mask = nll_fn(params, cache, scale,
                           torch.from_numpy(toks).to(dev), n_valid, pt)
        return nll.cpu().numpy(), mask.cpu().numpy()

    kernels = port["kernels"]
    k2 = kernels.launch_counts()["paged_prefill_attention"]
    n_g, m_g = run(p_gpu, "cuda")
    k2 = kernels.launch_counts()["paged_prefill_attention"] - k2
    n_c, m_c = run(p_cpu, "cpu")
    check((m_g == m_c).all() and int(m_c.sum()) == n_valid - 1,
          "nll cross-check: masks differ")
    sens = []
    for seed in range(CPU_PERTURB_SEEDS):
        with perturbed_attention(torch, port["pk"], 1e-6,
                                 torch.Generator().manual_seed(seed)):
            n_p, _ = run(p_cpu, "cpu")
        sens.append(float(np.abs(n_p - n_c)[m_c].max()))
    check(np.isfinite(n_g[m_g]).all(), "nll cross-check: NLL not finite")
    err = float(np.abs(n_g - n_c)[m_c].max())
    scale = float(np.abs(n_c[m_c]).max())
    tol = 3 * max(sens) + 1e-4 * scale
    check(err <= tol, f"nll cross-check: max|diff| {err} > {tol}")
    check(k2 == 2, f"nll cross-check: K2 launched {k2} times on cuda")
    return dict(err=err, tol=tol, sensitivity=sens, scale=scale,
                mean_cuda=float(n_g[m_g].mean()),
                mean_cpu=float(n_c[m_c].mean()))


def cpu_mean_nll(job):
    """One cpu score of the accuracy harness, in a worker process: the
    mean NLL of ``eval_nll`` on the cpu (plain versions), its attention
    outputs perturbed by ``perturb = (eps, seed)`` unless None."""
    import torch
    from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention
    from ppl.llm.serving_tpu_torch.tools import eval_accuracy_delta as ead
    perturb, cfg, params, held, seq_len, chunks, kw = job
    torch.set_num_threads(2)

    def mean():
        return float(ead.eval_nll(cfg, params, held, seq_len, chunks,
                                  device="cpu", **kw)[0])

    if perturb is None:
        return mean()
    with perturbed_attention(torch, paged_attention, perturb[0],
                             torch.Generator().manual_seed(perturb[1])):
        return mean()


def accuracy_harness(torch, port, name_limit):
    """``eval_accuracy_delta`` on the card with its default probe (hidden
    256, 4 layers, 8/4 heads, seq 256, page 16) and 300 train steps; its
    verdicts and KL CIs printed as measured (a FAIL is reported, not
    hidden). Hard check: every config's mean NLL from the card kernels
    agrees with the same weights scored through the plain versions on
    the cpu: float32 configs within 1e-4 relative; bf16 and quantized
    configs within three times the largest move that a perturbation of
    the attention outputs causes on the cpu (over CPU_PERTURB_SEEDS draws;
    1e-6 relative in f32, 2^-8 in bf16, about one rounding of each),
    plus 1e-4 relative."""
    ead, kernels = port["eval_accuracy_delta"], port["kernels"]
    args = ead.build_parser().parse_args(["--device", "cuda",
                                          "--train-steps", "300"])
    t0 = time.perf_counter()
    kernels.reset_launch_counts()
    r = ead.run(args)
    counts = kernels.launch_counts()
    card_s = time.perf_counter() - t0
    doc = r["doc"]
    for name, res in doc["results"].items():
        ci = res.get("kl_ci95")
        log(f"[accuracy] {name}: ppl {res['ppl']:.4f}, mean NLL "
            f"{res['mean_nll']:.6f}" + ("" if ci is None else
                                        f", delta ppl {res['delta_ppl']:+.4f}"
                                        f" CI [{res['ci95'][0]:+.4f}, "
                                        f"{res['ci95'][1]:+.4f}], KL "
                                        f"{res['kl_per_tok']:.6f} nats/tok CI"
                                        f" [{ci[0]:.6f}, {ci[1]:.6f}]"))
    log(f"[accuracy] power {'ok' if doc['power_ok'] else 'NO POWER'}, "
        f"int8 budget {doc['budget_nats']:.6f} nats/tok: {doc['verdict']} "
        f"(worst {doc['worst_config']} upper CI {doc['worst_kl_ci95']:.6f});"
        f" int4 budget {doc['budget4_nats']:.6f}: {doc['verdict_int4']}; "
        f"{card_s:.1f} s on {name_limit}; launches {counts}")
    for name in ATTN[1:] + ("i8i8_matmul", "w4a8_matmul"):
        check(counts[name] > 0, f"accuracy harness: {name} never launched")
    # the cpu scores: each config plain, and the bf16 and quantized ones
    # under CPU_PERTURB_SEEDS perturbations, spread over 4 processes
    jobs = []
    for name, kw in ead.CONFIGS:
        params = r["control_params"] if name.startswith("CONTROL") \
            else r["params"]
        job = (r["cfg"], params, r["heldout"], args.seq_len,
               args.eval_chunks, kw)
        jobs.append((name, None) + job)
        if kw["quant_method"] != "none" or kw["cache_quant"] \
                or kw["dtype"] != "float32":
            eps = 1e-6 if kw["dtype"] == "float32" else 2.0 ** -8
            jobs += [(name, (eps, seed)) + job
                     for seed in range(CPU_PERTURB_SEEDS)]
    import multiprocessing
    with multiprocessing.get_context("spawn").Pool(4) as pool:
        means = pool.map(cpu_mean_nll, [j[1:] for j in jobs])
    agree = {}
    for name, _ in ead.CONFIGS:
        mine = [(j[1], m) for j, m in zip(jobs, means) if j[0] == name]
        want = next(m for p, m in mine if p is None)
        sens = [abs(m - want) for p, m in mine if p is not None]
        got = doc["results"][name]["mean_nll"]
        tol = 3 * max(sens, default=0.0) + 1e-4 * abs(want)
        err = abs(got - want)
        log(f"[accuracy] {name}: mean NLL cuda {got:.6f}, cpu {want:.6f}, "
            f"|diff| {err:.3g} (tol {tol:.3g}"
            + (f"; perturbations move it {', '.join(f'{v:.3g}' for v in sens)}"
               f" on cpu" if sens else "") + ")")
        check(err <= tol, f"accuracy harness {name}: mean NLL cuda {got} "
              f"vs cpu {want}: |diff| {err} > {tol}")
        agree[name] = dict(cuda=got, cpu=want, err=err, tol=tol)
    return dict(path="accuracy harness", launches=counts, doc=doc,
                agree=agree, seconds=card_s)


# ------------------------------------------- tensor parallelism, four cards

# LLaMA-2-70B widths (meta-llama/Llama-2-70b-hf config.json: hidden 8192,
# intermediate 28672, 64 heads over 8 kv heads, vocab 32000, 80 layers,
# rms eps 1e-5) with int8 group-8 KV
LLAMA70B = dict(hidden_dim=8192, intermediate_dim=28672, num_layers=80,
                num_heads=64, num_kv_heads=8, vocab_size=32000,
                norm_eps=1e-5, cache_mode=1, page_size=128,
                dtype="bfloat16", cache_quant_bit=8, cache_quant_group=8)
# the tp=n step against one card. Float weights: the same function, within
# tests/test_pallas_tp.py's float bound. i8i8 weights: against one card
# computing the group's function (make_step_fn(emulate_tp=n): each rank
# takes the row-parallel activation scale over its slice), within 3x how
# far perturbing that card's attention outputs by (1 + eps N(0, 1)) moves
# its logits, eps 1e-6 in f32 (phase 4's measure) and 2^-8 in bf16 (the
# block-tail bound's): the all-reduce sums the slices in another order,
# and any difference upstream of an int8 rounding flips some roundings.
# The JAX test's i8i8 bound, 5e-2, is reported beside it.
TP_STEP_TOL = 5e-2
TP_FLOAT_TOL = 1e-3
TP_STEP_LAYERS = 4
TP_TIMEOUT_S = 900


def rank_widths(widths, n):
    """One rank's attention geometry at tp=n: its heads, the head dim."""
    hq, kvh, hd, layers = geometry(widths)
    return dict(num_heads=hq // n, num_kv_heads=kvh // n,
                hidden_dim=hd * hq // n, num_layers=layers)


def rank_matmuls(widths, n):
    """One rank's K3 weights at tp=n: column-parallel wqkv, gate|up and
    lm_head cut along their out channels, row-parallel wo and down along
    the contraction axis."""
    d, inter, v = (widths["hidden_dim"], widths["intermediate_dim"],
                   widths["vocab_size"])
    hq, kvh, hd, _ = geometry(widths)
    return [("wqkv", (d, kvh // n, hq // kvh + 2, hd)),
            ("wo", (hq * hd // n, d)), ("gate|up", (d, 2, inter // n)),
            ("down", (inter // n, d)), ("lm_head", (d, v // n))]


# (quant method, dtype) of the tp step check's cases
TP_STEP_CASES = (("none", "float32"), ("online_i8i8", "float32"),
                 ("online_i8i8", "bfloat16"))


def tp_step_check(torch, port, tp):
    """On every rank of the group: the collectives checked; then, for
    float weights over f32 KV (f32), and for i8i8 weights (int8 lm_head)
    over int8 KV in f32 and in bf16, a prefill and a decode step at
    LLaMA-2-70B widths (TP_STEP_LAYERS layers) on the rank's shard. Each
    i8i8 decode step is then captured as a CUDA graph with its NCCL
    collectives inside and replayed, which must equal its eager run bit
    for bit (its cache write lands in a slot it does not read, so it can
    run again). Rank 0 also runs the steps on one card with the whole
    model, the same weights and the same fed tokens, and returns the
    comparisons. Float: one card, within TP_FLOAT_TOL (the summation
    order). i8i8: one card computing the group's function
    (``emulate_tp=n``), within 3 times how far multiplying that card's
    attention outputs by (1 + eps N(0, 1)) moves its logits over
    PERTURB_SEEDS draws (eps 1e-6 in f32, 2^-8 in bf16); TP_STEP_TOL
    reported beside it. The i8i8 steps are also measured against the
    tp=1 function (reported: the per-slice activation scale makes it
    another function)."""
    llama, kv, samp = port["llama"], port["kv"], port["samp"]
    n, rank = tp.size, tp.rank
    dev = torch.device("cuda", rank)
    check(torch.cuda.current_device() == rank,
          f"rank {rank} runs on cuda:{torch.cuda.current_device()}")
    x = torch.full((4,), float(rank + 1), device=dev)
    tp.all_reduce(x)
    g = tp.all_gather_last(torch.full((2, 3), float(rank), device=dev))
    check(bool((x == n * (n + 1) / 2).all()) and torch.equal(
        g[0], torch.arange(n, device=dev).repeat_interleave(3).float()),
        f"rank {rank}: NCCL all-reduce {x.tolist()} / all-gather {g[0]}")
    log(f"[tp rank {rank}] {torch.cuda.get_device_name(dev)} on cuda:{rank}:"
        f" NCCL all-reduce and all-gather over {n} ranks equal their sums")
    npages, kvp = 8, 4
    plens = np.array([200, 150], np.int32)
    pt = np.full((2, kvp), npages, np.int32)
    pt[0, :2], pt[1, :2] = [0, 1], [2, 3]
    res = {}
    for quant, dtype in TP_STEP_CASES:
        kv8 = quant != "none"
        cfg = port["ModelConfig"](**dict(
            LLAMA70B, num_layers=TP_STEP_LAYERS, dtype=dtype,
            cache_quant_bit=8 if kv8 else 0, cache_quant_group=8 if kv8 else 1))
        tdtype = llama.torch_dtype(dtype)
        spec = kv.CacheSpec(num_layers=TP_STEP_LAYERS, num_pages=npages,
                            page_size=PS, num_kv_heads=cfg.num_kv_heads,
                            head_dim=cfg.head_dim, quant_bit=8 if kv8 else 0,
                            quant_group=8 if kv8 else 1, dtype=tdtype)
        rng = np.random.default_rng(SEED + 13)

        def step_input(bd, tokens=None):
            bp = 2 - bd
            qp = 256 if bp else 1
            f = dict(decode_tokens=np.zeros(bd) if tokens is None else tokens,
                     decode_pos=plens[:bd],
                     prefill_tokens=rng.integers(3, cfg.vocab_size, (bp, qp))
                     if bp else np.zeros((0, qp)),
                     prefill_start=np.zeros(bp), prefill_len=plens[:bp],
                     page_table=pt, context_len=plens + (1 if bd else 0),
                     batch_slots=np.zeros(2))
            t = {k: torch.from_numpy(np.asarray(v, np.int32)).to(dev)
                 for k, v in f.items()}
            ones, zeros = torch.ones(2, device=dev), torch.zeros(2, device=dev)
            return llama.StepInput(sampling=samp.SamplingParams(
                ones, torch.ones(2, dtype=torch.int32, device=dev), zeros,
                torch.zeros(2, dtype=torch.bool, device=dev), ones, zeros,
                zeros), **t)

        params_one = []

        def run(group, emulate=1, perturb=None):
            """(prefill out, decode out, the step, its state) on the
            whole model (group None; the group's function with emulate=n,
            the attention outputs perturbed with a seed) or the rank's
            shard."""
            if group is None and params_one:
                params = params_one[0]
            else:
                gen = torch.Generator(device=dev).manual_seed(SEED + 13)
                params = llama.init_params(
                    cfg, gen, dtype=tdtype, device=dev, quantize=quant,
                    quantize_lm_head=kv8,
                    shard=None if group is None else (rank, n))
                if group is None:
                    params_one.append(params)
            cache, scale = kv.init_cache(
                spec if group is None else kv.shard_spec(spec, n), dev)
            step = llama.make_step_fn(cfg, spec, return_logits=True,
                                      quant_method=quant, greedy_only=True,
                                      tp=group, emulate_tp=emulate)
            cm = torch.zeros((1, 1), dtype=torch.int32, device=dev)
            with contextlib.ExitStack() as stack:
                if perturb is not None:
                    stack.enter_context(perturbed_attention(
                        torch, port["pk"],
                        BLOCK_TAIL_EPS if dtype == "bfloat16" else 1e-6,
                        torch.Generator(device=dev).manual_seed(perturb)))
                out_p = step(params, cache, scale, cm, prefill_inp)
                if dec_inp[0] is None:
                    # every rank feeds the tokens it sampled, the same on
                    # each
                    dec_inp[0] = step_input(2, out_p.tokens.cpu().numpy())
                out_d = step(params, cache, scale, cm, dec_inp[0])
            return out_p, out_d, step, (params, cache, scale, cm)

        def outputs(outs):
            return [(o.logits.float().cpu().numpy(), o.tokens.cpu().numpy())
                    for o in outs]

        prefill_inp, dec_inp = step_input(0), [None]
        out_p, out_d, step, state = run(tp)
        got = outputs((out_p, out_d))
        if kv8:
            side = torch.cuda.Stream(dev)
            side.wait_stream(torch.cuda.current_stream(dev))
            graph = torch.cuda.CUDAGraph()
            with torch.cuda.graph(graph, stream=side,
                                  capture_error_mode="thread_local"):
                out_g = step(*state, dec_inp[0])
            graph.replay()
            torch.cuda.synchronize(dev)
            check(torch.equal(out_g.logits, out_d.logits)
                  and torch.equal(out_g.tokens, out_d.tokens),
                  f"rank {rank}: the {dtype} decode step's graph replay "
                  f"differs from its eager run by "
                  f"{float((out_g.logits - out_d.logits).abs().max())}")
            res["replay_equal"] = res.get("replay_equal", ()) + (dtype,)
            del graph, out_g
        del out_p, out_d, step, state
        torch.cuda.empty_cache()
        if rank:
            continue

        def one_card(emulate=1, perturb=None):
            o = run(None, emulate, perturb)
            out = outputs(o[:2])
            del o
            torch.cuda.empty_cache()
            return out

        want = one_card(n if kv8 else 1)
        plain = one_card() if kv8 else want
        sens = ([max(float(np.abs(a[0] - b[0]).max()) for a, b in
                     zip(one_card(n, seed), want))
                 for seed in range(PERTURB_SEEDS)] if kv8 else None)
        params_one.clear()
        torch.cuda.empty_cache()
        tol = TP_STEP_TOL if kv8 else TP_FLOAT_TOL
        for i, what in enumerate(("prefill", "decode")):
            (lg, tg), (lw, tw), (l1, t1) = got[i], want[i], plain[i]
            d = np.abs(lg - lw)
            excess = float((d / (tol + tol * np.abs(lw))).max())
            check(np.isfinite(lg).all(), f"tp={n} {quant} {dtype} {what}: "
                  "logits not finite")
            bound = 3 * max(sens) if kv8 else None
            if kv8:
                check(float(d.max()) <= bound, f"tp={n} i8i8 {dtype} "
                      f"{what} step: logits max|diff| {float(d.max())} from "
                      f"one card computing the group's function > {bound} "
                      f"(3 x the perturbation measure {sens})")
            else:
                check(excess <= 1.0, f"tp={n} {quant} {dtype} {what} step: "
                      f"logits max|diff| {float(d.max())} from one card "
                      f"(max excess over atol = rtol = {tol}: {excess})")
            d1 = np.abs(lg - l1)
            res[(quant, dtype, what)] = dict(
                err=float(d.max()), std=float(d.std()), excess=excess,
                tol=tol, bound=bound, sensitivity=sens,
                scale=float(np.abs(lw).max()),
                top1_equal=int((tg == tw).sum()), rows=len(tw),
                tp1_err=float(d1.max()), tp1_std=float(d1.std()),
                tp1_excess=float((d1 / (tol + tol * np.abs(l1))).max()),
                tp1_top1_equal=int((tg == t1).sum()))
    return res


def tp_rank_main(rank, n, store_port):
    """``chip_smoke.py --tp-rank R N PORT``: rank R of :func:`tp_steps`'
    group (started by rank 0, which serves the TCP store on PORT)."""
    import datetime
    import torch
    import torch.distributed as dist
    port = tp_port_modules(torch)
    multihost = port["multihost"]
    torch.cuda.set_device(rank)
    store = dist.TCPStore("127.0.0.1", store_port, n, is_master=False,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S))
    multihost.initialize(None, n, rank, store=store)
    try:
        tp_step_check(torch, port, port["shardings"].make_group(n))
    except PhaseError as e:
        log(f"FAIL: rank {rank}: {e}")
        return 1
    dist.destroy_process_group()
    return 0


def tp_steps(torch, port, n):
    """Phases 1 and 2 on ``n`` ranks, one process a card: this process is
    rank 0 and starts ranks 1..n-1 (``--tp-rank``); any rank that fails
    or outlives TP_TIMEOUT_S fails the phase, and every rank is ended."""
    import datetime
    import os
    import torch.distributed as dist
    store = dist.TCPStore("127.0.0.1", 0, n, is_master=True,
                          timeout=datetime.timedelta(seconds=TP_TIMEOUT_S),
                          wait_for_workers=False)
    procs = [subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--tp-rank", str(r),
         str(n), str(store.port)]) for r in range(1, n)]
    try:
        torch.cuda.set_device(0)
        port["multihost"].initialize(None, n, 0, store=store)
        res = tp_step_check(torch, port, port["shardings"].make_group(n))
        dist.destroy_process_group()
        for r, p in enumerate(procs, 1):
            code = p.wait(timeout=TP_TIMEOUT_S)
            check(code == 0, f"rank {r} exited with {code}")
        return res
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def nccl_share(events, trace_summary):
    """The NCCL kernels' share of a trace's device time (their waits for
    the other ranks included)."""
    devs = trace_summary.device_events(events)
    total = sum(e["dur"] for e in devs)
    nccl = sum(e["dur"] for e in devs if "nccl" in e["name"].lower())
    return nccl / total if total else 0.0


def server_70b_argv(params, tp, dp=1, trace_dir=None):
    """``llm_server``'s flags for the 70B server paths: i8i8 weights and
    lm_head, int8 KV, the prefix cache on, ``tp`` ranks a replica, ``dp``
    replicas, a trace of generator steps 10-19 in ``trace_dir``."""
    return ["--device", "cuda", "--model-format", "random",
            "--model-param-path", params, "--tokenizer-type", "dummy",
            "--dtype", "bfloat16", "--quant-method", "online_i8i8",
            "--quantize-lm-head", "--kv-cache-max-tokens", "32768",
            "--enable-prefix-cache", "--max-running-batch", "8",
            "--token-buckets", "256,512,1024,2048", "--max-tokens-per-step",
            "2048", "--max-input-tokens-per-request", "2048",
            "--max-total-tokens-per-request", "4096",
            "--tensor-parallel-size", str(tp), "--data-parallel-size",
            str(dp), *(["--trace-dir", trace_dir] if trace_dir else []),
            "--host", "127.0.0.1", "--port", "0"]


def server_70b_traffic():
    """The 70B server paths' requests ``(id, prompt, new tokens)``: a cold
    1,152-token prompt; 11 prompts on its 1,024-token prefix and 4 others,
    mixed; a full hit of the cold prompt. Returns ``(cold, mixed, full,
    the prefix-cache hit tokens they imply)``."""
    V = LLAMA70B["vocab_size"]
    rng = np.random.default_rng(SEED + 14)
    prefix = rng.integers(3, V, 1024).tolist()
    cold = (0, prefix + rng.integers(3, V, 128).tolist(), 64)
    shared = [(1 + i, prefix + rng.integers(3, V, int(k)).tolist(), 64)
              for i, k in enumerate(rng.integers(64, 193, 11))]
    alone = [(20 + i, rng.integers(3, V, int(k)).tolist(), 64)
             for i, k in enumerate(rng.integers(256, 1153, 4))]
    mixed = shared[:3] + alone[:1] + shared[3:6] + alone[1:2] + \
        shared[6:9] + alone[2:3] + shared[9:] + alone[3:]
    full = (40, list(cold[1]), 64)
    return cold, mixed, full, len(shared) * len(prefix) + len(full[1])


def tp_server_path(torch, port, name_limit, tmp, n, layers=None,
                   trace=True):
    """LLaMA-2-70B i8i8 (int8 lm_head too) int8-KV at full depth (80
    layers) served by
    ``llm_server --tensor-parallel-size n`` over a socket: this process is
    rank 0 (controller and frontend) on cuda:0 and the server starts ranks
    1..n-1. The prefix cache on; the traffic of phase 5's server path: a
    cold 1,152-token prompt, then 11 hits of its 1,024-token prefix and 4
    other prompts as 4 concurrent streams, then a full hit; 64 greedy new
    tokens each. Gates: every stream ends with its length, none fails,
    the exact hit count, no capture while serving, K1-K3 launched on rank
    0, a clean stop of every rank. A trace of generator steps 10-19 on
    every rank gives each rank's busy share and the NCCL kernels' share
    of rank 0's device time (``trace``; untraced, the times can stand
    beside another untraced server's). ``layers``: fewer than the 80
    (with n=1: one card serving one rank's share of the weights'
    bytes)."""
    widths = dict(LLAMA70B, num_layers=layers or LLAMA70B["num_layers"])
    label = (f"server-70B i8i8 int8-KV tp={n}"
             + (f", {layers} layers" if layers else "")
             + ("" if trace else ", untraced"))
    kernels = port["kernels"]
    params = f"{tmp}/llama2_70b_params.json"
    write_params_json(widths, params)
    trace_dir = f"{tmp}/trace70b" if trace else None
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    served = Served(port, server_70b_argv(params, n, trace_dir=trace_dir))
    closed = False
    try:
        engine, gen = served.engine, served.gen
        setup_s = time.perf_counter() - t0
        graphs0 = engine.graph_stats()
        log(f"[e2e {label}] llm_server build_server ready in {setup_s:.1f} "
            f"s with {n} ranks: rank 0 holds {graphs0['graphs']} CUDA graphs "
            f"({graphs0['pool_bytes'] >> 20} MiB pool), batch buckets "
            f"{engine.batch_buckets}, KV pool {gen.kv_cache_max_tokens} "
            f"tokens, its {engine.kv_cache.shape[0]} kv heads "
            f"({engine.kv_cache.dtype}); weight build peak "
            f"{(engine.weight_build_peak_bytes or 0) >> 20} MiB; peak "
            f"{torch.cuda.max_memory_allocated() >> 20} MiB on {name_limit}")
        cold, mixed, full, want_hits = server_70b_traffic()
        plans = plan_recorder(engine)
        hits0 = gen.profiler.global_.cache_hit_count
        kernels.reset_launch_counts()
        loop0 = dataclasses.replace(gen.profiler.global_)
        st_main, elapsed, st_cold = stream_requests(
            port, served.target, mixed, 4, first=[cold])
        loop1 = dataclasses.replace(gen.profiler.global_)
        st_full, _, _ = stream_requests(port, served.target, [full], 1)
        counts = kernels.launch_counts()
        hits = gen.profiler.global_.cache_hit_count - hits0
        log(f"[e2e {label}] rank 0's launch counts over the served run: "
            f"{counts}")
        check_streams(st_cold, [cold], label)
        check_streams(st_main, mixed, label)
        check_streams(st_full, [full], label)
        check(hits == want_hits, f"{label}: the prefix cache hit {hits} "
              f"tokens, the prompts imply {want_hits}")
        serving_gates(torch, port, served, label, graphs0["graphs"], counts,
                      plans, ATTN + ("i8i8_matmul",),
                      ("w4a8_matmul", "page_read") + ALIBI)
        m = port["client_qps_measure"].summarize(st_main, elapsed)
        cold_ttft = (st_cold.first_ts[0] - st_cold.send_ts[0]) * 1e3
        warm_ttft = (st_full.first_ts[40] - st_full.send_ts[40]) * 1e3
        graphs = engine.graph_stats()
        peak = torch.cuda.max_memory_allocated() >> 20
        ts = port["trace_summary"]
        busy, spans, share, groups = {}, {}, None, {}
        for r in range(n if trace else 0):
            path = f"{trace_dir}/rank{r}" if n > 1 else trace_dir
            try:
                events = ts.load_trace(path)
            except FileNotFoundError:
                continue
            devs = ts.device_events(events)
            if not devs:
                continue
            tl = ts.timeline(events, devs)
            busy[r] = tl["busy_share"]
            spans[r] = round(tl["span_ms"], 3)
            groups[r] = {k: (round(us / 1e3, 3), n_) for k, (us, n_) in
                         sorted(ts.by_name(devs, group=True).items(),
                                key=lambda kv: -kv[1][0])}
            if r == 0:
                share = nccl_share(events, ts)
        log(f"[e2e {label}] 17 streams finished with 64 tokens each "
            f"(FINISH_REASON_LENGTH), none failed; prefix-cache hits {hits} "
            f"tokens; no capture while serving ({graphs['graphs']} graphs, "
            f"{graphs['replays']} replays on rank 0); dispatches "
            f"{engine.dispatch_counts}")
        stages = {k: round((getattr(loop1, k + "_cost")
                            - getattr(loop0, k + "_cost")) / 1e3, 1)
                  for k in ("total", "prepare", "set_input", "model_forward",
                            "choose_token", "post_process")}
        log(f"[e2e {label}] rank 0's generator loop over the cold stream and "
            f"the 15 concurrent streams: {loop1.step_cnt - loop0.step_cnt} "
            f"steps, ms by stage {stages} (choose_token: the wait for the "
            f"device's tokens; total less the stages: the plan channel and "
            f"the loop's own Python)")
        log(f"[e2e {label}] TTFT cold {cold_ttft:.1f} ms (1,152-token "
            f"prompt), full hit {warm_ttft:.1f} ms; client_qps_measure over "
            f"the 15 concurrent streams (4 at a time): avg prefill latency "
            f"{m['avg_prefill_ms']:.1f} ms, avg decode latency per token "
            f"(TPOT) {m['avg_decode_ms']:.2f} ms, tokens out per sec "
            f"{m['tokens_out_per_s']:.1f}, benchmark time {elapsed:.3f} s; "
            f"rank 0 peak {peak} MiB; on {name_limit}")
        log(f"[e2e {label}] trace of generator steps 10-19: device busy "
            f"share by rank "
            + (", ".join(f"{r}: {100 * b:.1f} %" for r, b in busy.items())
               or "not measured (no trace written)")
            + f"; span (ms) by rank {spans}; NCCL kernels' share of rank 0's device time "
            + ("not measured" if share is None else f"{100 * share:.1f} %"))
        for r, g in groups.items():
            log(f"[e2e {label}] rank {r}'s device time by group over those "
                f"steps (ms, launches): {g}")
        t_stop = time.perf_counter()
        served.close()
        closed = True
        log(f"[e2e {label}] every rank stopped in "
            f"{time.perf_counter() - t_stop:.1f} s")
        return dict(path=label, launches=counts, setup_s=setup_s, hits=hits,
                    cold_ttft_ms=cold_ttft, warm_ttft_ms=warm_ttft,
                    avg_prefill_ms=m["avg_prefill_ms"],
                    avg_decode_ms=m["avg_decode_ms"],
                    tokens_out_per_s=m["tokens_out_per_s"],
                    elapsed_s=elapsed, busy_share_by_rank=busy,
                    nccl_share_rank0=share, device_ms_by_group=groups,
                    loop_ms_by_stage=stages,
                    graphs=graphs["graphs"],
                    peak_mib=peak)
    finally:
        if not closed:
            served.close()
        del served
        gc.collect()
        torch.cuda.empty_cache()


def cards_and_build(torch, build):
    """The multi-card modes' start: the cards' name and power limit
    (logged, and kept for the failure line), then every kernel source
    built at once; returns the name and limit."""
    name_limit = gpu_name_and_limit()
    CARD[0] = name_limit
    log(f"[card] {name_limit} x {torch.cuda.device_count()} (torch "
        f"{torch.__version__}, CUDA {torch.version.cuda})")
    t0 = time.perf_counter()
    paths = build.build_all()
    log(f"[build] {len(paths)} libraries in "
        f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
    return name_limit


def device_line(torch):
    """The last line of every mode: the platform, the card, the count."""
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


def tp_port_modules(torch):
    """The port's modules the tensor-parallel run uses."""
    from ppl.llm.serving_tpu_torch import config as port_config
    from ppl.llm.serving_tpu_torch.models import llama
    from ppl.llm.serving_tpu_torch.ops import kernels, kv_cache, sampling
    from ppl.llm.serving_tpu_torch.parallel import multihost, shardings
    from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2
    from ppl.llm.serving_tpu_torch.tools import (client_qps_measure,
                                                 llm_server, trace_summary)
    return dict(ModelConfig=port_config.ModelConfig, llama=llama,
                kernels=kernels, kv=kv_cache, samp=sampling,
                multihost=multihost, shardings=shardings, llm_pb2=llm_pb2,
                client_qps_measure=client_qps_measure,
                llm_server=llm_server, trace_summary=trace_summary)


def main_tensor_parallel(n, one_card_share=False):
    """``python3 chip_smoke.py --tensor-parallel N [--one-card-share]`` on
    a machine with N cards: (1) the build and each rank's collectives, (2)
    the tp=N step against one card and its graph replay
    (:func:`tp_steps`); (3) K1-K3 at one rank's LLaMA-2-70B shapes against
    their plain versions; (4) LLaMA-2-70B i8i8 int8-KV served at full
    depth over gRPC by ``llm_server --tensor-parallel-size N``
    (:func:`tp_server_path`); with ``--one-card-share``, (5) one card
    serving 80/N of its layers, the same traffic (a diagnostic, no gate
    of its own); then the kernels line (launches: rank 0's on the served
    path) and the device line, ``count`` N."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        log(f"FAIL: --tensor-parallel {n} needs {n} CUDA GPUs")
        return 1
    try:
        port = tp_port_modules(torch)
        from ppl.llm.serving_tpu_torch.ops import attention as attn_ops
        from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
        from ppl.llm.serving_tpu_torch.ops.kernels import (_build,
                                                           paged_attention,
                                                           quant_matmul)
    except ImportError as e:
        log(f"FAIL: run chip_smoke.py from the root of a checkout ({e})")
        return 1
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    port["pk"] = paged_attention
    t_start = time.perf_counter()
    try:
        name_limit = cards_and_build(torch, _build)
        t0 = time.perf_counter()
        res = tp_steps(torch, port, n)
        for (quant, dtype, what), r in ((k, v) for k, v in res.items()
                                        if isinstance(k, tuple)):
            if quant == "none":
                log(f"[step] LLaMA-2-70B widths, {TP_STEP_LAYERS} layers, "
                    f"{dtype}, float weights, f32 KV, {what} step at tp={n} "
                    f"against one card, the same weights: logits max|diff| "
                    f"{r['err']:.3g}, std {r['std']:.3g} (max |logit| "
                    f"{r['scale']:.3g}; excess over atol = rtol = "
                    f"{r['tol']}: {r['excess']:.3g}, gated); greedy tokens "
                    f"equal on {r['top1_equal']} of {r['rows']} rows")
                continue
            gate = (f"bound 3 x the perturbation measure {r['sensitivity']}"
                    f" = {r['bound']:.3g}, gated; excess over atol = rtol = "
                    f"{r['tol']} (the JAX test's bound): {r['excess']:.3g}, "
                    + ("within it" if r["excess"] <= 1 else "PAST IT"))
            log(f"[step] LLaMA-2-70B widths, {TP_STEP_LAYERS} layers, "
                f"{dtype}, i8i8 weights and lm_head, int8 KV, {what} step "
                f"at tp={n} against one card computing the group's "
                f"function (emulate_tp={n}), the same weights: logits "
                f"max|diff| {r['err']:.3g}, std {r['std']:.3g} (max |logit| "
                f"{r['scale']:.3g}; {gate}); greedy tokens equal on "
                f"{r['top1_equal']} of {r['rows']} rows. Against the tp=1 "
                f"function (reported): max|diff| {r['tp1_err']:.3g}, std "
                f"{r['tp1_std']:.3g}, excess {r['tp1_excess']:.3g}; greedy "
                f"tokens equal on {r['tp1_top1_equal']} of {r['rows']} rows")
        log(f"[step] tp={n} i8i8 decode steps ({', '.join(res['replay_equal'])}"
            f") as CUDA graphs with their NCCL collectives: each replay "
            f"equals its eager run bit for bit on every rank")
        log(f"[phase tp 1-2 ranks, steps] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        timer = Timer(torch)
        label = f"llama2-70b tp={n} rank"
        rw = rank_widths(LLAMA70B, n)
        results = {
            "paged_decode_attention": decode_cases(
                torch, timer, paged_attention, attn_ops, port["kv"], F, rw,
                True, (8,), label + " int8-kv", rel=True),
            "paged_prefill_attention": prefill_cases(
                torch, timer, paged_attention, attn_ops, port["kv"], F, rw,
                True, 2, label + " int8-kv", rel=True),
            "i8i8_matmul": i8i8_cases(
                torch, timer, quant_matmul, quant_ops, LLAMA70B, label,
                weights=rank_matmuls(LLAMA70B, n))}
        del timer
        torch.cuda.empty_cache()
        log(f"[phase tp 3 kernels] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            served = tp_server_path(torch, port, name_limit, tmp, n)
        log(f"[phase tp 4 server] {time.perf_counter() - t0:.1f} s")
        if one_card_share:
            # one card serving one rank's share of the weights' bytes (80/N
            # layers at the whole width), the same traffic: what the N-card
            # server's TPOT can be set beside
            t0 = time.perf_counter()
            with tempfile.TemporaryDirectory() as tmp:
                tp_server_path(torch, port, name_limit, tmp, 1,
                               layers=LLAMA70B["num_layers"] // n)
            log(f"[phase tp 5 one card] {time.perf_counter() - t0:.1f} s")
    except (PhaseError, subprocess.TimeoutExpired) as e:
        log(f"FAIL: {e}")
        return 1
    meta = {
        "paged_decode_attention": (
            "ppl/llm/serving_tpu_torch/csrc/paged_attention.cu",
            "ppl/llm/serving_tpu/ops/pallas/paged_attention.py:522"),
        "paged_prefill_attention": (
            "ppl/llm/serving_tpu_torch/csrc/paged_attention.cu",
            "ppl/llm/serving_tpu/ops/pallas/paged_attention.py:632"),
        "i8i8_matmul": (
            "ppl/llm/serving_tpu_torch/csrc/quant_matmul.cu",
            "ppl/llm/serving_tpu/ops/pallas/quant_matmul.py:253"),
    }
    entries = []
    for name, cases in results.items():
        c = cases[0]
        src, rep = meta[name]
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=served["launches"][name],
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            case=c["case"], n_cases=len(cases)))
    log(f"[done] all tensor-parallel phases passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    log(name_limit)
    device_line(torch)
    return 0


def main_data_parallel(n_rep):
    """``python3 chip_smoke.py --data-parallel N`` on a machine with N
    cards: the card names, the build, and :func:`data_parallel_path`."""
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < n_rep:
        log(f"FAIL: --data-parallel {n_rep} needs {n_rep} CUDA GPUs")
        return 1
    try:
        from ppl.llm.serving_tpu_torch.ops import kernels
        from ppl.llm.serving_tpu_torch.ops.kernels import _build
        from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2
        from ppl.llm.serving_tpu_torch.tools import (client_qps_measure,
                                                     llm_server)
    except ImportError as e:
        log(f"FAIL: run chip_smoke.py from the root of a checkout ({e})")
        return 1
    port = dict(kernels=kernels, llm_server=llm_server,
                client_qps_measure=client_qps_measure, llm_pb2=llm_pb2)
    try:
        name_limit = cards_and_build(torch, _build)
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            data_parallel_path(torch, port, name_limit, tmp, n_rep)
            log(f"[phase dp] {time.perf_counter() - t0:.1f} s")
    except PhaseError as e:
        log(f"FAIL: {e}")
        return 1
    log(name_limit)
    device_line(torch)
    return 0


def dp_tp_server_path(torch, port, name_limit, tmp, dp, tp):
    """LLaMA-2-70B i8i8 (int8 lm_head too) int8-KV at full depth (80
    layers) served by ``llm_server --tensor-parallel-size tp
    --data-parallel-size dp`` over a socket: this process is the frontend
    and replica 0's controller on cuda:0 (its workers on cuda:1..tp-1);
    replica i's controller is a child process on cuda:i*tp with its own
    workers. The traffic of the tp=4 path (:func:`tp_server_path`), each
    request sent ``dp`` times in its stream's one BatchedRequest, so the
    router deals one copy to each replica: a cold 1,152-token prompt,
    then 11 hits of its 1,024-token prefix and 4 other prompts as 4
    concurrent streams, then a full hit; 64 greedy new tokens each.
    Gates: each replica's ranks on their own cards (as each rank names
    its device); every stream ends with FINISH_REASON_LENGTH and 64
    tokens; every replica took a copy of every request and dispatched;
    each replica's prefix-cache hits are the ones its prompts imply;
    each prompt's greedy tokens equal on every replica; no capture while
    serving on any replica; K1-K3 launched on every replica's controller;
    every process exits with 0 at the stop."""
    label = f"server-70B i8i8 int8-KV dp={dp} x tp={tp}"
    kernels = port["kernels"]
    params = f"{tmp}/llama2_70b_params.json"
    write_params_json(LLAMA70B, params)
    gc.collect()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    served = Served(port, server_70b_argv(params, tp, dp))
    closed = False
    try:
        setup_s = time.perf_counter() - t0
        reps = served.gen._gens
        engine = served.engine
        placed = [r.devices for r in reps]
        want = [[f"cuda:{i * tp + k}" for k in range(tp)] for i in range(dp)]
        check(placed == want, f"{label}: ranks by replica on {placed}, want "
              f"{want}")
        graphs0 = [engine.graph_stats()["graphs"]] + [r.info["graphs"]
                                                      for r in reps[1:]]
        log(f"[e2e {label}] llm_server build_server ready in {setup_s:.1f} "
            f"s: ranks by replica {placed}; CUDA graphs by replica "
            f"{graphs0}; KV pool {reps[0].generator.kv_cache_max_tokens} "
            f"tokens a replica; on {name_limit}")
        cold, mixed, full, want_hits = server_70b_traffic()
        hits0 = reps[0].generator.profiler.global_.cache_hit_count
        kernels.reset_launch_counts()
        st_main, elapsed, st_cold = stream_requests(
            port, served.target, mixed, 4, first=[cold], copies=dp)
        st_full, _, _ = stream_requests(port, served.target, [full], 1,
                                        copies=dp)
        counts = kernels.launch_counts()
        hits = [reps[0].generator.profiler.global_.cache_hit_count - hits0]
        graphs_r0 = engine.graph_stats()["graphs"]
        dispatched_r0 = dict(engine.dispatch_counts)
        for st, reqs in ((st_cold, [cold]), (st_main, mixed),
                         (st_full, [full])):
            check_streams(st, reqs, label, copies=dp)
            for rid, _, _ in reqs:
                toks = [st.token_ids[rid * dp + r] for r in range(dp)]
                check(all(t == toks[0] for t in toks), f"{label}: request "
                      f"{rid}'s greedy tokens differ between replicas")
        tasks = [r.tasks for r in reps]
        check(tasks == [len(mixed) + 2] * dp, f"{label}: tasks by replica "
              f"{tasks}, want {len(mixed) + 2} each")
        m = port["client_qps_measure"].summarize(st_main, elapsed)
        cold_ttft = [(st_cold.first_ts[r] - st_cold.send_ts[r]) * 1e3
                     for r in range(dp)]
        full_ttft = [(st_full.first_ts[40 * dp + r]
                      - st_full.send_ts[40 * dp + r]) * 1e3
                     for r in range(dp)]
        t_stop = time.perf_counter()
        served.close()
        closed = True
        stop_s = time.perf_counter() - t_stop
        reports = [r.report for r in reps[1:]]
        check(all(rep is not None for rep in reports),
              f"{label}: a replica sent no report at its stop")
        graphs = [graphs_r0] + [rep["graphs"]["graphs"] for rep in reports]
        dispatches = [dispatched_r0] + [rep["dispatch_counts"]
                                        for rep in reports]
        launches = [counts] + [rep["launches"] for rep in reports]
        hits += [rep["cache_hit_count"] for rep in reports]
        codes = ([p.returncode for p in reps[0].workers]
                 + [r.proc.returncode for r in reps[1:]]
                 + [c for rep in reports for c in rep["worker_exit_codes"]])
        log(f"[e2e {label}] {len(mixed) + 2} requests x {dp} copies ended "
            f"with 64 tokens each (FINISH_REASON_LENGTH), none failed; each "
            f"request's greedy tokens equal on every replica; tasks by "
            f"replica {tasks}; dispatches by replica {dispatches}; CUDA "
            f"graphs by replica {graphs0} at startup, {graphs} after "
            f"serving; prefix-cache hit tokens by replica {hits}; launches "
            f"by replica {launches}; exit codes of the other processes "
            f"{codes}")
        log(f"[e2e {label}] TTFT cold {[round(t, 1) for t in cold_ttft]} ms "
            f"(1,152-token prompt, by replica), full hit "
            f"{[round(t, 1) for t in full_ttft]} ms; client_qps_measure over "
            f"the {len(mixed)} x {dp} concurrent requests (4 streams of {dp}"
            f"): avg prefill latency {m['avg_prefill_ms']:.1f} ms, avg "
            f"decode latency per token (TPOT) {m['avg_decode_ms']:.2f} ms, "
            f"tokens out per sec {m['tokens_out_per_s']:.1f}, benchmark "
            f"time {elapsed:.3f} s; startup {setup_s:.1f} s; stopped in "
            f"{stop_s:.1f} s; on {name_limit}")
        check(hits == [want_hits] * dp, f"{label}: the prefix cache hit "
              f"{hits} tokens by replica, the prompts imply {want_hits} "
              "each")
        check(graphs == graphs0, f"{label}: CUDA graphs by replica "
              f"{graphs0} at startup, {graphs} after serving: a capture ran "
              "while serving")
        check(all(sum(d.values()) > 0 for d in dispatches),
              f"{label}: dispatches by replica {dispatches}")
        for i, c in enumerate(launches):
            for name in ATTN + ("i8i8_matmul",):
                check(c[name] > 0, f"{label}: replica {i}: {name} never "
                      "launched")
            for name in ("w4a8_matmul", "page_read") + ALIBI:
                check(c[name] == 0, f"{label}: replica {i}: {name} "
                      f"launched {c[name]} times")
        check(codes == [0] * (dp * tp - 1), f"{label}: exit codes of the "
              f"other {dp * tp - 1} processes {codes}")
        return dict(path=label, setup_s=setup_s, cold_ttft_ms=cold_ttft,
                    full_hit_ttft_ms=full_ttft,
                    avg_prefill_ms=m["avg_prefill_ms"],
                    avg_decode_ms=m["avg_decode_ms"],
                    tokens_out_per_s=m["tokens_out_per_s"],
                    elapsed_s=elapsed, tasks=tasks, dispatches=dispatches,
                    hits=hits, launches=launches, stop_s=stop_s)
    finally:
        if not closed:
            served.close()
        del served
        gc.collect()
        torch.cuda.empty_cache()


def main_dp_tp(dp, tp):
    """``python3 chip_smoke.py --data-parallel D --tensor-parallel T`` on a
    machine with D x T cards: the build, then LLaMA-2-70B i8i8 int8-KV
    served by D replicas of T-card tensor-parallel groups behind one
    frontend (:func:`dp_tp_server_path`); beside it, the same cards as one
    tp=D*T group on the same traffic, sent once (:func:`tp_server_path`,
    untraced like the replicas; its gates, its times only reported);
    then the device line, ``count`` the cards PyTorch sees."""
    import torch
    n = dp * tp
    if not torch.cuda.is_available() or torch.cuda.device_count() < n:
        log(f"FAIL: --data-parallel {dp} --tensor-parallel {tp} needs {n} "
            "CUDA GPUs")
        return 1
    try:
        port = tp_port_modules(torch)
        from ppl.llm.serving_tpu_torch.ops.kernels import _build
    except ImportError as e:
        log(f"FAIL: run chip_smoke.py from the root of a checkout ({e})")
        return 1
    t_start = time.perf_counter()
    try:
        name_limit = cards_and_build(torch, _build)
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            both = dp_tp_server_path(torch, port, name_limit, tmp, dp, tp)
        log(f"[phase dp x tp server] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            one = tp_server_path(torch, port, name_limit, tmp, n, trace=False)
        log(f"[phase dp x tp beside: tp={n}] {time.perf_counter() - t0:.1f} s")
        log(f"[dp x tp] this run, both untraced, the same requests: dp={dp} "
            f"x tp={tp} (each request on both replicas) TPOT "
            f"{both['avg_decode_ms']:.2f} ms, {both['tokens_out_per_s']:.1f} "
            f"tokens out/s, startup {both['setup_s']:.1f} s; tp={n} (each "
            f"request once) TPOT {one['avg_decode_ms']:.2f} ms, "
            f"{one['tokens_out_per_s']:.1f} tokens out/s, startup "
            f"{one['setup_s']:.1f} s; on {name_limit} (reported, not gated)")
    except (PhaseError, subprocess.TimeoutExpired) as e:
        log(f"FAIL: {e}")
        return 1
    log(f"[done] the dp={dp} x tp={tp} path passed in "
        f"{time.perf_counter() - t_start:.1f} s")
    log(name_limit)
    device_line(torch)
    return 0


def main():
    try:
        import torch
    except ImportError:
        log("FAIL: PyTorch is not installed")
        return 1
    if not torch.cuda.is_available():
        log("FAIL: torch.cuda.is_available() is false; chip_smoke.py needs "
            "one CUDA GPU")
        return 1
    try:
        from ppl.llm.serving_tpu_torch import config as port_config
        from ppl.llm.serving_tpu_torch import engine as port_engine
        from ppl.llm.serving_tpu_torch.connection import LocalConnection
        from ppl.llm.serving_tpu_torch.generator import LLMGenerator
        from ppl.llm.serving_tpu_torch.models import llama
        from ppl.llm.serving_tpu_torch.ops import attention as attn_ops
        from ppl.llm.serving_tpu_torch.ops import kernels
        from ppl.llm.serving_tpu_torch.ops import kv_cache
        from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
        from ppl.llm.serving_tpu_torch.ops import sampling
        from ppl.llm.serving_tpu_torch.ops.kernels import _build
        from ppl.llm.serving_tpu_torch.request import Request
        from ppl.llm.serving_tpu_torch.resources import (create_engine,
                                                         kv_pool_tokens)
        from ppl.llm.serving_tpu_torch.tokenizer.factory import ByteTokenizer
        from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2
        from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer
        from ppl.llm.serving_tpu_torch.tools import (client_qps_measure,
                                                     common,
                                                     eval_accuracy_delta,
                                                     eval_ppl, llm_server)
        from ppl.llm.serving_tpu_torch.tools.trace_summary import demangle
    except ImportError as e:
        log(f"FAIL: run chip_smoke.py from the root of a checkout ({e})")
        return 1
    import torch.nn.functional as F
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from ppl.llm.serving_tpu_torch.ops.kernels import cache_read
    from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention
    from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul
    port = dict(config=port_config, kernels=kernels, llama=llama,
                pk=paged_attention, engine=port_engine,
                kv=kv_cache, samp=sampling,
                ModelConfig=port_config.ModelConfig,
                create_engine=create_engine,
                kv_pool_tokens=kv_pool_tokens,
                LocalConnection=LocalConnection, LLMGenerator=LLMGenerator,
                Request=Request, ByteTokenizer=ByteTokenizer,
                llm_server=llm_server, client_qps_measure=client_qps_measure,
                llm_pb2=llm_pb2, common=common, eval_ppl=eval_ppl,
                eval_accuracy_delta=eval_accuracy_delta,
                create_tokenizer=create_tokenizer)
    t_start = time.perf_counter()
    try:
        name_limit = gpu_name_and_limit()
        CARD[0] = name_limit
        log(name_limit)
        log(f"[card] {name_limit} ({torch.cuda.get_device_name(0)}, torch "
            f"{torch.__version__}, CUDA {torch.version.cuda})")

        t0 = time.perf_counter()
        paths = _build.build_all()
        log(f"[build] {len(paths)} libraries in "
            f"{time.perf_counter() - t0:.1f} s (nvcc, sm_90a, in parallel)")
        for src in _build.SOURCES:
            fn = "?"
            for line in _build.ptxas_report(src).splitlines():
                if "Compiling entry" in line:
                    fn = demangle(line.split("'")[1])
                elif "registers" in line or "spill" in line:
                    log(f"[build] {src} {fn}: {line.strip()}")
        tensor_core_check()
        bulk_copy_check()

        timer = Timer(torch)
        results = {name: [] for name in kernels.WRAPPERS}
        t0 = time.perf_counter()
        floor = launch_floor(torch, timer)
        for widths, quantized, label, batches, which in (
                (TINY, False, "tinyllama", (8, 64), 3),
                (LLAMA7B, True, "llama2-7b int8-kv", (8,), 4),
                (TINY, True, "tinyllama int8-kv", (8,), 1)):
            results["paged_decode_attention"] += decode_cases(
                torch, timer, paged_attention, attn_ops, kv_cache, F, widths,
                quantized, batches, label)
            results["paged_prefill_attention"] += prefill_cases(
                torch, timer, paged_attention, attn_ops, kv_cache, F, widths,
                quantized, which, label)
            torch.cuda.empty_cache()
        for widths, quantized, label, tail_lens in (
                (LLAMA7B, True, "llama2-7b int8-kv", (1, 7)),
                (TINY, False, "tinyllama", (1, 7))):
            results["paged_decode_attention"] += tail_cases(
                torch, timer, paged_attention, attn_ops, kv_cache, F, widths,
                quantized, tail_lens, label)
            torch.cuda.empty_cache()
        # the ALiBi branches: Baichuan-13B widths over int8 pages (G=1),
        # TinyLlama's over bf16 pages (G=8) with 32 heads' slopes
        for widths, quantized, label, tail_lens, which in (
                (BAICHUAN13B, True, "baichuan-13b int8-kv alibi",
                 (None, 1, 7), 2),
                (TINY, False, "tinyllama alibi", (None,), 1)):
            results["paged_decode_attention"] += tail_cases(
                torch, timer, paged_attention, attn_ops, kv_cache, F, widths,
                quantized, tail_lens, label, alibi=True)
            results["paged_prefill_attention"] += prefill_cases(
                torch, timer, paged_attention, attn_ops, kv_cache, F, widths,
                quantized, which, label, alibi=True)
            torch.cuda.empty_cache()
        # the NLL forward's row (make_nll_fn, eval_ppl): TinyLlama widths,
        # bf16 and int8 KV
        for quantized, label in ((False, "tinyllama"),
                                 (True, "tinyllama int8-kv")):
            results["paged_prefill_attention"] += prefill_cases(
                torch, timer, paged_attention, attn_ops, kv_cache, F, TINY,
                quantized, 1, label, nll=True)
        torch.cuda.empty_cache()
        for widths, label, ts in ((TINY, "tinyllama", (8, 1024)),
                                  (BAICHUAN13B, "baichuan-13b",
                                   (8, 16, 64, 1024, 4096))):
            results["i8i8_matmul"] += i8i8_cases(torch, timer, quant_matmul,
                                                 quant_ops, widths, label, ts)
        results["w4a8_matmul"] = w4a8_cases(torch, timer, quant_matmul,
                                            quant_ops)
        results["page_read"] = page_read_cases(torch, timer, cache_read,
                                               floor)
        # the canonical path's widths: LLaMA-2-7B i8i8 over int8 KV at its
        # decode buckets 32 and 64; and the b64 bench's tile at TinyLlama
        ts = time.perf_counter()
        results["paged_decode_attention"] += decode_cases(
            torch, timer, paged_attention, attn_ops, kv_cache, F, LLAMA7B,
            True, (32, 64), "llama2-7b int8-kv")
        torch.cuda.empty_cache()
        for widths, label, tokens in ((LLAMA7B, "llama2-7b", (32, 64)),
                                      (TINY, "tinyllama", (64,))):
            results["i8i8_matmul"] += i8i8_cases(
                torch, timer, quant_matmul, quant_ops, widths, label, tokens)
        log(f"[phase 3] the canonical path's rows (K1 7B int8 KV B=32/64, "
            f"K3 7B T=32/64, K3 TinyLlama T=64): "
            f"{time.perf_counter() - ts:.1f} s")
        del timer
        torch.cuda.empty_cache()
        log(f"[phase 3] {time.perf_counter() - t0:.1f} s")

        t0 = time.perf_counter()
        steps = {}
        for key, quant, widths in (
                ("tinyllama none", "none", TINY),
                ("tinyllama i8i8", "online_i8i8", TINY),
                ("baichuan-13b i8i8", "online_i8i8", BAICHUAN13B),
                ("internlm-7b i8i8", "online_i8i8", INTERNLM7B)):
            ts = time.perf_counter()
            sx = steps[key] = step_cross_check(torch, port, quant, widths)
            sx["s"] = time.perf_counter() - ts
            sens = ("" if not sx["sensitivity"] else
                    "; 1e-6 attention perturbations move them "
                    + ", ".join(f"{v:.3g}" for v in sx["sensitivity"])
                    + " on cpu")
            log(f"[step] 2-layer D={sx['width']} f32 {sx['quant']} mixed "
                f"step, cuda kernels vs cpu plain: logits max|diff| "
                f"{sx['logit_max_abs_err']:.3g} (tol {sx['tol']:.3g}; "
                f"max|logit| {sx['logit_scale']:.3g}{sens}), "
                f"cache max|diff| {sx['cache_max_abs_err']:.3g} (tol "
                f"{sx['cache_tol']:.3g}); greedy "
                f"tokens cuda {sx['tokens_cuda']} cpu {sx['tokens_cpu']} "
                f"(equal on {sx['rows_decided']}/{sx['rows']} rows whose "
                f"top-2 margin exceeds twice the logit error; "
                f"{sx['s']:.1f} s)")
            torch.cuda.empty_cache()
        # the cpu run of a block (its plain versions, ~7-18 s at these
        # widths) only for the 13B block without the tail, which the 13B
        # step check's tolerances hold: cut, with the w4a8 step check, to
        # keep the whole run well inside the 1,200 s limit; block-tail
        # mode is held on cuda by block_tail_bound at full depth
        for key, quant, widths, block_tail in (
                ("llama2-7b w4a8", "online_w4a8", LLAMA7B, "auto"),
                ("llama2-7b w4a8", "online_w4a8", LLAMA7B, "on"),
                ("baichuan-13b i8i8", "online_i8i8", BAICHUAN13B, "auto"),
                ("baichuan-13b i8i8", "online_i8i8", BAICHUAN13B, "on")):
            against_cpu = key in steps and block_tail == "auto"
            ts = time.perf_counter()
            bx = block_cross_check(torch, port, block_tail, steps.get(key),
                                   widths, quant, against_cpu)
            vs_cpu = "not run against the cpu" if not against_cpu else (
                f"cuda vs cpu: greedy tokens equal {bx['tokens']}, logprobs "
                f"max|diff| {bx['logprob_max_abs_err']:.3g}, written cache "
                f"rows ({bx['rows_written']}) max|diff| "
                f"{bx['cache_max_abs_err']:.3g} (tol "
                f"{steps[key]['cache_tol']:.3g})")
            alibi = (" + ALiBi" if widths.get("position_encoding")
                     == "alibi" else "")
            log(f"[block] 2-layer D={widths['hidden_dim']} f32 {quant} + "
                f"int8 KV{alibi}, 4-step block, "
                f"block_tail={block_tail}: CUDA graph replay equals the "
                f"eager block bit for bit (launches per replay "
                f"{ {k: n for k, n in bx['graph_launches'].items() if n} }); "
                f"{vs_cpu}; {time.perf_counter() - ts:.1f} s")
            torch.cuda.empty_cache()
        ts = time.perf_counter()
        bt = block_tail_bound(torch, port)
        log(f"[block] LLaMA-2-7B widths, 32 layers, bf16, w4a8 + int4 "
            f"lm_head + int8 KV, one {bt['steps']}-step block on cuda, "
            f"block_tail=on against the per-step writes: logits max|diff| "
            f"{bt['err']:.3g} over {bt['compared']} (step, row) pairs up to "
            f"each row's first differing token (tol {bt['tol']:.3g}: 3 x "
            f"how far 2^-8 attention perturbations move the per-step "
            f"block, " + ", ".join(f"{v:.3g}" for v in bt["sensitivity"])
            + f"; max|logit| {bt['scale']:.3g}); {bt['rows_equal']} of "
            f"{bt['rows']} rows' {bt['steps']} greedy tokens equal "
            f"({time.perf_counter() - ts:.1f} s)")
        ts = time.perf_counter()
        px = prefix_chunk_cross_check(torch, port, LLAMA7B)
        for name, r in px.items():
            log(f"[step] 2-layer D={LLAMA7B['hidden_dim']} f32 online_i8i8 "
                f"+ int8 KV {name} step (prefill_start {r['start']}, "
                f"{r['new']} new tokens over a cache the cold step wrote on "
                f"the same device), cuda vs cpu: logits max|diff| "
                f"{r['logit_max_abs_err']:.3g} (tol {r['tol']:.3g}; max|logit|"
                f" {r['logit_scale']:.3g}; 1e-6 attention perturbations of "
                f"both steps move them "
                + ", ".join(f"{v:.3g}" for v in r["sensitivity"])
                + f" on cpu), cache max|diff| {r['cache_max_abs_err']:.3g} "
                f"(tol {r['cache_tol']:.3g}); greedy tokens cuda "
                f"{r['tokens_cuda']} cpu {r['tokens_cpu']} (equal on "
                f"{r['rows_decided']}/{r['rows']} decided rows)")
        log(f"[step] prefix-hit and chunk steps: "
            f"{time.perf_counter() - ts:.1f} s")
        ts = time.perf_counter()
        nx = nll_cross_check(torch, port, LLAMA7B)
        log(f"[nll] 2-layer D={LLAMA7B['hidden_dim']} f32 online_i8i8 + "
            f"int8 KV make_nll_fn, one 512-token row (500 valid), cuda "
            f"(K2 at Qp=512, K3) vs cpu: masks equal, NLL max|diff| "
            f"{nx['err']:.3g} (tol {nx['tol']:.3g}; max NLL "
            f"{nx['scale']:.3g}; 1e-6 attention perturbations move it "
            + ", ".join(f"{v:.3g}" for v in nx["sensitivity"])
            + f" on cpu); mean NLL cuda {nx['mean_cuda']:.6f} cpu "
            f"{nx['mean_cpu']:.6f} ({time.perf_counter() - ts:.1f} s)")
        torch.cuda.empty_cache()
        log(f"[phase 4] {time.perf_counter() - t0:.1f} s")

        e2e = {}
        for label, widths, resource, launched, idle in PATHS:
            t0 = time.perf_counter()
            e2e[label] = end_to_end(torch, port, name_limit, label, widths,
                                    resource, launched, idle)
            log(f"[phase 5 {label}] {time.perf_counter() - t0:.1f} s")
        with tempfile.TemporaryDirectory() as tmp:
            for label, path_fn in (
                    ("server-7B i8i8 prefix", server_prefix_path),
                    ("TinyLlama chunked", server_chunked_path)):
                t0 = time.perf_counter()
                e2e[label] = path_fn(torch, port, name_limit, tmp)
                log(f"[phase 5 {label}] {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            e2e.update(hf_checkpoint_path(torch, port, name_limit, tmp))
            log(f"[phase 5 {HF_LABEL}] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        e2e["accuracy harness"] = accuracy_harness(torch, port, name_limit)
        log(f"[phase 5 accuracy harness] {time.perf_counter() - t0:.1f} s")
        base = e2e["llama2-7b w4a8 int8-kv"]["tokens"]
        for label in ("llama2-7b w4a8 int8-kv blocks",
                      "llama2-7b w4a8 int8-kv block-tail"):
            got = e2e[label]["tokens"]
            same = sum(got[i] == base[i] for i in base)
            e2e[label]["requests_equal_to_multi_step_1"] = same
            log(f"[e2e {label}] {same} of {len(base)} requests' 32 tokens "
                f"equal the multi_step=1 path's (reported, not gated: bf16 "
                f"sums may run in another order)")
        t0 = time.perf_counter()
        e2e["microbench"] = microbench(torch, kernels, name_limit)
        log(f"[phase 6 microbench] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        gc.collect()
        torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            tools_out = tools_phase(name_limit, tmp)
        e2e.update((k, v) for k, v in tools_out.items() if k in
                   dict(BENCHES))
        log(f"[phase 7 tools] {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            e2e.update(canonical_phase(name_limit, tmp))
        log(f"[phase 8 canonical] {time.perf_counter() - t0:.1f} s")
    except (PhaseError, subprocess.TimeoutExpired) as e:
        log(f"FAIL: {e}")
        return 1

    # per kernel: the representative case (the first whose name starts so:
    # this kernel's heaviest use on the newest path that runs it, bf16 out)
    # and the path whose run its launch count is read from (K5: the
    # microbench, its entry point)
    main_case = {
        "paged_decode_attention": ("baichuan-13b int8-kv alibi deferred B=8",
                                   "baichuan-13b i8i8 int8-kv alibi"),
        "paged_prefill_attention": ("baichuan-13b int8-kv alibi start=0",
                                    "baichuan-13b i8i8 int8-kv alibi"),
        "i8i8_matmul": ("baichuan-13b gate|up T=8 ",
                        "baichuan-13b i8i8 int8-kv alibi"),
        "w4a8_matmul": ("gate|up T=8 ", "llama2-7b w4a8 int8-kv"),
        "page_read": ("microbench ", "microbench"),
    }
    meta = {
        "paged_decode_attention": (
            "ppl/llm/serving_tpu_torch/csrc/paged_attention.cu",
            "ppl/llm/serving_tpu/ops/pallas/paged_attention.py:522"),
        "paged_prefill_attention": (
            "ppl/llm/serving_tpu_torch/csrc/paged_attention.cu",
            "ppl/llm/serving_tpu/ops/pallas/paged_attention.py:632"),
        "i8i8_matmul": (
            "ppl/llm/serving_tpu_torch/csrc/quant_matmul.cu",
            "ppl/llm/serving_tpu/ops/pallas/quant_matmul.py:253"),
        "w4a8_matmul": (
            "ppl/llm/serving_tpu_torch/csrc/quant_matmul.cu",
            "ppl/llm/serving_tpu/ops/pallas/quant_matmul.py:172"),
        "page_read": (
            "ppl/llm/serving_tpu_torch/csrc/cache_read.cu",
            "ppl/llm/serving_tpu/tools/microbench_scatter_7b.py:133"),
    }
    # launch counts kept apart: K1's block-tail launches, K1's and K2's
    # ALiBi launches, K3's by tile
    apart = {"paged_decode_attention": ("paged_decode_attention_tail",
                                        "paged_decode_attention_alibi"),
             "paged_prefill_attention": ("paged_prefill_attention_alibi",),
             "i8i8_matmul": tuple(f"i8i8_matmul_{tile}"
                                  for tile in quant_matmul.TILES)}
    entries = []
    for name, cases in results.items():
        prefix, path = main_case[name]
        c = next(c for c in cases if c["case"].startswith(prefix))
        src, rep = meta[name]
        entries.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            launches=e2e[path]["launches"][name],
            launches_by_path={k: v["launches"][name] for k, v in e2e.items()},
            **{f"{counter}_by_path": {k: v["launches"][counter]
                                      for k, v in e2e.items()}
               for counter in apart.get(name, ())},
            max_abs_err=c["max_abs_err"], ms=c["ms"],
            plain_ms=c["plain_ms"], bound_ms=c["bound_ms"],
            bound_by=c["bound_by"], library_ms=c["library_ms"],
            case=c["case"], n_cases=len(cases),
            launch_floor_ms=floor["empty_launch_ms"],
            **({"splits": c["splits"]} if "splits" in c else {})))
    log(f"[done] all phases passed in {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": entries}), flush=True)
    device_line(torch)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--data-parallel"] and \
            sys.argv[3:4] == ["--tensor-parallel"]:
        sys.exit(main_dp_tp(int(sys.argv[2]), int(sys.argv[4])))
    if sys.argv[1:2] == ["--data-parallel"]:
        sys.exit(main_data_parallel(int(sys.argv[2])))
    if sys.argv[1:2] == ["--tensor-parallel"]:
        sys.exit(main_tensor_parallel(int(sys.argv[2]),
                                      "--one-card-share" in sys.argv[3:]))
    if sys.argv[1:2] == ["--tp-rank"]:
        sys.exit(tp_rank_main(*(int(a) for a in sys.argv[2:5])))
    sys.exit(main())
