#!/usr/bin/env python3
"""Microbench of the fused i8i8 (K3) and w4a8 (K4) matmuls at the model's
call shapes, the counterpart of the JAX package's tool of the same name
(same ``shapes_7b()`` / ``shapes_tiny()``: the fused wqkv, wo, gate|up,
down and lm_head calls of one decode step).

The port's kernels have no block sizes to sweep. At decode sizes (K3 on
its decode tile, ``qk.k3_tile``; K4 at T <= ``W4_DECODE_MAX_T``) the
decode tile cuts the contraction into split-K pieces, so each shape runs
at the planner's piece count (``plan_split_k`` / ``plan_split_k_w4``),
at 1 and at twice the planner's (fewer where a piece would be empty, and
K3's at most ``MAX_PIECES``); on a prefill tile each shape runs whole,
one row a shape. Each row gives the kernel's mean
device time over ``--iters`` back-to-back launches (CUDA events behind a
device spin that outlasts the host's enqueueing; bf16 out; a weight that
fits the 50 MB L2 stays there between launches, as in the JAX tool, and
can beat its floor), its floor (the weight bytes over the card's HBM
bandwidth, looked up by the card's name), the share of the floor it
reaches, and, for orientation only,
``torch._int_mm`` on the same int8 activations and the (unpacked) int8
weight. The last line is the JAX tool's ``[RESULT] sum-of-best ... vs
floor ...``: one layer's five calls, lm_head included.

    python -m ppl.llm.serving_tpu_torch.tools.microbench_quant_matmul \\
        [--config 7b|tiny] [--method i8i8|w4a8] [--t 32] [--iters 50]
        [--only wo,down] [--device cuda|cpu]

On the CPU (``--device cpu``) the wrappers run their plain versions and
the times are the host's; there is no card, so no floor.
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
from ppl.llm.serving_tpu_torch.ops.kernels import _build
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as qk
from ppl.llm.serving_tpu_torch.resources import require_device
from ppl.llm.serving_tpu_torch.tools.common import (card_name_and_limit,
                                                    hbm_bytes_per_s)


def shapes_7b():
    d, i = 4096, 11008
    # (name, d, c, n) of the fused production calls (models/llama.py)
    return [("wqkv", d, 1, 3 * d), ("wo", d, 1, d),
            ("gate_up", d, 2, i), ("down", i, 1, d),
            ("lm_head", d, 1, 32000)]


def shapes_tiny():
    d, i = 2048, 5632
    return [("wqkv", d, 1, 2048 + 2 * 256), ("wo", d, 1, d),
            ("gate_up", d, 2, i), ("down", i, 1, d),
            ("lm_head", d, 1, 32000)]


W4_GROUP = 128      # the JAX tool's: d // 128 groups


def weight_bytes(method: str, d: int, c: int, n: int) -> int:
    """The bytes a call streams for its weight (int8, or packed int4)."""
    return c * d * n // (1 if method == "i8i8" else 2)


def floor_us(wbytes: int, bytes_per_s: float) -> float:
    """The weight-stream floor: ``wbytes`` at ``bytes_per_s``, in us."""
    return wbytes / bytes_per_s * 1e6


def split_candidates(method: str, t: int, d: int, c: int, n: int,
                     num_sms: int) -> List[int]:
    """The piece counts a row runs at, as the planner would run them: the
    planner's choice, 1 and twice the planner's (decode tile); 1 (the
    prefill tile)."""
    if method == "i8i8":
        if qk.k3_tile(t, n) == "prefill":
            return [1]
        plan = lambda s=None: qk.plan_split_k(t, d, n, c, num_sms, s)[0]
    else:
        if t > qk.W4_DECODE_MAX_T:
            return [1]
        plan = lambda s=None: qk.plan_split_k_w4(t, d // 2, n, c, num_sms,
                                                 W4_GROUP, s)[0]
    best = plan()
    return list(dict.fromkeys([best, plan(1), plan(2 * best)]))


def operands(method: str, t: int, d: int, c: int, n: int, dev):
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(t, d).astype(np.float32)).to(
        torch.bfloat16).to(dev)
    if method == "i8i8":
        w = torch.from_numpy(rng.randint(-127, 127, (c, d, n), np.int8))
        s = torch.from_numpy(rng.rand(c, n).astype(np.float32))
    else:
        w = torch.from_numpy(rng.randint(-128, 127, (c, d // 2, n), np.int8))
        s = torch.from_numpy(rng.rand(c, d // W4_GROUP, n).astype(np.float32))
    return x, w.to(dev), s.to(dev)


SPIN_CYCLES_PER_S = 2.0e9   # at least the card's SM clock (H100: 1.98 GHz)


def time_us(fn: Callable[[], object], dev, iters: int) -> float:
    """Mean us of ``fn`` over ``iters`` back-to-back calls after a warm-up:
    on the card the device time between two CUDA events, on the CPU the
    host clock. On the card the device first spins for twice what the
    host took to enqueue ``iters`` calls in an untimed pass, so that the
    events bracket the kernels alone, not the wrappers' host work."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e6
    torch.cuda.synchronize(dev)
    t0 = time.perf_counter()
    for _ in range(iters):
        fn()
    enqueue_s = time.perf_counter() - t0
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(int(2 * enqueue_s * SPIN_CYCLES_PER_S))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters * 1e3


def int_mm_us(method: str, x: torch.Tensor, w: torch.Tensor, dev,
              iters: int) -> Optional[float]:
    """torch._int_mm on the same int8 activations (padded to 32 rows, its
    least) and the weight as one int8 [D, C*N] matrix, column-major (the
    int4 weight unpacked): orientation only, None where it does not run."""
    c, dk, n = w.shape
    xq, _ = quant_ops.quantize_activation(x)
    rows = max(x.shape[0], 32)
    xq_lib = torch.zeros((rows, x.shape[1]), dtype=torch.int8, device=dev)
    xq_lib[:x.shape[0]] = xq
    w2 = w.permute(1, 0, 2).reshape(dk, c * n)
    if method == "w4a8":
        w2 = quant_ops.unpack_int4(w2)
    w_cm = w2.t().contiguous().t()
    try:
        return time_us(lambda: torch._int_mm(xq_lib, w_cm), dev, iters)
    except RuntimeError:
        return None


def run(method: str = "i8i8", config: str = "7b", t: int = 32,
        iters: int = 50, only: Sequence[str] = (), device: str = "cuda",
        log: Callable[[str], None] = print) -> dict:
    """Every shape at every piece count; returns ``{"rows": [...],
    "sum_best_us": .., "sum_floor_us": ..}`` (floors None on the CPU)."""
    dev = require_device(device)
    cuda = dev.type == "cuda"
    bw = card = None
    num_sms = 132            # what the planners see on the CPU (an H100's)
    if cuda:
        card, limit = card_name_and_limit(dev.index or 0)
        bw = hbm_bytes_per_s(card)
        num_sms = _build.sm_count(dev)
        log(f"device={card} ({limit}), {bw / 1e12:g} TB/s, t={t} "
            f"method={method}")
    else:
        log(f"device=cpu (plain versions; host times, no floor) t={t} "
            f"method={method}")
    fn = qk.i8i8_matmul if method == "i8i8" else qk.w4a8_matmul
    shapes = shapes_7b() if config == "7b" else shapes_tiny()
    rows, total_best, total_floor = [], 0.0, 0.0
    for name, d, c, n in shapes:
        if only and name not in only:
            continue
        x, w, s = operands(method, t, d, c, n, dev)
        wbytes = weight_bytes(method, d, c, n)
        floor = floor_us(wbytes, bw) if cuda else None
        orient = int_mm_us(method, x, w, dev, iters) if cuda else None
        best = None
        for splits in split_candidates(method, t, d, c, n, num_sms):
            us = time_us(lambda: fn(x, w, s, out_dtype=torch.bfloat16,
                                    splits=splits), dev, iters)
            rows.append(dict(name=name, d=d, c=c, n=n, t=t, splits=splits,
                             us=us, floor_us=floor, int_mm_us=orient))
            mark = ""
            if best is None or us < best:
                best, mark = us, " *"
            share = "" if floor is None else \
                f" (floor {floor:7.1f}, {floor / us:5.1%})"
            lib = "" if orient is None else f", _int_mm {orient:7.1f} us"
            log(f"  {name:<8} S={splits:<3} {us:8.1f} us{share}{lib}{mark}")
        total_best += best
        total_floor += floor or 0.0
        log(f"  {name:<8} BEST {best:.1f} us")
    if cuda:
        log(f"[RESULT] sum-of-best {total_best:.1f} us vs floor "
            f"{total_floor:.1f} us ({total_floor / total_best:.1%}) on "
            f"{card}")
    else:
        log(f"[RESULT] sum-of-best {total_best:.1f} us (cpu; no floor)")
    return dict(rows=rows, sum_best_us=total_best,
                sum_floor_us=total_floor if cuda else None)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--config", default="7b", choices=["7b", "tiny"])
    p.add_argument("--method", default="i8i8", choices=["i8i8", "w4a8"])
    p.add_argument("--t", type=int, default=32)
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--only", default="",
                   help="comma-separated shape names (default: all)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    run(args.method, args.config, args.t, args.iters,
        [s for s in args.only.split(",") if s], args.device)


if __name__ == "__main__":
    main()
