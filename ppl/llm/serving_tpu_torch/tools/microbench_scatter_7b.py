#!/usr/bin/env python3
"""KV-write microbench at LLaMA-2-7B geometry (MHA: 32 kv heads), the
port's counterpart of the JAX package's tool of the same name.

A decode step writes every layer's new K/V rows into the paged cache,
``[KVH, L*S, R]`` int8 packed k|v rows (4.3 GB at 16k tokens). This
times that write in the forms the JAX tool asked about, on the port's
own write, so the served form is chosen from data:

  a) ``kv_cache.append_kv_rows_block`` as served: one ``index_copy_`` of
     kvh-major row ids into the flat ``[KVH*L*S, R]`` view
  b) ``index_put_`` with the same ids
  c) the ids sorted first (and the rows with them)
  d) the multi-axis ``cache[:, lslots] = ...``
  e) one contiguous slice copy per KV head (an upper bound: every
     update one run of rows; timed only)
  f) 16 chained writes of (a), one CUDA graph on the card (eager on
     the CPU, where every time is the host's)
  g) f with a page read (K5, ``ops.kernels.cache_read.page_read``)
     before each write
  h) f with the page read after each write

Every form writes the cache rows only (no int8 scale rows), as the JAX
tool does. b-d must leave the cache bytes (a) leaves, and f-h those of
16 writes of (a) in a row; the run says whether they do.

    python -m ppl.llm.serving_tpu_torch.tools.microbench_scatter_7b \\
        [--device cuda|cpu] [--iters 20]
"""

from __future__ import annotations

import argparse
import time
from typing import Callable, Dict

import numpy as np
import torch

from ppl.llm.serving_tpu_torch.engine import _Runner
from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.ops.kernels.cache_read import page_read

# LLaMA-2-7B with int8 KV: 32 layers, 32 kv heads, 256-lane packed rows
L, KVH, PS, R = 32, 32, 128, 256
NPAGES = 128                       # 16k tokens
T = 32                             # decode batch
STEPS = 16


def _ms(fn: Callable[[], object], dev: torch.device, iters: int) -> float:
    """Mean ms of one ``fn()`` over ``iters`` calls after one warm-up:
    CUDA events on the card, the host clock on the CPU."""
    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) / iters * 1e3
    torch.cuda.synchronize(dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / iters


def run(num_layers: int = L, num_kv_heads: int = KVH, page_size: int = PS,
        row_lanes: int = R, num_pages: int = NPAGES, tokens: int = T,
        steps: int = STEPS, device="cuda", iters: int = 20, seed: int = 0,
        log: Callable[[str], None] = print) -> Dict[str, Dict]:
    """Time formulations a-h at the given geometry on ``device`` and
    check their caches; returns ``{"ms": {form: ms per step}, "same":
    {form: bool}}``. Raises when ``device`` is cuda and there is none."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device 'cuda' asked for but torch.cuda."
                           "is_available() is false; pass device='cpu'")
    slots_n = (num_pages + 1) * page_size
    ls_rows = num_layers * slots_n
    spec = kv_ops.CacheSpec(num_layers=num_layers, num_pages=num_pages,
                            page_size=page_size, num_kv_heads=num_kv_heads,
                            head_dim=row_lanes // 2, dtype=torch.int8)
    rng = np.random.default_rng(seed)
    # unique slots, as the JAX tool draws them
    slots = torch.from_numpy(rng.choice(num_pages * page_size, tokens,
                                        replace=False).astype(np.int32)
                             ).to(dev)
    rows_l = torch.from_numpy(rng.integers(
        -127, 127, (num_layers, tokens, num_kv_heads, row_lanes),
        dtype=np.int8)).to(dev)
    vals = rows_l.permute(2, 0, 1, 3).reshape(-1, row_lanes)

    def lslots(sl):
        return (torch.arange(num_layers, dtype=torch.int64,
                             device=dev)[:, None] * slots_n
                + sl.long()[None, :]).reshape(-1)

    def row_ids(sl):
        return (torch.arange(num_kv_heads, dtype=torch.int64,
                             device=dev)[:, None] * ls_rows
                + lslots(sl)[None, :]).reshape(-1)

    def write_a(cache, sl=slots):
        kv_ops.append_kv_rows_block(cache, None, rows_l, None, sl, spec)

    def write_b(cache):
        cache.view(-1, row_lanes).index_put_((row_ids(slots),), vals)

    def write_c(cache):
        ids, order = torch.sort(row_ids(slots))
        cache.view(-1, row_lanes).index_copy_(0, ids, vals[order])

    def write_d(cache):
        cache[:, lslots(slots)] = rows_l.permute(2, 0, 1, 3).reshape(
            num_kv_heads, num_layers * tokens, row_lanes)

    base = page_size      # page 1 onwards: one run of L*T rows per head

    def write_e(cache):
        flat = cache.view(-1, row_lanes)
        for h in range(num_kv_heads):
            o = h * ls_rows + base
            flat[o:o + num_layers * tokens] = rows_l[:, :, h].reshape(
                -1, row_lanes)

    def chained(cache, read=None):
        outs = []
        for i in range(steps):
            if read == "before":
                outs.append(page_read(cache, page_size=page_size))
            write_a(cache, slots + i)
            if read == "after":
                outs.append(page_read(cache, page_size=page_size))
        return torch.stack(outs).sum() if outs else cache[0, 0, 0]

    gb = num_kv_heads * ls_rows * row_lanes / 1e9
    log(f"cache {gb:.2f} GB, {num_kv_heads * num_layers * tokens} rows per "
        f"step, {steps}-step chains, on {dev}")
    ref = torch.zeros((num_kv_heads, ls_rows, row_lanes), dtype=torch.int8,
                      device=dev)
    work = torch.zeros_like(ref)
    write_a(ref)
    ms, same = {}, {}
    names = {"a": "append_kv_rows_block (index_copy_)",
             "b": "index_put_", "c": "sorted ids + index_copy_",
             "d": "multi-axis cache[:, lslots] =",
             "e": "contiguous slice per head (bound)"}
    for key, fn in (("a", write_a), ("b", write_b), ("c", write_c),
                    ("d", write_d), ("e", write_e)):
        work.zero_()
        fn(work)
        if key != "e":
            same[key] = bool(torch.equal(work, ref))
        ms[key] = _ms(lambda: fn(work), dev, iters)
        note = "" if key == "e" else f"  same bytes as (a): {same[key]}"
        log(f"{key}) {names[key]:36s}: {ms[key]:8.4f} ms/step{note}")

    # 16 writes of (a) in a row, eagerly: what f-h must leave
    ref.zero_()
    chained(ref)
    names = {"f": f"{steps} chained writes (graph)",
             "g": "chained, page read before each",
             "h": "chained, page read after each"}
    for key, read in (("f", None), ("g", "before"), ("h", "after")):
        # first visit eager, second captured and replayed (on the card)
        runner = _Runner(lambda read=read: chained(work, read), dev)
        for _ in range(2):
            work.zero_()
            runner()
        same[key] = bool(torch.equal(work, ref))
        ms[key] = _ms(runner, dev, max(1, iters // 2)) / steps
        log(f"{key}) {names[key]:36s}: {ms[key]:8.4f} ms/step  same bytes "
            f"as {steps} writes of (a): {same[key]}")
    return {"ms": ms, "same": same}


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--iters", type=int, default=20)
    args = p.parse_args()
    out = run(device=args.device, iters=args.iters)
    if not all(out["same"].values()):
        raise SystemExit(f"caches differ from (a): {out['same']}")


if __name__ == "__main__":
    main()
