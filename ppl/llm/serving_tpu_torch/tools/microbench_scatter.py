#!/usr/bin/env python3
"""KV-append microbench at TinyLlama geometry (22 layers, 4 kv heads,
128-lane int8 rows, 1,024 pages of 128 tokens, a decode batch of 64):
the counterpart of the JAX package's tool of the same name, whose five
formulations it runs in PyTorch on the device:

  a) per-layer flat-view row write: one ``index_copy_`` a layer into the
     ``[KVH, L*S, R]`` cache
  b) (a) over unique, in-bounds row ids, told so
     (``_index_put_impl_(..., unsafe=True)``: no bounds or duplicate
     handling)
  c) one write across all layers (``kv_cache.append_kv_rows_block``, the
     served write)
  d) a token-major ``[L, S, KVH*R]`` cache: one ``index_copy_`` of
     ``KVH*R``-byte rows, 4x fewer and wider rows than (c)
  e) a slice copy per run of consecutive slots (runs end at a page's
     end), across all layers and heads at once

Each writes what (a) writes, byte for byte ((d) read back in (a)'s
layout), eagerly and replayed; the run says whether it does. Each prints
ms a step eagerly and replayed inside one CUDA graph (on the CPU both
are the host's eager time), and ms a 16-step block.

    python -m ppl.llm.serving_tpu_torch.tools.microbench_scatter \\
        [--device cuda|cpu] [--iters 30]
"""

from __future__ import annotations

import argparse
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ppl.llm.serving_tpu_torch.engine import _Runner
from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.resources import require_device
from ppl.llm.serving_tpu_torch.tools.microbench_scatter_7b import _ms

L, KVH, PS, R = 22, 4, 128, 128    # TinyLlama i8i8: 128-lane int8 rows
NPAGES = 1024
T = 64                             # decode batch
STEPS = 16                         # steps a block (for reporting)

NAMES = {"a": "per-layer index_copy_",
         "b": "per-layer, unique in-bounds",
         "c": "all layers, one index_copy_",
         "d": "token-major, one index_copy_",
         "e": "slice copy per page run"}


def page_runs(slots: np.ndarray, page_size: int
              ) -> List[Tuple[int, int, List[int]]]:
    """``(first slot, length, token indices)`` of each run of consecutive
    slots within one page, in slot order."""
    order = np.argsort(slots, kind="stable")
    runs: List[Tuple[int, int, List[int]]] = []
    for i in order:
        s = int(slots[i])
        if runs:
            s0, n, idx = runs[-1]
            if s == s0 + n and s // page_size == s0 // page_size:
                runs[-1] = (s0, n + 1, idx + [int(i)])
                continue
        runs.append((s, 1, [int(i)]))
    return runs


def run(num_layers: int = L, num_kv_heads: int = KVH, page_size: int = PS,
        row_lanes: int = R, num_pages: int = NPAGES, tokens: int = T,
        device: str = "cuda", iters: int = 30, seed: int = 0,
        log: Callable[[str], None] = print) -> Dict[str, Dict]:
    """Time (a)-(e) at the given geometry on ``device`` and hold their
    caches to (a)'s; returns ``{"ms": {form: ms a step eager},
    "graph_ms": {form: ms a step replayed}, "same": {form: bool}}``."""
    dev = require_device(device)
    slots_n = (num_pages + 1) * page_size
    ls_rows = num_layers * slots_n
    spec = kv_ops.CacheSpec(num_layers=num_layers, num_pages=num_pages,
                            page_size=page_size, num_kv_heads=num_kv_heads,
                            head_dim=row_lanes // 2, dtype=torch.int8)
    rng = np.random.RandomState(seed)
    slots_np = rng.choice(num_pages * page_size, tokens,
                          replace=False).astype(np.int32)
    slots = torch.from_numpy(slots_np).to(dev)
    rows_l = torch.from_numpy(rng.randint(
        -127, 127, (num_layers, tokens, num_kv_heads, row_lanes)).astype(
            np.int8)).to(dev)
    heads = torch.arange(num_kv_heads, dtype=torch.int64, device=dev)
    per_layer = [(l * slots_n + slots.long(), rows_l[l].permute(1, 0, 2))
                 for l in range(num_layers)]
    flat_ids = [(heads[:, None] * ls_rows + ids[None, :]).reshape(-1)
                for ids, _ in per_layer]
    flat_vals = [v.reshape(-1, row_lanes) for _, v in per_layer]
    lslots = (torch.arange(num_layers, dtype=torch.int64, device=dev)[:, None]
              * slots_n + slots.long()[None, :]).reshape(-1)
    tok_rows = rows_l.reshape(num_layers * tokens, num_kv_heads * row_lanes)
    runs = [(s0, n, torch.tensor(idx, device=dev))
            for s0, n, idx in page_runs(slots_np, page_size)]

    def write_a(cache):
        for ids, vals in per_layer:
            cache.index_copy_(1, ids, vals)

    def write_b(cache):
        flat = cache.view(-1, row_lanes)
        for ids, vals in zip(flat_ids, flat_vals):
            torch.ops.aten._index_put_impl_(flat, (ids,), vals, False, True)

    def write_c(cache):
        kv_ops.append_kv_rows_block(cache, None, rows_l, None, slots, spec)

    def write_d(cache_t):
        cache_t.view(ls_rows, -1).index_copy_(0, lslots, tok_rows)

    def write_e(cache):
        view = cache.view(num_kv_heads, num_layers, slots_n, row_lanes)
        for s0, n, idx in runs:
            view[:, :, s0:s0 + n] = rows_l[:, idx].permute(2, 0, 1, 3)

    def as_a(cache_t):
        """The token-major cache in (a)'s ``[KVH, L*S, R]`` layout."""
        return cache_t.view(ls_rows, num_kv_heads, row_lanes).permute(1, 0, 2)

    shape = (num_kv_heads, ls_rows, row_lanes)
    gb = num_kv_heads * ls_rows * row_lanes / 1e9
    log(f"cache {gb:.2f} GB, {num_layers * tokens * num_kv_heads} rows a "
        f"step in {len(runs)} page runs, on {dev}")
    ref = torch.zeros(shape, dtype=torch.int8, device=dev)
    write_a(ref)
    work = torch.zeros(shape, dtype=torch.int8, device=dev)
    work_t = torch.zeros((num_layers, slots_n, num_kv_heads * row_lanes),
                         dtype=torch.int8, device=dev)
    ms, graph_ms, same = {}, {}, {}
    for key, fn, buf, view in (("a", write_a, work, None),
                               ("b", write_b, work, None),
                               ("c", write_c, work, None),
                               ("d", write_d, work_t, as_a),
                               ("e", write_e, work, None)):
        buf.zero_()
        fn(buf)
        same[key] = bool(torch.equal(view(buf) if view else buf, ref))
        ms[key] = _ms(lambda: fn(buf), dev, iters)
        # first visit eager, second captured and replayed (on the card);
        # the replays must leave the same bytes too
        runner = _Runner(lambda: fn(buf), dev)
        runner()
        buf.zero_()
        graph_ms[key] = _ms(runner, dev, iters)
        same[key] &= bool(torch.equal(view(buf) if view else buf, ref))
        log(f"{key}) {NAMES[key]:28s}: {ms[key]:8.4f} ms/step eager "
            f"({ms[key] * STEPS:7.3f} ms/block), {graph_ms[key]:8.4f} "
            f"ms/step in a graph; same bytes as (a): {same[key]}")
    return {"ms": ms, "graph_ms": graph_ms, "same": same}


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--iters", type=int, default=30)
    args = p.parse_args(argv)
    out = run(device=args.device, iters=args.iters)
    if not all(out["same"].values()):
        raise SystemExit(f"caches differ from (a): {out['same']}")


if __name__ == "__main__":
    main()
