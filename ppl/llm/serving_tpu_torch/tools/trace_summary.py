#!/usr/bin/env python3
"""Summarize a torch.profiler trace of the port: device time by kernel,
by the port's kernel groups, and the device's busy and idle time with
what the host did in the largest gaps. The counterpart of the JAX
package's tool of the same name, over the chrome trace ``trace.json``
that ``LLMEngine.stop_trace`` writes (the generator's trace window:
``--trace-dir``, or the bench's ``BENCH_TRACE_DIR``).

Default view: the device's kernels (``"cat": "kernel"``, with memcpy and
memset) by name, demangled, top-N by time with ms, share and count.

``--group`` folds them into the port's kernels and the rest: K1
``paged_decode(_tc)_kernel``, K2 ``paged_prefill(_tc)_kernel``, K3
``i8i8_{decode,prefill}_kernel`` with ``quantize_rows_kernel`` (the
per-token quantize pass, which K4 launches too), K4 ``w4a8_*``, K5
``page_read_kernel``, cuBLAS/cutlass gemm, memcpy/memset,
elementwise/reduce, sort/topk, other.

``--timeline``: the span from the first device event to the last, the
device's busy time (the union of its events) and share, the idle time,
the 10 largest gaps, and for each gap the host event (a CPU op or a CUDA
runtime call such as ``cudaGraphLaunch``) that overlaps it most, or none
where the host ran untraced Python.

A trace with no device kernel (a CPU-only run) is said so, exit 1.

    python -m ppl.llm.serving_tpu_torch.tools.trace_summary TRACE \\
        [--group] [--timeline] [--top 40] [--filter REGEX] [--wide]

TRACE is a ``trace.json`` or the directory that holds it.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import re
import sys
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

GROUPS = [
    ("K1 paged_decode_attention", r"paged_decode(_tc)?_kernel"),
    ("K2 paged_prefill_attention", r"paged_prefill(_tc)?_kernel"),
    ("K3 i8i8_matmul (+ quantize_rows)",
     r"i8i8_(decode|prefill)_kernel|quantize_rows_kernel"),
    ("K4 w4a8_matmul", r"w4a8_"),
    ("K5 page_read", r"page_read_kernel"),
    ("cuBLAS/cutlass gemm", r"gemm|cublas|cutlass|xmma|_mma_"),
    ("sort/topk", r"[Ss]ort|[Tt]op[Kk]|radix|bitonic"),
    ("elementwise/reduce",
     r"at::native::|elementwise|[Rr]educe|CatArray|[Ii]ndex|[Ss]catter"
     r"|[Gg]ather|softmax"),
]


def demangle(name: str) -> str:
    """A kernel's name with its template arguments: of an Itanium-mangled
    ``_Z...`` name the first ``*kernel`` component and its mangled
    template arguments (``paged_decode_tc_kernelIaLi128``), of a
    demangled ``void f<...>(args)`` the name without its return type and
    parameter list."""
    if name.startswith("_Z"):
        pos = 3 if name.startswith("_ZN") else 2     # nested name or not
        while True:
            m = re.match(r"\d+", name[pos:])
            if m is None:
                return name
            pos += m.end()
            part = name[pos:pos + int(m.group())]
            pos += len(part)
            if part.endswith("kernel"):
                return part + name[pos:].split("EEv")[0]
    if name.startswith("void "):
        name = name[5:]
    name = name.replace("(anonymous namespace)", "{anonymous}")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0:
            return name[:i]
    return name


def group_name(name: str, cat: str = "kernel") -> str:
    if cat != "kernel":
        return "memcpy/memset"
    for group, pat in GROUPS:
        if re.search(pat, name):
            return group
    return "other"


def load_trace(path: str) -> List[dict]:
    if os.path.isdir(path):
        path = os.path.join(path, "trace.json")
    with open(path) as f:
        doc = json.load(f)
    return doc["traceEvents"] if isinstance(doc, dict) else doc


def _complete(events: List[dict], cats: Sequence[str]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats
            and "dur" in e]


def device_events(events: List[dict]) -> List[dict]:
    """The device's kernels, memcpys and memsets, with demangled names
    (memcpy and memset named by their category when unnamed)."""
    out = []
    for e in _complete(events, DEVICE_CATS):
        name = e.get("name") or f"[{e['cat'][4:]}]"
        out.append(dict(e, name=demangle(name) if e["cat"] == "kernel"
                        else name))
    return out


def by_name(devs: List[dict], group: bool, pattern: str = ""
            ) -> Dict[str, List[float]]:
    """``{name or group: [us, count]}``."""
    total: Dict[str, List[float]] = collections.defaultdict(lambda: [0.0, 0])
    pat = re.compile(pattern) if pattern else None
    for e in devs:
        if pat and not pat.search(e["name"]):
            continue
        key = group_name(e["name"], e["cat"]) if group else e["name"]
        total[key][0] += e["dur"]
        total[key][1] += 1
    return total


def print_table(total: Dict[str, List[float]], top: int, width: int,
                out=None) -> None:
    out = out or sys.stdout
    all_us = sum(us for us, _ in total.values())
    print(f"{'kernel':<{width}} {'ms':>10} {'%':>6} {'count':>8}", file=out)
    for name, (us, n) in sorted(total.items(),
                                key=lambda kv: -kv[1][0])[:top]:
        pct = 100 * us / all_us if all_us else 0.0
        print(f"{name[:width]:<{width}} {us / 1e3:>10.3f} {pct:>6.1f} "
              f"{n:>8}", file=out)
    print(f"{'TOTAL(shown scope)':<{width}} {all_us / 1e3:>10.3f}", file=out)


def busy_intervals(devs: List[dict]) -> List[Tuple[float, float]]:
    """The union of the device events as sorted, disjoint [start, end)
    intervals (us)."""
    merged: List[List[float]] = []
    for s, e in sorted((d["ts"], d["ts"] + d["dur"]) for d in devs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def host_in(gap: Tuple[float, float], hosts: List[dict]) -> Optional[dict]:
    """The host event overlapping ``gap`` most (the shorter one on a
    tie: the innermost), or None."""
    g0, g1 = gap
    best, best_key = None, None
    for h in hosts:
        ov = min(g1, h["ts"] + h["dur"]) - max(g0, h["ts"])
        if ov <= 0:
            continue
        key = (ov, -h["dur"])
        if best_key is None or key > best_key:
            best, best_key = dict(h, overlap=ov), key
    return best


def timeline(events: List[dict], devs: List[dict], n_gaps: int = 10
             ) -> dict:
    """Span, busy and idle time (ms), the busy share and the largest gaps
    with the host event in each."""
    busy = busy_intervals(devs)
    span = busy[-1][1] - busy[0][0]
    busy_us = sum(e - s for s, e in busy)
    gaps = sorted(((busy[i + 1][0] - busy[i][1], busy[i][1], busy[i + 1][0])
                   for i in range(len(busy) - 1)), reverse=True)[:n_gaps]
    hosts = _complete(events, HOST_CATS)
    return dict(span_ms=span / 1e3, busy_ms=busy_us / 1e3,
                busy_share=busy_us / span if span else 0.0,
                idle_ms=(span - busy_us) / 1e3,
                gaps=[dict(ms=g / 1e3, start_ms=(s - busy[0][0]) / 1e3,
                           host=host_in((s, e), hosts))
                      for g, s, e in gaps])


def print_timeline(tl: dict, out=None) -> None:
    out = out or sys.stdout
    print(f"span {tl['span_ms']:.3f} ms, device busy {tl['busy_ms']:.3f} ms "
          f"({100 * tl['busy_share']:.1f}%), idle {tl['idle_ms']:.3f} ms",
          file=out)
    print(f"largest gaps ({len(tl['gaps'])}):", file=out)
    for g in tl["gaps"]:
        h = g["host"]
        what = "none traced (host Python)" if h is None else \
            f"{h['cat']} {h['name'][:70]} ({h['overlap'] / 1e3:.3f} ms of it)"
        print(f"  {g['ms']:9.3f} ms at +{g['start_ms']:.3f} ms: host {what}",
              file=out)


def main(argv: Optional[Sequence[str]] = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawTextHelpFormatter)
    ap.add_argument("trace", help="trace.json, or the directory holding it")
    ap.add_argument("--top", type=int, default=40)
    ap.add_argument("--group", action="store_true",
                    help="fold kernels into K1-K5 and the library groups")
    ap.add_argument("--filter", default="",
                    help="only kernels whose name matches this regex")
    ap.add_argument("--wide", action="store_true",
                    help="show 140-char kernel names")
    ap.add_argument("--timeline", action="store_true",
                    help="busy/idle time and the largest gaps with what "
                         "the host did in them")
    args = ap.parse_args(argv)
    events = load_trace(args.trace)
    devs = device_events(events)
    if not any(e["cat"] == "kernel" for e in devs):
        print(f"no device kernel events in {args.trace}: a CPU-only trace "
              "(the profiler traced no CUDA activity)", file=sys.stderr)
        return 1
    print_table(by_name(devs, args.group, args.filter), args.top,
                140 if args.wide else 64)
    if args.timeline:
        print_timeline(timeline(events, devs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
