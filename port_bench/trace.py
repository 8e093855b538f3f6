"""Reading a ``torch.profiler`` chrome trace of the card: a frozen copy of
the port's ``tools/trace_summary.py`` (its ``GROUPS``, ``demangle``,
``group_name``, ``device_events``, ``busy_intervals`` and ``host_in``),
so that later changes to the program cannot move this yardstick.

:func:`summarize` turns one trace into what the per-layer metrics read:
device seconds by kernel group and by kernel, the device's busy seconds
(the union of its kernels, memcpys and memsets) and its largest idle
gaps with the host event in each.
"""

from __future__ import annotations

import collections
import json
import re
from typing import Dict, List, Optional, Sequence, Tuple

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")

K1 = "K1 paged_decode_attention"
K2 = "K2 paged_prefill_attention"
K3 = "K3 i8i8_matmul (+ quantize_rows)"

GROUPS = [
    (K1, r"paged_decode(_tc)?_kernel"),
    (K2, r"paged_prefill(_tc)?_kernel"),
    (K3, r"i8i8_(decode|prefill)_kernel|quantize_rows_kernel"),
    ("K4 w4a8_matmul", r"w4a8_"),
    ("K5 page_read", r"page_read_kernel"),
    ("cuBLAS/cutlass gemm", r"gemm|cublas|cutlass|xmma|_mma_"),
    ("sort/topk", r"[Ss]ort|[Tt]op[Kk]|radix|bitonic"),
    ("NCCL collectives", r"nccl"),
    ("elementwise/reduce",
     r"at::native::|elementwise|[Rr]educe|CatArray|[Ii]ndex|[Ss]catter"
     r"|[Gg]ather|softmax"),
]


def demangle(name: str) -> str:
    if name.startswith("_Z"):
        pos = 3 if name.startswith("_ZN") else 2
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


def _complete(events: List[dict], cats: Sequence[str]) -> List[dict]:
    return [e for e in events if e.get("ph") == "X" and e.get("cat") in cats
            and "dur" in e]


def device_events(events: List[dict]) -> List[dict]:
    out = []
    for e in _complete(events, DEVICE_CATS):
        name = e.get("name") or f"[{e['cat'][4:]}]"
        out.append(dict(e, name=demangle(name) if e["cat"] == "kernel"
                        else name))
    return out


def busy_intervals(devs: List[dict]) -> List[Tuple[float, float]]:
    merged: List[List[float]] = []
    for s, e in sorted((d["ts"], d["ts"] + d["dur"]) for d in devs):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def host_in(gap: Tuple[float, float], hosts: List[dict]) -> Optional[dict]:
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


def summarize(path: str, n_top: int = 10) -> Dict:
    """Over the traced window (the span of the trace's events, runtime
    calls and device: from the profiler's start to its stop): its
    seconds, device seconds by group and by kernel, busy seconds, the
    largest idle gaps (seconds, and the host event most inside each);
    raises when the trace holds no device kernel."""
    with open(path) as f:
        doc = json.load(f)
    events = doc["traceEvents"] if isinstance(doc, dict) else doc
    spanned = _complete(events, DEVICE_CATS + HOST_CATS)
    devs = device_events(events)
    if not any(e["cat"] == "kernel" for e in devs):
        raise RuntimeError(f"no device kernel in the trace {path}: the "
                           "profiler traced no CUDA activity")
    lo = min(e["ts"] for e in spanned)
    hi = max(e["ts"] + e["dur"] for e in spanned)
    groups: Dict[str, float] = collections.defaultdict(float)
    names: Dict[str, float] = collections.defaultdict(float)
    for e in devs:
        groups[group_name(e["name"], e["cat"])] += e["dur"] / 1e6
        names[e["name"]] += e["dur"] / 1e6
    busy = busy_intervals(devs)
    # the window's edges count as idle where the card was
    edges = [(busy[0][0] - lo, lo, busy[0][0]), (hi - busy[-1][1],
                                                 busy[-1][1], hi)]
    gaps = sorted(edges + [(busy[i + 1][0] - busy[i][1], busy[i][1],
                            busy[i + 1][0]) for i in range(len(busy) - 1)],
                  reverse=True)[:n_top]
    hosts = _complete(events, HOST_CATS)
    idle = []
    for g, s, e in (x for x in gaps if x[0] > 0):
        h = host_in((s, e), hosts)
        idle.append([("host: none traced" if h is None else
                      f"host: {h['cat']} {h['name'][:80]}"), g / 1e6])
    top = sorted(names.items(), key=lambda kv: -kv[1])[:n_top]
    return dict(groups=dict(groups), window_s=(hi - lo) / 1e6,
                busy_s=sum(e - s for s, e in busy) / 1e6,
                device_ops=[[n, s] for n, s in top], idle_gaps=idle,
                kernels=sum(e["cat"] == "kernel" for e in devs))
