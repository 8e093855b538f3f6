#!/usr/bin/env python3
"""Run the port's headline bench (``tools.bench``) over the JAX package's
measurement plan, one subprocess a run, appending one JSON line a run to
``--out`` so that partial progress survives a lost run: the counterpart
of the JAX package's ``tools/bench_sweep.py``.

The plan is the JAX tool's (the i8i8 re-baseline, bf16, the LLaMA-2-7B
north-star configuration, w4, w4 at 7B, then 32-step blocks and two
speculative blocks on i8i8) less ``i8i8_sb4`` and ``i8i8_sb16``: the
port's kernels have no attention seq-block knob (the bench refuses
``BENCH_SEQ_BLOCK``).

``--out`` defaults to ``chiprun_out/bench_sweep_torch.jsonl`` under the
checkout (git-ignored); the JAX package's ``BENCH_SWEEP.jsonl`` is never
written. A key already recorded there is skipped unless ``--force``: a
record counts only with ``value > 0``, no ``error``, and ``backend`` the
device swept (``cuda``, or ``cpu`` under ``--device cpu``).

    python -m ppl.llm.serving_tpu_torch.tools.bench_sweep [KEY ...]
        [--out PATH] [--force] [--device cuda|cpu] [--timeout 3600]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Optional, Sequence, Set

REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))
OUT = os.path.join(REPO, "chiprun_out", "bench_sweep_torch.jsonl")
BENCH = "ppl.llm.serving_tpu_torch.tools.bench"

# (key, env) in execution order: re-baseline first, then the north-star
# 7B configuration, then knob sweeps on i8i8
PLAN = [
    ("i8i8", {"BENCH_CONFIG": "i8i8"}),
    ("bf16", {"BENCH_CONFIG": "bf16"}),
    ("i8i8_7b", {"BENCH_CONFIG": "i8i8_7b"}),
    ("w4", {"BENCH_CONFIG": "w4"}),
    ("w4_7b", {"BENCH_CONFIG": "w4_7b"}),
    ("i8i8_ms32", {"BENCH_CONFIG": "i8i8", "BENCH_MULTI_STEP": "32"}),
    ("i8i8_spec2", {"BENCH_CONFIG": "i8i8", "BENCH_SPEC_BLOCKS": "2"}),
]


def done_keys(out: str, backend: str) -> Set[str]:
    """The plan keys ``out`` already holds a good record of."""
    keys = set()
    if os.path.exists(out):
        with open(out) as f:
            for line in f:
                try:
                    rec = json.loads(line)
                except ValueError:
                    continue
                if (rec.get("value", 0) > 0 and "error" not in rec
                        and rec.get("backend") == backend):
                    keys.add(rec.get("sweep_key"))
    return keys


def run_one(key: str, extra: dict, device: str, timeout: float) -> dict:
    """One bench run in a subprocess; its JSON line with the sweep's keys
    (an ``error`` record when it printed none)."""
    env = dict(os.environ, **extra)
    t0 = time.time()
    rec = {"sweep_key": key, "env": extra}
    try:
        proc = subprocess.run([sys.executable, "-m", BENCH, "--device",
                               device], env=env, capture_output=True,
                              text=True, timeout=timeout, cwd=REPO)
        stdout, stderr = proc.stdout, proc.stderr
    except subprocess.TimeoutExpired as e:
        stdout, stderr = e.stdout or "", f"timed out after {timeout:.0f}s"
        stdout = stdout if isinstance(stdout, str) else stdout.decode()
    rec["wall_s"] = round(time.time() - t0, 1)
    for line in stdout.splitlines():
        try:
            rec.update(json.loads(line))
            break
        except ValueError:
            continue
    if "value" not in rec:
        rec["value"] = 0
        rec["error"] = ((stderr or "").strip().splitlines()
                        or ["no output"])[-1][:300]
    return rec


def main(argv: Optional[Sequence[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("keys", nargs="*", help="plan keys (default: all)")
    p.add_argument("--out", default=OUT)
    p.add_argument("--force", action="store_true")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=3600)
    args = p.parse_args(argv)
    unknown = set(args.keys) - {k for k, _ in PLAN}
    if unknown:
        p.error(f"unknown plan keys {sorted(unknown)}")
    plan = [(k, e) for k, e in PLAN if not args.keys or k in args.keys]
    skip = set() if args.force else done_keys(args.out, args.device)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    failed = 0
    for key, extra in plan:
        if key in skip:
            print(f"[sweep] {key}: already recorded, skipping",
                  file=sys.stderr)
            continue
        print(f"[sweep] {key}: starting", file=sys.stderr, flush=True)
        rec = run_one(key, extra, args.device, args.timeout)
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        failed += "error" in rec
        print(f"[sweep] {key}: {rec.get('value')} tokens/s "
              f"({rec['wall_s']}s)", file=sys.stderr, flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
