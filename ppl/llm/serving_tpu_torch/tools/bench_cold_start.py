#!/usr/bin/env python3
"""Cold-start benchmark of the port's server: launch -> listening -> the
first served token, on a first-ever start and on a restart. The
counterpart of the JAX package's tool of the same name.

The port compiles its CUDA kernels with nvcc (into
``$PPL_COMPILE_CACHE/kernels``) and, with the default validated bucket
grid, runs and captures the grid's programs as CUDA graphs before it
listens. Two phases launch ``tools.llm_server`` with the same flags
(random weights from ``--params``, ``--port 0`` read back from its
``listening on port N`` line):

  1. COLD: an empty ``PPL_COMPILE_CACHE``, so nvcc builds every ``.cu``
     before the grid is validated;
  2. WARM: the same directory, the kernels now built.

Per phase: ``listen_s`` (launch to listening), ``first_token_s`` (one
probe request's first token), ``total_s``, and ``nvcc_s``, the seconds of
each nvcc run the server logged (none on a warm start or on the CPU).
The JAX tool's warm-up manifest has no counterpart (CUDA graphs captured
at startup take its place) and stays refused. The server is killed by
its process group, never by a name pattern.

    python -m ppl.llm.serving_tpu_torch.tools.bench_cold_start \\
        --params params.json [--kv-cache-max-tokens N] [--device cpu] \\
        [--extra "--quant-method online_i8i8"] [--json-out PATH]
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shlex
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

from ppl.llm.serving_tpu_torch.config import not_ported

SERVER = "ppl.llm.serving_tpu_torch.tools.llm_server"
LISTENING = re.compile(r"listening on port (\d+)")
NVCC = re.compile(r"nvcc built lib(\w+)_[0-9a-f]{16}\.so in ([\d.]+) s")
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))


def wait_listening(proc, logf: str, timeout: float):
    """``(seconds to the listening line, port)``; raises if the server
    dies or the timeout passes first."""
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < timeout:
        with open(logf) as f:
            m = LISTENING.search(f.read())
        if m:
            return time.perf_counter() - t0, int(m.group(1))
        if proc.poll() is not None:
            with open(logf) as f:
                sys.stderr.write(f.read()[-2000:])
            raise RuntimeError(f"server died during startup (rc "
                               f"{proc.returncode})")
        time.sleep(0.2)
    raise RuntimeError(f"server not listening after {timeout}s")


def first_token_latency(target: str, timeout: float) -> float:
    """Seconds from sending one probe request to its first streamed
    token."""
    import grpc

    from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2
    from ppl.llm.serving_tpu_torch.tools.client_sample import make_stub
    req = llm_pb2.BatchedRequest(req=[llm_pb2.Request(
        id=1, prompt="cold start probe",
        stopping_parameters=llm_pb2.StoppingCriteriaParameters(
            max_new_tokens=8, ignore_eos_token=True))])
    with grpc.insecure_channel(target) as channel:
        t0 = time.perf_counter()
        for _ in make_stub(channel)(req, timeout=timeout):
            return time.perf_counter() - t0
    raise RuntimeError("stream closed without a token")


def nvcc_seconds(log: str) -> Dict[str, float]:
    """``{source: seconds}`` of the nvcc runs a server log records."""
    return {m.group(1): float(m.group(2)) for m in NVCC.finditer(log)}


def run_phase(name: str, cmd: List[str], logf: str, timeout: float,
              cache_dir: str) -> dict:
    print(f"[{name}] {' '.join(cmd)}", file=sys.stderr, flush=True)
    env = dict(os.environ, PPL_COMPILE_CACHE=cache_dir)
    with open(logf, "w") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env, cwd=REPO)
    try:
        t_listen, port = wait_listening(proc, logf, timeout)
        t_first = first_token_latency(f"127.0.0.1:{port}", timeout)
    finally:
        # the server's own process group, by its pid; never by pattern
        os.killpg(proc.pid, signal.SIGTERM)
        try:
            proc.wait(timeout=60)
        except subprocess.TimeoutExpired:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    with open(logf) as f:
        nvcc = nvcc_seconds(f.read())
    return {"listen_s": round(t_listen, 2), "first_token_s": round(t_first, 3),
            "total_s": round(t_listen + t_first, 2), "nvcc_s": nvcc}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--params", required=True,
                   help="params.json of the model (random weights)")
    p.add_argument("--kv-cache-max-tokens", type=int, default=131072)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--extra", default="",
                   help="more llm_server flags, one shell-quoted string")
    p.add_argument("--timeout", type=float, default=3600,
                   help="seconds each phase may take to listen, and its "
                        "probe to answer")
    p.add_argument("--json-out", default="")
    p.add_argument("--manifest", default="", help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    extra = shlex.split(args.extra)
    if args.manifest or "--warmup-manifest" in extra:
        raise not_ported("the warm-up manifest (CUDA graphs captured at "
                         "startup take its place)")
    base = [sys.executable, "-m", SERVER, "--device", args.device,
            "--model-format", "random",
            "--model-param-path", os.path.abspath(args.params),
            "--tokenizer-type", "dummy",
            "--kv-cache-max-tokens", str(args.kv_cache_max_tokens),
            "--host", "127.0.0.1", "--port", "0"] + extra
    # a first-ever start: phase 1 gets an EMPTY kernel cache; phase 2
    # finds what phase 1 built
    work = tempfile.mkdtemp(prefix="cold_start_")
    cache_dir = os.path.join(work, "cache")
    try:
        cold = run_phase("cold", base, os.path.join(work, "cold.log"),
                         args.timeout, cache_dir)
        warm = run_phase("warm", base, os.path.join(work, "warm.log"),
                         args.timeout, cache_dir)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"cold": cold, "warm": warm, "device": args.device}
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
