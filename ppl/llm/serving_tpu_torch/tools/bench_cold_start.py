#!/usr/bin/env python3
"""Cold-start benchmark of the port's server: launch -> listening -> the
first served token, on a first-ever start and on a restart, both with the
warm-up manifest. The counterpart of the JAX package's tool of the same
name.

The port compiles its CUDA kernels with nvcc (into
``$PPL_COMPILE_CACHE/kernels``) and, with the default validated bucket
grid, runs and captures the grid's programs as CUDA graphs before it
listens. Two phases launch ``tools.llm_server`` with the same flags
(random weights from ``--params``, ``--port 0`` read back from its
``listening on port N`` line) and ``--warmup-manifest``:

  1. COLD: an empty ``PPL_COMPILE_CACHE``, so nvcc builds every ``.cu``
     before the grid is validated, and no manifest: the server records
     every program key it holds or visits;
  2. WARM: the same directory, the kernels now built, and the manifest
     the cold phase wrote: its keys are warmed up (on cuda, captured)
     before the server listens.

Per phase: ``listen_s`` (launch to listening), ``first_token_s`` (one
probe request's first token), ``total_s``, ``nvcc_s``, the seconds of
each nvcc run the server logged (none on a warm start or on the CPU),
``prewarmed`` (the manifest's keys warmed up before listening),
``manifest`` (the server's ``manifest_stats``: keys, live, captured,
seconds, ...), ``prewarm_before_listening``, ``manifest_keys`` (the
file's program keys after the phase) and the probe's ``eager_visits``,
``eager_manifest_visits`` and ``eager_new_visits`` (its dispatches with
no graph to replay, those of keys the manifest warmed up, and those of
keys new in this phase) and ``new_keys`` (the keys the probe met that
the server did not hold before), which the server prints when it stops
(SIGINT; its process group is killed if it does not stop, never a name
pattern). The probe reads its stream to the end, so both phases serve
it whole and meet the same keys. ``manifest_keys``
at the top: the program keys of the manifest after both phases (the
JAX tool reports the length of the file's JSON object there, always
1).

    python -m ppl.llm.serving_tpu_torch.tools.bench_cold_start \\
        --params params.json [--kv-cache-max-tokens N] [--device cpu] \\
        [--extra "--quant-method online_i8i8"] [--manifest PATH] \\
        [--json-out PATH]
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

SERVER = "ppl.llm.serving_tpu_torch.tools.llm_server"
LISTENING = re.compile(r"listening on port (\d+)")
PREWARMED = re.compile(r"\[INFO\] (?:data-parallel replica 0: )?"
                     r"warm-up manifest: (\{.*\})")
PROGRAM_KEYS = re.compile(r"\[INFO\] (?:data-parallel replica 0: )?"
                          r"program keys while serving: (\{.*\})")
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
    token. The stream is read to its end: a probe cut after its first
    token would be cancelled at a point the host's timing picks, and the
    program keys it meets would vary from one phase to the next."""
    import grpc

    from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2
    from ppl.llm.serving_tpu_torch.tools.client_sample import make_stub
    req = llm_pb2.BatchedRequest(req=[llm_pb2.Request(
        id=1, prompt="cold start probe",
        stopping_parameters=llm_pb2.StoppingCriteriaParameters(
            max_new_tokens=8, ignore_eos_token=True))])
    first = None
    with grpc.insecure_channel(target) as channel:
        t0 = time.perf_counter()
        for _ in make_stub(channel)(req, timeout=timeout):
            if first is None:
                first = time.perf_counter() - t0
    if first is None:
        raise RuntimeError("stream closed without a token")
    return first


def nvcc_seconds(log: str) -> Dict[str, float]:
    """``{source: seconds}`` of the nvcc runs a server log records."""
    return {m.group(1): float(m.group(2)) for m in NVCC.finditer(log)}


def manifest_key_count(path: str) -> int:
    """The program keys of the manifest at ``path`` (0 when there is
    none)."""
    try:
        with open(path) as f:
            return len(json.load(f)["keys"])
    except (OSError, ValueError, KeyError, TypeError):
        return 0


def server_report(log: str) -> dict:
    """What a server log says of the manifest: the warm-up's stats (None
    without a warm-up), whether they came before the listening line, and
    the last program-key report (None if the server printed none)."""
    warm = PREWARMED.search(log)
    keys = list(PROGRAM_KEYS.finditer(log))
    listening = LISTENING.search(log)
    return {"manifest": json.loads(warm.group(1)) if warm else None,
            "prewarm_before_listening": bool(
                warm and listening and warm.start() < listening.start()),
            "program_keys": json.loads(keys[-1].group(1)) if keys else None}


def stop(proc, timeout: float = 60.0) -> None:
    """SIGINT (the server stops cleanly and prints its program-key
    report), then the server's own process group killed if it has not
    ended within ``timeout``; never by a name pattern."""
    if proc.poll() is None:
        proc.send_signal(signal.SIGINT)
    try:
        proc.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)
        proc.wait()


def run_phase(name: str, cmd: List[str], logf: str, timeout: float,
              cache_dir: str, manifest: str) -> dict:
    print(f"[{name}] {' '.join(cmd)}", file=sys.stderr, flush=True)
    env = dict(os.environ, PPL_COMPILE_CACHE=cache_dir)
    with open(logf, "w") as lf:
        proc = subprocess.Popen(cmd, stdout=lf, stderr=subprocess.STDOUT,
                                start_new_session=True, env=env, cwd=REPO)
    try:
        t_listen, port = wait_listening(proc, logf, timeout)
        t_first = first_token_latency(f"127.0.0.1:{port}", timeout)
    finally:
        stop(proc)
    with open(logf) as f:
        log = f.read()
    rep = server_report(log)
    keys = rep["program_keys"] or {}
    new = {tuple(k) for k in keys.get("new_keys", ())}
    return {"listen_s": round(t_listen, 2), "first_token_s": round(t_first, 3),
            "total_s": round(t_listen + t_first, 2),
            "nvcc_s": nvcc_seconds(log),
            "prewarmed": (rep["manifest"] or {}).get("prewarmed", 0),
            "manifest": rep["manifest"],
            "prewarm_before_listening": rep["prewarm_before_listening"],
            "manifest_keys": manifest_key_count(manifest),
            "eager_visits": keys.get("eager_visits"),
            "eager_manifest_visits": keys.get("eager_manifest_visits"),
            "eager_new_visits": sum(k[-1] for k in keys["eager_keys"]
                                    if tuple(k[:-1]) in new)
            if keys else None,
            "new_keys": len(new) if keys else None}


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
    p.add_argument("--manifest", default="",
                   help="the warm-up manifest both phases use (removed "
                        "first if it exists; default: one in the run's "
                        "temporary directory)")
    args = p.parse_args(argv)
    # a first-ever start: phase 1 gets an EMPTY kernel cache and no
    # manifest; phase 2 finds what phase 1 built and recorded
    work = tempfile.mkdtemp(prefix="cold_start_")
    cache_dir = os.path.join(work, "cache")
    manifest = os.path.abspath(args.manifest or os.path.join(
        work, "manifest.json"))
    if os.path.exists(manifest):
        os.unlink(manifest)
    base = [sys.executable, "-m", SERVER, "--device", args.device,
            "--model-format", "random",
            "--model-param-path", os.path.abspath(args.params),
            "--tokenizer-type", "dummy",
            "--kv-cache-max-tokens", str(args.kv_cache_max_tokens),
            "--host", "127.0.0.1", "--port", "0",
            *shlex.split(args.extra), "--warmup-manifest", manifest]
    try:
        cold = run_phase("cold", base, os.path.join(work, "cold.log"),
                         args.timeout, cache_dir, manifest)
        warm = run_phase("warm", base, os.path.join(work, "warm.log"),
                         args.timeout, cache_dir, manifest)
        n_keys = manifest_key_count(manifest)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    out = {"cold": cold, "warm": warm, "manifest_keys": n_keys,
           "device": args.device}
    print(json.dumps(out), flush=True)
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(out, f, indent=1)
    return out


if __name__ == "__main__":
    main()
