#!/usr/bin/env python3
"""The canonical throughput benchmark of the port: output tokens/s per
card and p50 TTFT at ``--request-rate inf`` on a ShareGPT-style workload
through the gRPC server. The counterpart of the root
``tools/bench_canonical.sh`` (the metric ``BASELINE.json`` defines), run
as a user runs it:

    python -m ppl.llm.serving_tpu_torch.tools.bench_canonical \\
        [--model tiny|tinyllama|7b] [--device cpu]

1. ``gen_samples`` writes the workload: ``--sharegpt-mix`` (prompt mean
   ~200 tokens, answer mean ~180, heavy tails, 1,500-token cap), or with
   the ``tiny`` branch or ``--workload light`` ``--prompt-mean 32
   --answer-mean 64``;
2. ``llm_server`` starts as its own process with the branch's
   params.json, KV pool, buckets and batch limits (:data:`BRANCHES`, the
   script's three branches), random weights, online i8i8 weights,
   ``--multi-step 16 --speculative-blocks 1 --max-tokens-per-step 8192``,
   profiling every 100 steps, ``--port 0`` read back from its ``listening
   on port N`` line;
3. a warm pass of ``client_qps_measure --token-in-out --request-rate
   inf`` with the full request count;
4. the measured pass at ``--request-rate``;
5. the server is stopped (SIGINT; it prints the kernel launches it made
   while serving) and ONE JSON line is printed: ``model``, ``requests``,
   ``finished``, ``failed`` (the measured pass; the warm pass's beside
   them), ``tokens_out_per_s`` and ``tokens_out_per_s_per_chip`` (over
   the server's dp x tp cards), ``ttft_p50_ms`` (p50 prefill latency),
   ``tpot_p50_ms`` (p50 decode latency a token), ``time_per_token_ms``,
   ``startup_s`` (launch to listening), ``warm_s``, ``measured_s``,
   ``device``, ``card``, ``power_limit_w`` (``nvidia-smi`` on cuda),
   ``launches`` and ``grid_validated`` (the server log's "bucket grid
   validated before serving" line).

What differs from the script:

- ``--warmup-manifest`` goes: the port refuses it; the grid is validated
  at startup instead (on cuda; the CPU has nothing to validate).
- ``--attention-seq-block`` goes: the port has no seq-block knob.
- The retry of a crashed TPU worker goes. A warm pass with any failed or
  missing request, a server that exits, a server that never listens or
  one that does not stop cleanly ends the tool with exit 1 and the
  server's last lines, never a JSON line with a number.
- ``--device`` reaches the server (cuda by default: the tool raises when
  no GPU is visible, it never carries on on the CPU), and ``--port 0``
  replaces ``$PORT``.

``--kv-tokens``, ``--buckets`` and ``--server-args`` override the
branch's ``KV_TOKENS``, ``BUCKETS`` and ``EXTRA``; through
``--server-args``, ``--tensor-parallel-size`` and
``--data-parallel-size`` reach the server. ``--work-dir`` keeps the
samples, params.json and the server's log (a temporary directory, removed
after, by default).
"""

from __future__ import annotations

import argparse
import asyncio
import contextlib
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
GEN_SAMPLES = "ppl.llm.serving_tpu_torch.tools.gen_samples"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))
LISTENING = re.compile(r"listening on port (\d+)")
LAUNCHES = re.compile(r"kernel launches while serving: (\{.*\})")
GRID_VALIDATED = "bucket grid validated before serving"
# seconds the server may take to listen (53-105 s at 7B on one H100), and
# each request stream's deadline (a 7B pass of 256 requests takes under
# a minute there)
STARTUP_TIMEOUT_S = 600.0
REQUEST_TIMEOUT_S = 600.0

_PARAMS = dict(cache_layout=0, cache_mode=1, dynamic_batching=True,
               auto_causal=True)
# the script's branches (bench_canonical.sh:29-74): params.json, KV pool
# tokens, EXTRA, BUCKETS, and the tiny branch's request count
BRANCHES: Dict[str, dict] = {
    # the CPU smoke of the whole pipeline
    "tiny": dict(
        params=dict(num_heads=4, num_kv_heads=2, num_layers=2, hidden_dim=64,
                    intermediate_dim=128, vocab_size=256, cache_quant_bit=0,
                    cache_quant_group=1, page_size=16, dtype="float32",
                    **_PARAMS),
        kv_tokens=8192,
        extra=["--dtype", "float32", "--max-running-batch", "16",
               "--max-prefill-batch", "8"],
        buckets=["--token-buckets", "256,1024", "--batch-buckets", "8,16"],
        requests=8),
    # LLaMA-2-7B with int8 group-8 KV and an int8 lm_head
    "7b": dict(
        params=dict(num_heads=32, num_kv_heads=32, num_layers=32,
                    hidden_dim=4096, intermediate_dim=11008, vocab_size=32000,
                    cache_quant_bit=8, cache_quant_group=8, page_size=128,
                    dtype="bfloat16", **_PARAMS),
        kv_tokens=16384,
        extra=["--quantize-lm-head", "--max-running-batch", "64",
               "--max-prefill-batch", "32"],
        buckets=["--token-buckets", "256,512,1024,2048,4096",
                 "--batch-buckets", "32,64"],
        requests=256),
    # TinyLlama-1.1B with int8 group-8 KV, the script's default
    "tinyllama": dict(
        params=dict(num_heads=32, num_kv_heads=4, num_layers=22,
                    hidden_dim=2048, intermediate_dim=5632, vocab_size=32000,
                    cache_quant_bit=8, cache_quant_group=8, page_size=128,
                    dtype="bfloat16", **_PARAMS),
        kv_tokens=98304,
        extra=["--max-running-batch", "128", "--max-prefill-batch", "64"],
        buckets=["--token-buckets", "256,512,1024,2048,4096",
                 "--batch-buckets", "64,128"],
        requests=256),
}
# the script's server flags the port drops (each with its value), and
# the ones it adds
DROPPED = ("--attention-seq-block", "--warmup-manifest")
ADDED = ("--device",)


def server_argv(params_path: str, kv_tokens: int, buckets: Sequence[str],
                extra: Sequence[str], device: str) -> List[str]:
    """The server's flags, in the script's order (its dropped flags
    left out, ``--device`` first, ``--port 0``)."""
    return ["--device", device, "--model-format", "random",
            "--model-param-path", params_path, "--tokenizer-type", "dummy",
            "--quant-method", "online_i8i8", "--kv-cache-max-tokens",
            str(kv_tokens), "--multi-step", "16", "--speculative-blocks", "1",
            "--max-tokens-per-step", "8192", *buckets, *extra,
            "--enable-profiling", "--profile-step-interval", "100",
            "--disable-log-req", "--port", "0"]


def gen_args(model: str, workload: str) -> List[str]:
    if model == "tiny" or workload == "light":
        return ["--prompt-mean", "32", "--answer-mean", "64"]
    return ["--sharegpt-mix"]


def log(msg: str) -> None:
    print(f"[bench_canonical] {msg}", file=sys.stderr, flush=True)


class Failed(RuntimeError):
    """The run cannot give a number (exit 1)."""


class Server:
    """``llm_server`` as a child in this tool's process group (a kill of
    the group ends it too; the ranks and replicas it starts end with it),
    its output in ``log_path``."""

    def __init__(self, argv: Sequence[str], log_path: str):
        self.log_path = log_path
        self._log = open(log_path, "w")
        self.t0 = time.perf_counter()
        self.proc = subprocess.Popen(
            [sys.executable, "-m", SERVER, *argv], stdout=self._log,
            stderr=subprocess.STDOUT, cwd=REPO,
            env=dict(os.environ, PYTHONPATH=os.pathsep.join(filter(None, (
                REPO, os.environ.get("PYTHONPATH"))))))

    def text(self) -> str:
        with open(self.log_path, errors="replace") as f:
            return f.read()

    def tail(self, n: int = 40) -> str:
        return "".join(self.text().splitlines(keepends=True)[-n:])

    def wait_listening(self, timeout_s: float) -> int:
        """The port, once the server says it listens; raises Failed if it
        exits or the time runs out first."""
        deadline = time.monotonic() + timeout_s
        while time.monotonic() < deadline:
            m = LISTENING.search(self.text())
            if m:
                return int(m.group(1))
            if self.proc.poll() is not None:
                raise Failed(f"the server exited with {self.proc.returncode} "
                             "before it listened")
            time.sleep(0.5)
        raise Failed(f"the server did not listen within {timeout_s:.0f} s")

    def check_alive(self, what: str) -> None:
        if self.proc.poll() is not None:
            raise Failed(f"the server exited with {self.proc.returncode} "
                         f"during {what}")

    def stop(self, timeout_s: float = 180.0) -> int:
        """SIGINT (a clean stop of every rank and replica), then its exit
        code (-1: still running after ``timeout_s``)."""
        if self.proc.poll() is None:
            self.proc.send_signal(signal.SIGINT)
        try:
            return self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            return -1

    def kill(self) -> None:
        """End the server (its ranks and replicas follow it) and wait for
        it."""
        if self.proc.poll() is None:
            self.proc.kill()
        self.proc.wait()
        self._log.close()


def run_pass(target: str, samples: str, n: int, rate: float,
             early_stopping: bool, timeout_s: float):
    """One client_qps_measure pass; returns (its summary, finished,
    failed, seconds)."""
    from ppl.llm.serving_tpu_torch.tools import client_qps_measure as qps
    with contextlib.redirect_stdout(sys.stderr):
        stats, elapsed, sent = asyncio.run(qps.measure(
            target, samples, n, rate, token_in_out=True,
            early_stopping=early_stopping, timeout=timeout_s))
        m = qps.report(stats, elapsed, sent)
    return m, len(m["done"]), stats.failed + (n - sent), elapsed


def p50(vals: Sequence[float]) -> Optional[float]:
    from ppl.llm.serving_tpu_torch.tools.client_qps_measure import pct
    return pct(sorted(vals), 50) if vals else None


def card_info(device: str):
    """(card, power limit in W) on cuda; ("cpu", None) on the CPU."""
    if device == "cpu":
        return "cpu", None
    from ppl.llm.serving_tpu_torch.tools.common import card_name_and_limit
    card, limit = card_name_and_limit(0)
    return card, float(limit.split()[0])


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description=__doc__, formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--model", default="tinyllama", choices=sorted(BRANCHES))
    p.add_argument("--num-requests", type=int, default=None,
                   help="requests a pass (the branch's: 8 tiny, 256 else)")
    p.add_argument("--request-rate", type=float, default=float("inf"),
                   help="the measured pass's Poisson arrivals a second "
                        "(inf: all at once)")
    p.add_argument("--early-stopping", action="store_true",
                   help="stop on EOS (the script's EARLY=1)")
    p.add_argument("--workload", default="sharegpt",
                   choices=["sharegpt", "light"])
    p.add_argument("--kv-tokens", type=int, default=None,
                   help="the KV pool (the branch's KV_TOKENS)")
    p.add_argument("--buckets", default=None,
                   help="bucket flags, one shell-quoted string (the "
                        "branch's BUCKETS)")
    p.add_argument("--server-args", default=None,
                   help="the other server flags, one shell-quoted string "
                        "(the branch's EXTRA)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--work-dir", default="",
                   help="keep the samples, params.json and the logs here")
    return p


def run(args) -> dict:
    """The pipeline; returns the JSON line's record. Raises Failed."""
    from ppl.llm.serving_tpu_torch.resources import require_device
    from ppl.llm.serving_tpu_torch.tools import llm_server
    require_device(args.device)
    branch = BRANCHES[args.model]
    n = args.num_requests or branch["requests"]
    kv_tokens = args.kv_tokens or branch["kv_tokens"]
    buckets = (shlex.split(args.buckets) if args.buckets is not None
               else branch["buckets"])
    extra = (shlex.split(args.server_args) if args.server_args is not None
             else branch["extra"])
    work = args.work_dir or tempfile.mkdtemp(prefix="bench_canonical_")
    os.makedirs(work, exist_ok=True)
    samples = os.path.join(work, "samples.json")
    params = os.path.join(work, f"params_{args.model}.json")
    with open(params, "w") as f:
        json.dump(branch["params"], f)
    argv = server_argv(params, kv_tokens, buckets, extra, args.device)
    parsed = llm_server.build_parser().parse_args(argv)
    chips = parsed.data_parallel_size * parsed.tensor_parallel_size
    card, limit_w = card_info(args.device)
    server = None
    try:
        subprocess.run([sys.executable, "-m", GEN_SAMPLES, "--output",
                        samples, "--count", str(n),
                        *gen_args(args.model, args.workload)],
                       check=True, cwd=REPO, timeout=600,
                       stdout=sys.stderr)
        server = Server(argv, os.path.join(work, "server.log"))
        try:
            port = server.wait_listening(STARTUP_TIMEOUT_S)
            startup_s = time.perf_counter() - server.t0
            log(f"server listening on {port} after {startup_s:.1f} s")
            target = f"127.0.0.1:{port}"
            _, warm_done, warm_failed, warm_s = run_pass(
                target, samples, n, float("inf"), args.early_stopping,
                REQUEST_TIMEOUT_S)
            server.check_alive("the warm pass")
            if warm_failed or warm_done != n:
                raise Failed(f"the warm pass finished {warm_done} of {n} "
                             f"requests, {warm_failed} failed")
            m, done, failed, measured_s = run_pass(
                target, samples, n, args.request_rate, args.early_stopping,
                REQUEST_TIMEOUT_S)
            server.check_alive("the measured pass")
            rc = server.stop()
        finally:
            server.kill()
        if rc != 0:
            raise Failed(f"the server did not stop cleanly (exit {rc})")
        server_log = server.text()
    except Failed as e:
        tail = server.tail() if server is not None else ""
        raise Failed(f"{e}\n--- the server's last lines ---\n{tail}") from e
    finally:
        if not args.work_dir:
            shutil.rmtree(work, ignore_errors=True)
    launches = LAUNCHES.search(server_log)
    ttft, tpot = p50(m["prefill_ms"]), p50(m["decode_ms"])
    return dict(
        model=args.model, requests=n, finished=done, failed=failed,
        warm_finished=warm_done, warm_failed=warm_failed,
        request_rate=(str(args.request_rate)
                      if args.request_rate == float("inf")
                      else args.request_rate),
        tokens_out_per_s=m["tokens_out_per_s"],
        tokens_out_per_s_per_chip=m["tokens_out_per_s"] / chips,
        ttft_p50_ms=ttft, tpot_p50_ms=tpot,
        time_per_token_ms=m["time_per_token_ms"],
        startup_s=startup_s, warm_s=warm_s, measured_s=measured_s,
        chips=chips, tensor_parallel_size=parsed.tensor_parallel_size,
        data_parallel_size=parsed.data_parallel_size,
        device=args.device, card=card, power_limit_w=limit_w,
        grid_validated=GRID_VALIDATED in server_log,
        launches=json.loads(launches.group(1)) if launches else None)


def main(argv: Optional[Sequence[str]] = None) -> int:
    args = build_parser().parse_args(argv)
    try:
        record = run(args)
    except Failed as e:
        log(f"FAILED: {e}")
        return 1
    print(json.dumps(record), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
