"""The port's canonical qps benchmark (``tools/bench_canonical.py``) on the
CPU: the tiny branch end to end, as the root ``tools/bench_canonical.sh``
smokes its pipeline (one JSON line, 8 of 8 requests, exit 0); its branch
table and server flags against the script's, which may differ only by
the documented drops and additions; a warm pass with a failed request
ends with exit 1 and no JSON line; on cuda without a GPU it raises; its
server runs in the tool's process group, and chip_smoke kills a tool's
whole group past its deadline. And the script's server flags, less the
dropped ones, parse in the port's ``llm_server`` (``--disable-log-req``
included). Every subprocess has a deadline."""

import json
import os
import re
import shlex
import signal
import subprocess
import sys
import time

import pytest

from ppl.llm.serving_tpu.tools import common as jcommon
from ppl.llm.serving_tpu_torch.tools import bench_canonical, common, llm_server

import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(REPO, "tools", "bench_canonical.sh")
TOOL = "ppl.llm.serving_tpu_torch.tools.bench_canonical"
RUN_S = 300


def run_tool(*args):
    return subprocess.run([sys.executable, "-m", TOOL, *args], cwd=REPO,
                          capture_output=True, text=True, timeout=RUN_S,
                          env=dict(os.environ, OMP_NUM_THREADS="2"))


def script_branches():
    """The script's three branches: params.json (its heredoc),
    KV_TOKENS, EXTRA, BUCKETS and the request count."""
    text = open(SCRIPT).read()
    head, rest = text.split('if [ "$MODEL" = "tiny" ]', 1)
    tiny, rest = rest.split('elif [ "$MODEL" = "7b" ]', 1)
    b7, rest = rest.split("\nelse\n", 1)
    tinyllama = rest.split("\nfi\n", 1)[0]
    nreq = int(re.search(r"NREQ=\$\{NREQ:-(\d+)\}", head).group(1))
    out = {}
    for name, block in (("tiny", tiny), ("7b", b7),
                        ("tinyllama", tinyllama)):
        params = json.loads(block.split("<<EOF\n", 1)[1].split("\nEOF", 1)[0])
        kv = int(re.search(r"KV_TOKENS=\$\{KV_TOKENS:-(\d+)\}",
                           block).group(1))
        extra = re.search(r'EXTRA=(?:\$\{EXTRA:-)?"([^"]*)"', block).group(1)
        buckets = re.search(r'BUCKETS=(?:\$\{BUCKETS:-)?"([^"]*)"',
                            block).group(1)
        n = re.search(r"NREQ=\$\{NREQ_OVERRIDE:-(\d+)\}", block)
        out[name] = dict(params=params, kv_tokens=kv,
                         extra=shlex.split(extra),
                         buckets=shlex.split(buckets),
                         requests=int(n.group(1)) if n else nreq)
    return out


def script_server_argv(branch, params_path):
    """The script's llm_server flags for ``branch``, its variables
    expanded (``$PORT`` as 0), in its order."""
    text = open(SCRIPT).read()
    cmd = text.split("python tools/llm_server.py", 1)[1].split(
        '> "${SERVER_LOG}', 1)[0].replace("\\\n", " ")
    b = script_branches()[branch]
    values = {"$PARAMS": [params_path], "$KV_TOKENS": [str(b["kv_tokens"])],
              "$BUCKETS": b["buckets"], "$EXTRA": b["extra"],
              "$MANIFEST": ["manifest.json"],
              "${PROFILE_EVERY:-100}": ["100"], "$PORT": ["0"]}
    argv = []
    for word in shlex.split(cmd):
        argv += values.get(word, [word])
    return argv


def drop(argv, flags):
    """``argv`` without each of ``flags`` and its value."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
        elif a in flags:
            skip = True
        else:
            out.append(a)
    return out


def one_json_line(stdout):
    lines = stdout.splitlines()
    assert len(lines) == 1 and lines[0].startswith("{"), stdout[-2000:]
    return json.loads(lines[0])


def test_tiny_branch_end_to_end_on_cpu():
    """The script's CPU smoke: 8 requests, warm pass then measured pass,
    one JSON line with a throughput and no failure."""
    out = run_tool("--model", "tiny", "--device", "cpu")
    assert out.returncode == 0, out.stdout[-2000:] + out.stderr[-4000:]
    rec = one_json_line(out.stdout)
    assert rec["model"] == "tiny" and rec["requests"] == 8
    assert rec["finished"] == rec["warm_finished"] == 8
    assert rec["failed"] == rec["warm_failed"] == 0
    assert rec["tokens_out_per_s"] > 0
    assert rec["tokens_out_per_s_per_chip"] == rec["tokens_out_per_s"]
    assert rec["chips"] == 1 and rec["device"] == "cpu"
    assert rec["card"] == "cpu" and rec["power_limit_w"] is None
    assert rec["ttft_p50_ms"] > 0 and rec["tpot_p50_ms"] > 0
    assert rec["startup_s"] > 0 and rec["measured_s"] > 0
    assert rec["request_rate"] == "inf"
    # the CPU has no kernels to launch and no grid to validate
    assert rec["launches"] is not None and not any(rec["launches"].values())
    assert rec["grid_validated"] is False


@pytest.mark.parametrize("branch", ["tiny", "7b", "tinyllama"])
def test_branch_table_equals_the_script(branch, tmp_path):
    """params.json, KV_TOKENS, EXTRA, BUCKETS and the request count of
    each branch equal the script's; the server's flags equal the script's
    less its dropped flags and the port's additions."""
    want = script_branches()[branch]
    got = bench_canonical.BRANCHES[branch]
    for key in ("params", "kv_tokens", "extra", "buckets", "requests"):
        assert got[key] == want[key], key
    params = str(tmp_path / "params.json")
    port_argv = bench_canonical.server_argv(
        params, got["kv_tokens"], got["buckets"], got["extra"], "cuda")
    assert drop(port_argv, bench_canonical.ADDED) == drop(
        script_server_argv(branch, params), bench_canonical.DROPPED)
    assert port_argv[port_argv.index("--device") + 1] == "cuda"


@pytest.mark.parametrize("branch", ["tiny", "7b", "tinyllama"])
def test_script_server_flags_parse_in_the_port(branch, tmp_path):
    """The JAX script's llm_server flags, less the documented drops, parse
    in the port's server, --disable-log-req included; the dropped ones
    stay refused."""
    argv = drop(script_server_argv(branch, str(tmp_path / "p.json")),
                bench_canonical.DROPPED)
    args = llm_server.build_parser().parse_args(argv)
    assert args.disable_log_req and args.port == 0
    assert args.kv_cache_max_tokens == bench_canonical.BRANCHES[branch][
        "kv_tokens"] and args.multi_step == 16
    with pytest.raises(SystemExit):
        llm_server.build_parser().parse_args(
            argv + ["--attention-seq-block", "8"])


def test_disable_log_req_reaches_both_packages():
    import argparse

    def parse(mod):
        p = argparse.ArgumentParser()
        mod.add_model_args(p)
        mod.add_generator_args(p)
        return p.parse_args(["--disable-log-req"])

    assert parse(common).disable_log_req and parse(jcommon).disable_log_req


def test_failed_warm_pass_exits_1_without_a_number():
    """A sample longer than --max-input-tokens-per-request fails in the
    warm pass: exit 1, no JSON line, the server's last lines on stderr."""
    out = run_tool("--model", "tiny", "--device", "cpu", "--server-args",
                   "--dtype float32 --max-running-batch 16 "
                   "--max-prefill-batch 8 --max-input-tokens-per-request 16")
    assert out.returncode == 1, out.stdout[-2000:] + out.stderr[-4000:]
    assert not [ln for ln in out.stdout.splitlines() if ln.startswith("{")]
    assert "the warm pass finished" in out.stderr
    assert "the server's last lines" in out.stderr


def test_cuda_without_a_gpu_raises(monkeypatch):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        bench_canonical.main(["--model", "tiny"])


def test_server_runs_in_the_tools_process_group(tmp_path):
    """A kill of the tool's process group ends its server too."""
    server = bench_canonical.Server(["--version"], str(tmp_path / "log"))
    try:
        assert os.getpgid(server.proc.pid) == os.getpgrp()
    finally:
        server.kill()


def alive(pid):
    """Whether ``pid`` runs (a zombie does not)."""
    try:
        with open(f"/proc/{pid}/stat") as f:
            return f.read().rpartition(")")[2].split()[0] != "Z"
    except FileNotFoundError:
        return False


def test_chip_smoke_kills_a_tools_whole_group_past_its_deadline(tmp_path):
    """chip_smoke runs a tool in a process group of its own: past the
    deadline the tool and every process it started (a server) are
    killed."""
    pidfile = tmp_path / "grandchild"
    code = ("import subprocess, sys, time\n"
            "p = subprocess.Popen([sys.executable, '-c', "
            "'import time; time.sleep(600)'])\n"
            f"open({str(pidfile)!r}, 'w').write(str(p.pid))\n"
            "time.sleep(600)\n")
    with pytest.raises(subprocess.TimeoutExpired):
        chip_smoke.run_tree([sys.executable, "-c", code], timeout=8)
    pid = int(pidfile.read_text())
    try:
        deadline = time.monotonic() + 10
        while alive(pid) and time.monotonic() < deadline:
            time.sleep(0.1)
        assert not alive(pid), "the tool's child outlived its deadline"
    finally:
        if alive(pid):
            os.kill(pid, signal.SIGKILL)
