"""The port's bench_sweep and bench_cold_start on the CPU, and the kernel
build's ``PPL_COMPILE_CACHE``: a one-entry sweep appends one line to its
``--out`` and skips that key on a rerun, never touching the JAX
package's ``BENCH_SWEEP.jsonl``; bench_cold_start starts the port's CPU
server twice with the warm-up manifest and returns both phases' numbers
(the cold phase records the program keys, the warm phase warms them up
before it listens); ``library_path`` lands under
``$PPL_COMPILE_CACHE/kernels`` when that is set. Every subprocess has a
deadline."""

import hashlib
import json
import os
import subprocess
import sys

import pytest

from ppl.llm.serving_tpu_torch.ops.kernels import _build
from ppl.llm.serving_tpu_torch.tools import bench_cold_start, bench_sweep

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT_SWEEP = os.path.join(REPO, "BENCH_SWEEP.jsonl")


def digest(path):
    with open(path, "rb") as f:
        return hashlib.sha256(f.read()).hexdigest()


def sweep(*args):
    return subprocess.run(
        [sys.executable, "-m", "ppl.llm.serving_tpu_torch.tools.bench_sweep",
         *args], cwd=REPO, capture_output=True, text=True, timeout=300)


def test_one_entry_sweep_appends_once_and_skips_on_rerun(tmp_path):
    before = digest(ROOT_SWEEP)
    out = tmp_path / "sweep.jsonl"
    first = sweep("i8i8", "--device", "cpu", "--out", str(out))
    assert first.returncode == 0, first.stderr[-3000:]
    (rec,) = [json.loads(line) for line in out.read_text().splitlines()]
    assert rec["sweep_key"] == "i8i8" and rec["env"] == {
        "BENCH_CONFIG": "i8i8"}
    assert rec["value"] > 0 and rec["backend"] == "cpu" and "error" not in rec
    again = sweep("i8i8", "--device", "cpu", "--out", str(out))
    assert again.returncode == 0 and "already recorded" in again.stderr
    assert len(out.read_text().splitlines()) == 1
    assert digest(ROOT_SWEEP) == before


def test_plan_and_done_keys(tmp_path):
    keys = [k for k, _ in bench_sweep.PLAN]
    assert keys == ["i8i8", "bf16", "i8i8_7b", "w4", "w4_7b", "i8i8_ms32",
                    "i8i8_spec2"]
    assert not any("BENCH_SEQ_BLOCK" in env for _, env in bench_sweep.PLAN)
    assert bench_sweep.OUT == os.path.join(REPO, "chiprun_out",
                                           "bench_sweep_torch.jsonl")
    out = tmp_path / "s.jsonl"
    recs = [dict(sweep_key="a", value=10.0, backend="cuda"),
            dict(sweep_key="b", value=0, backend="cuda", error="x"),
            dict(sweep_key="c", value=5.0, backend="cuda", error="partial"),
            dict(sweep_key="d", value=7.0, backend="cpu")]
    out.write_text("\n".join(json.dumps(r) for r in recs) + "\nnot json\n")
    assert bench_sweep.done_keys(str(out), "cuda") == {"a"}
    assert bench_sweep.done_keys(str(out), "cpu") == {"d"}
    assert bench_sweep.done_keys(str(tmp_path / "none"), "cuda") == set()


def test_unknown_plan_key_is_refused(tmp_path):
    proc = sweep("i8i8_sb4", "--device", "cpu", "--out",
                 str(tmp_path / "s.jsonl"))
    assert proc.returncode != 0 and "unknown plan keys" in proc.stderr
    assert not (tmp_path / "s.jsonl").exists()


def test_cold_start_against_the_cpu_server(tmp_path, capsys):
    out = bench_cold_start.main([
        "--params", os.path.join(REPO, "tests", "data", "params_tiny.json"),
        "--device", "cpu", "--kv-cache-max-tokens", "4096",
        "--extra", "--dtype float32", "--timeout", "120",
        "--json-out", str(tmp_path / "cold.json")])
    for phase in ("cold", "warm"):
        p = out[phase]
        assert p["listen_s"] > 0 and p["first_token_s"] > 0
        assert p["total_s"] == pytest.approx(p["listen_s"]
                                             + p["first_token_s"], abs=0.02)
        assert p["nvcc_s"] == {}
        # the probe's dispatches: all eager on the CPU
        assert p["eager_visits"] > 0
        # every eager dispatch is of a key warmed up or met new here
        assert (p["eager_manifest_visits"] + p["eager_new_visits"]
                == p["eager_visits"])
    assert out["manifest_keys"] > 0
    assert out["cold"]["prewarmed"] == 0
    assert out["warm"]["prewarmed"] == out["manifest_keys"]
    # the cold probe's keys make the manifest; the warm probe, served
    # whole as the cold one was, meets no key that is not in it
    assert out["cold"]["new_keys"] == out["cold"]["manifest_keys"] == out[
        "manifest_keys"]
    assert out["warm"]["new_keys"] == 0
    assert out["warm"]["prewarm_before_listening"]
    assert json.loads(capsys.readouterr().out.splitlines()[-1]) == out
    assert json.loads((tmp_path / "cold.json").read_text()) == out


def test_cold_start_refuses_the_warmup_manifest(tmp_path):
    """The manifest the tool used to refuse: ``--manifest PATH`` names
    the file both phases use (kept after the run; an old one is removed
    first), and ``--warmup-manifest`` in ``--extra`` gives way to it.
    ``manifest_keys`` counts the program keys (the JAX tool's counts the
    file's one JSON key)."""
    manifest = tmp_path / "kept.json"
    manifest.write_text(json.dumps({"keys": [[1, False, 8, 1, 999, 9, True,
                                               False]]}))
    out = bench_cold_start.main([
        "--params", os.path.join(REPO, "tests", "data", "params_tiny.json"),
        "--device", "cpu", "--kv-cache-max-tokens", "4096",
        "--extra", f"--dtype float32 --warmup-manifest "
        f"{tmp_path / 'other.json'}", "--timeout", "120",
        "--manifest", str(manifest)])
    keys = json.loads(manifest.read_text())["keys"]
    assert [1, False, 8, 1, 999, 9, True, False] not in keys
    assert out["manifest_keys"] == len(keys) > 1
    assert out["warm"]["manifest"]["live"] == len(keys)
    assert out["warm"]["eager_manifest_visits"] == out["warm"][
        "eager_visits"]
    assert not (tmp_path / "other.json").exists()


def test_nvcc_seconds_are_read_from_the_server_log():
    log = ("x INFO nvcc built libpaged_attention_0123456789abcdef.so in "
           "71.3 s\nnvcc built libcache_read_fedcba9876543210.so in 2.5 s\n"
           "[INFO] listening on port 4242 (cuda)\n")
    assert bench_cold_start.nvcc_seconds(log) == {"paged_attention": 71.3,
                                                  "cache_read": 2.5}
    assert bench_cold_start.LISTENING.search(log).group(1) == "4242"


@pytest.mark.parametrize("value", ["cache", ""])
def test_library_path_honours_ppl_compile_cache(tmp_path, monkeypatch,
                                                value):
    root = tmp_path / value if value else ""
    monkeypatch.setenv("PPL_COMPILE_CACHE", str(root))
    path = _build.library_path("quant_matmul")
    want = tmp_path / "cache" / "kernels" if value else _build.BUILD_DIR
    assert path.parent == want == _build.build_dir()
    assert path.name.startswith("libquant_matmul_")
    monkeypatch.delenv("PPL_COMPILE_CACHE")
    assert _build.library_path("quant_matmul") == _build.BUILD_DIR / path.name
