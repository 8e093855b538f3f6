"""The port's warm-up manifest against the JAX package's, on the CPU.

The file the port writes is the JAX engine's byte for byte for the same
keys, merges included (the JAX ``LLMEngine.save_compile_manifest`` runs
on a stand-in that has ``compiled_keys``); ``prewarm_from_manifest``
keeps and drops the keys the JAX one does; ``llm_server --warmup-manifest``
records the keys a served request visited and a restart warms them up
before it listens, on one engine, on two tensor-parallel ranks (the same
keys in the same order on both) and on two data-parallel replicas, whose
writes lose no key; ``--aot-cache`` stays refused, naming what stands in
for it. Every server runs in a process of its own with deadlines, and is
killed on the way out."""

import json
import os
import signal
import subprocess
import sys
import time
import types

import pytest

from ppl.llm.serving_tpu.engine import LLMEngine as JEngine
from ppl.llm.serving_tpu_torch.config import (ConfigError, GeneratorConfig,
                                              ModelConfig, ResourceConfig)
from ppl.llm.serving_tpu_torch.engine import (LLMEngine, live_manifest_keys,
                                              load_manifest, save_manifest)
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2
from ppl.llm.serving_tpu_torch.tools import llm_server

from test_torch_tp_server import ARGV, START_S, ServerProcess, stream

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a server's stop may itself take 60 s to end its group
# (multihost.shutdown) and 60 s a worker rank (stop_ranks) before it
# gives up, so the test waits past those
STOP_S = 180
REPORT = "[INFO] program keys while serving: "

# program keys (n_steps, feed, bd, bp, qp, kvp, greedy, cont)
KEYS_A = [(8, True, 8, 0, 256, 512, True, True),
          (1, False, 8, 1, 256, 512, True, False),
          (8, False, 16, 0, 256, 512, False, False)]
KEYS_B = [(1, False, 8, 2, 1024, 512, False, False),
          (8, True, 8, 0, 256, 512, True, True),
          (1, False, 16, 1, 256, 256, True, False)]


def jax_save(path, keys):
    stand_in = types.SimpleNamespace(compiled_keys=lambda: sorted(keys))
    JEngine.save_compile_manifest(stand_in, str(path))


def port_save(path, keys):
    stand_in = types.SimpleNamespace(compiled_keys=lambda: sorted(keys))
    LLMEngine.save_compile_manifest(stand_in, str(path))


@pytest.mark.parametrize("before", [None, "garbage", "B", "A"])
def test_manifest_file_equals_the_jax_engines(tmp_path, before):
    """For the same keys, merged into the same file (none, not JSON, other
    keys, the same keys), both engines write the same bytes."""
    files = {}
    for name, save in (("jax", jax_save), ("port", port_save)):
        path = tmp_path / f"{name}.json"
        if before == "garbage":
            path.write_text("not a manifest")
        elif before is not None:
            save(path, KEYS_A if before == "A" else KEYS_B)
        save(path, KEYS_A)
        files[name] = path.read_bytes()
    assert files["port"] == files["jax"]
    got = {tuple(k) for k in json.loads(files["port"])["keys"]}
    assert got == set(KEYS_A) | (set(KEYS_B) if before == "B" else set())


def jax_prewarm_keys(path, max_kv_pages):
    """The keys the JAX engine's prewarm_from_manifest hands its prewarm."""
    got = []
    stand_in = types.SimpleNamespace(
        max_kv_pages=max_kv_pages,
        prewarm=lambda keys: got.extend(keys) or len(keys))
    stand_in._kvp_bucket = types.MethodType(JEngine._kvp_bucket, stand_in)
    JEngine.prewarm_from_manifest(stand_in, str(path))
    return got


def tiny_engine(**resource):
    engine, _, _ = create_engine(
        ModelConfig(hidden_dim=64, intermediate_dim=128, num_layers=2,
                    num_heads=4, num_kv_heads=2, vocab_size=256,
                    cache_mode=1, page_size=16, dtype="float32"),
        ResourceConfig(**dict(dict(model_format="random",
                                   kv_cache_max_tokens=2048,
                                   token_buckets=(32, 64),
                                   batch_buckets=(4, 8), device="cpu"),
                              **resource)),
        GeneratorConfig(max_running_batch=8, max_total_tokens_per_request=64))
    engine.set_max_kv_pages(4)
    return engine


def test_prewarm_from_manifest_keeps_and_drops_as_jax(tmp_path):
    """Keys of another page-table width go, every other entry stays, as in
    the JAX engine; the port then warms the keys on its grid, in the
    file's order, and counts and skips those off it (another batch
    bucket, token bucket or block size) and entries that are not program
    keys."""
    engine = tiny_engine()
    pinned = engine._kvp_bucket(engine.max_kv_pages)
    on = [[1, False, 4, 1, 32, pinned, True, False],
          [8, True, 8, 0, 32, pinned, False, True],
          [1, False, 8, 2, 64, pinned, False, False]]
    off = [[1, False, 16, 1, 32, pinned, True, False],
           [1, False, 4, 1, 128, pinned, True, False],
           [4, True, 4, 0, 32, pinned, True, False]]
    stale = [[1, False, 4, 1, 32, pinned * 2, True, False],
             [8, True, 8, 0, 32, 1, True, True]]
    not_keys = [[1, 2, 3], "x"]
    keys = sorted(on + off + stale, key=json.dumps) + not_keys
    path = tmp_path / "m.json"
    path.write_text(json.dumps({"keys": keys}))
    want = jax_prewarm_keys(path, engine.max_kv_pages)
    assert want == live_manifest_keys(keys, pinned)[0]
    assert len(want) == len(keys) - len(stale)
    warmed = []
    engine.prewarm = lambda ks: warmed.extend(ks) or len(ks)
    n = engine.prewarm_from_manifest(str(path))
    assert n == len(warmed) == len(on)
    assert warmed == [k for k in want if k in on]
    assert engine.manifest_stats["stale"] == len(stale)
    assert engine.manifest_stats["off_grid"] == len(off)
    assert engine.manifest_stats["not_keys"] == len(not_keys)
    assert engine.manifest_stats["live"] == len(want)


def test_a_missing_or_broken_manifest_warms_nothing(tmp_path):
    engine = tiny_engine()
    assert engine.prewarm_from_manifest(str(tmp_path / "none.json")) == 0
    (tmp_path / "bad.json").write_text("{")
    assert engine.prewarm_from_manifest(str(tmp_path / "bad.json")) == 0
    assert engine.manifest_stats["keys"] == 0
    assert load_manifest(str(tmp_path / "bad.json")) == []


WRITER = r"""
import sys
from ppl.llm.serving_tpu_torch.engine import save_manifest
path, base = sys.argv[1], int(sys.argv[2])
for i in range(40):
    save_manifest(path, [(1, False, base + i, 0, 32, 4, True, False)])
"""


def test_concurrent_writers_lose_no_key(tmp_path):
    """Four processes saving into one manifest at once, one key a save
    (as data-parallel replicas do): every key is in the file after."""
    path = str(tmp_path / "m.json")
    procs = [subprocess.Popen([sys.executable, "-c", WRITER, path,
                               str(1000 * w)], cwd=REPO)
             for w in range(4)]
    for p in procs:
        assert p.wait(timeout=120) == 0
    got = {tuple(k) for k in load_manifest(path)}
    assert got == {(1, False, 1000 * w + i, 0, 32, 4, True, False)
                   for w in range(4) for i in range(40)}


def stop(server):
    """SIGINT, then the server's exit code and its output."""
    server.proc.send_signal(signal.SIGINT)
    rc = server.proc.wait(timeout=STOP_S)
    time.sleep(0.2)   # the reader thread takes the last lines
    return rc, "".join(server.lines)


def report(log):
    lines = [ln for ln in log.splitlines() if ln.startswith(REPORT)]
    assert lines, log[-3000:]
    return json.loads(lines[-1][len(REPORT):])


def serve_once(argv):
    """Start a server, stream one request, stop it: (tokens, its log)."""
    server = ServerProcess(argv)
    try:
        assert server.listening.wait(START_S), server.log()
        tokens, statuses = stream(server.port)
        assert statuses[-1] == llm_pb2.FINISHED, server.log()
        rc, log = stop(server)
        assert rc == 0, log[-3000:]
        return tokens, log
    finally:
        server.kill()


def before_listening(log, marker):
    at = log.find(marker)
    return 0 <= at < log.find("listening on port")


def test_server_records_the_keys_and_a_restart_prewarms_them(tmp_path):
    """The first server records every key its request visited; the second,
    with the same flags, warms them all up before it listens, serves the
    same tokens and meets no key that is not in the manifest."""
    manifest = str(tmp_path / "manifest.json")
    argv = ARGV + ["--warmup-manifest", manifest]
    tokens, log = serve_once(argv)
    first = report(log)
    keys = {tuple(k) for k in load_manifest(manifest)}
    visited = {tuple(k[:8]) for k in first["eager_keys"]}
    assert visited and visited <= keys
    assert {tuple(k) for k in first["new_keys"]} == keys
    assert first["manifest_keys"] == len(keys)
    # the CPU has no graphs: every dispatch is eager
    assert first["eager_visits"] > 0 and first["eager_manifest_visits"] == 0
    again, log = serve_once(argv)
    assert again == tokens
    assert before_listening(log, f"[INFO] pre-warmed {len(keys)} step "
                            "programs in ")
    second = report(log)
    assert second["new_keys"] == [] and second["manifest_keys"] == len(keys)
    assert second["eager_manifest_visits"] == second["eager_visits"] > 0
    assert {tuple(k) for k in load_manifest(manifest)} == keys


def test_sigusr1_prints_the_report_while_serving(tmp_path):
    server = ServerProcess(ARGV + ["--warmup-manifest",
                                   str(tmp_path / "m.json")])
    try:
        assert server.listening.wait(START_S), server.log()
        stream(server.port)
        server.proc.send_signal(signal.SIGUSR1)
        deadline = time.monotonic() + STOP_S
        while (not any(REPORT in ln for ln in server.lines)
               and time.monotonic() < deadline):
            time.sleep(0.1)
        assert server.proc.poll() is None
        assert report("".join(server.lines))["eager_visits"] > 0
        rc, log = stop(server)
        assert rc == 0 and len(
            [ln for ln in log.splitlines() if REPORT in ln]) == 2
    finally:
        server.kill()


def rank_stats(log):
    """Each rank's logged warm-up: {rank: (manifest_stats, warmed keys)}."""
    out = {}
    for line in log.splitlines():
        if "warm-up manifest" in line and "(rank " in line:
            rank = int(line.split("(rank ")[1].split(")")[0])
            stats, warmed = line.split("): ", 1)[1].split("; warmed ")
            out[rank] = json.loads(stats), json.loads(warmed)
    return out


def test_tp2_ranks_prewarm_the_same_keys(tmp_path):
    """Under --tensor-parallel-size 2 rank 0 reads the manifest and both
    ranks warm up the same keys, in the same order, before listening."""
    manifest = str(tmp_path / "manifest.json")
    argv = ARGV + ["--tensor-parallel-size", "2", "--warmup-manifest",
                   manifest]
    tokens, log = serve_once(argv)
    n = len(load_manifest(manifest))
    assert n > 0 and report(log)["manifest_keys"] == n
    again, log = serve_once(argv)
    assert again == tokens
    stats = rank_stats(log)
    assert set(stats) == {0, 1}, log[-3000:]
    assert stats[0][0]["prewarmed"] == stats[1][0]["prewarmed"] == n
    assert stats[0][1] == stats[1][1] and len(stats[0][1]) == n
    assert before_listening(log, f"[INFO] pre-warmed {n} step programs")
    assert report(log)["new_keys"] == []


def test_dp2_replicas_record_and_prewarm(tmp_path):
    """Two data-parallel replicas save into one manifest and each warms
    up all of its keys at the restart."""
    manifest = str(tmp_path / "manifest.json")
    argv = ARGV + ["--data-parallel-size", "2", "--warmup-manifest",
                   manifest]
    tokens, _ = serve_once(argv)
    n = len(load_manifest(manifest))
    assert n > 0
    again, log = serve_once(argv)
    assert again == tokens
    for i in (0, 1):
        assert before_listening(
            log, f"[INFO] data-parallel replica {i}: pre-warmed {n} step "
            "programs"), log[-3000:]
    # the stop's report is replica 0's engine's, and says so
    assert "[INFO] data-parallel replica 0: " + REPORT[7:] in log
    assert REPORT not in log


def test_aot_cache_stays_refused():
    with pytest.raises(ConfigError, match="no counterpart") as e:
        llm_server.build_server(ARGV + ["--aot-cache", "store"])
    assert "PPL_COMPILE_CACHE" in str(e.value)
    assert "CUDA graphs" in str(e.value)
    assert "--warmup-manifest" in str(e.value)


def test_concurrent_saves_in_one_process(tmp_path):
    """Replicas of one process (threads) saving at once lose no key
    either: more threads than cores, switching often."""
    import threading
    path = str(tmp_path / "m.json")
    n_threads = (os.cpu_count() or 1) + 4

    def write(base):
        for i in range(20):
            save_manifest(path, [(1, False, base + i, 0, 32, 4, True,
                                  False)])

    threads = [threading.Thread(target=write, args=(100 * t,))
               for t in range(n_threads)]
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-5)
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
    finally:
        sys.setswitchinterval(interval)
    assert not any(t.is_alive() for t in threads)
    assert len(load_manifest(path)) == 20 * n_threads
