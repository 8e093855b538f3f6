"""Whole runs of tiny cells on the CPU: the harness's look for a card
skipped, the rest of a run driven (server, load generator, window,
drain, reference, metrics). Sound runs come out correct; the control
(the program's int4 path) and a token altered where it is produced come
out not correct."""

import json
import time

import numpy as np
import pytest

from port_bench import run
from port_bench.tests import tiny

SEED = 2**31 + 5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return tiny.make_root(str(tmp_path_factory.mktemp("bench")))


def cell(root, name, trace=False, **kw):
    with open("/dev/null", "w") as log:
        return run.run_cell(root, name, SEED, 2.0, trace, device="cpu",
                            t_start=time.monotonic(), log=log, **kw)


@pytest.mark.parametrize("name,trace", [
    ("tiny.chat", False), ("tiny.sessions", True), ("tiny.docs", True)])
def test_a_sound_run_is_correct(root, name, trace):
    out, lines = cell(root, name, trace)
    assert out["correct"] is True
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    gap = out["checks"]["max_logit_gap"]
    assert 0 <= gap["value"] <= gap["limit"] == tiny.TINY_LIMIT
    assert lines[0].startswith("check max_logit_gap")
    assert out["device"]["platform"] == "cpu"
    json.dumps(out)
    names = set(out["metrics"])
    if trace:
        # the per-layer metrics that a CPU run can read (no device trace)
        assert names <= {"prefix_hit", "kv_used"}
        if name == "tiny.docs":
            assert 0 < out["metrics"]["kv_used"]["value"] < 100
        else:
            assert out["metrics"]["prefix_hit"]["value"] > 0
    else:
        assert names == {"ttft_p50_ms", "ttft_p95_ms", "tpot_p95_ms",
                         "setup_s"}
        m = out["metrics"]
        assert 0 < m["ttft_p50_ms"]["value"] <= m["ttft_p95_ms"]["value"]


def test_the_control_is_not_correct(root):
    out, _ = cell(root, "tiny.chat", control=True)
    assert out["correct"] is False
    assert out["checks"]["max_logit_gap"]["value"] > tiny.TINY_LIMIT


def alter_tokens(server):
    """A token altered where it is produced: the first step of every
    fetched block reads its sampled tokens plus one."""
    engine = server.engine
    fetch = engine.fetch_plan_result

    def altered(handle, profiler=None):
        tokens, logprobs = fetch(handle, profiler)
        tokens = tokens.copy()
        tokens[0] = (tokens[0] + 1) % 256
        return tokens, logprobs
    engine.fetch_plan_result = altered


@pytest.mark.parametrize("name", ["tiny.chat", "tiny.sessions"])
def test_an_altered_token_is_not_correct(root, name):
    out, _ = cell(root, name, fault=alter_tokens)
    assert out["correct"] is False
    assert out["checks"]["max_logit_gap"]["value"] > tiny.TINY_LIMIT
    assert np.isfinite(out["checks"]["max_logit_gap"]["value"])
