"""The harness finds a cell's pieces by name: a mix, a metric and a cell
dropped into a scratch copy are found without an edit."""

import json
import os

import pytest

from port_bench import run
from port_bench.registry import Bench
from port_bench.tests import tiny

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def test_every_named_piece_exists():
    bench = Bench(REPO)
    for w in bench.spec["workloads"]:
        assert os.path.exists(bench.config_path(w))
        assert bench.traffic(w)["loop"] in ("open", "closed")
        assert float(bench.cell(w)["max_logit_gap"]) > 0
        for kind in ("end_to_end", "per_layer"):
            for m in bench.metrics(kind, w):
                assert callable(bench.reader(m["name"]))
        names = {m["name"] for m in bench.metrics("end_to_end", w)}
        assert "setup_s" in names and len(names) >= 2
        assert bench.metrics("per_layer", w)


def test_a_new_mix_metric_and_cell_are_found_by_name(tmp_path):
    root = tiny.make_root(str(tmp_path))
    bench_dir = os.path.join(root, "port_bench")
    with open(os.path.join(bench_dir, "traffic", "burst.json"), "w") as f:
        json.dump(dict(tiny.TRAFFIC["tiny-chat"], rate_per_s=9.0), f)
    with open(os.path.join(bench_dir, "metrics", "queue_wait_ms.py"),
              "w") as f:
        f.write("NAMES = ('queue_wait_ms.tail',)\n\n"
                "def read(ctx, name):\n    return 42.0\n")
    with open(os.path.join(bench_dir, "cells", "tiny.burst.json"),
              "w") as f:
        json.dump({"max_logit_gap": 0.1}, f)
    spec = json.load(open(os.path.join(root, "BENCHMARK.json")))
    spec["workloads"].append({"name": "tiny.burst", "config": "tiny-alibi",
                              "traffic": "burst", "chips": 1, "why": "t"})
    spec["per_layer"].append({"name": "queue_wait_ms.tail", "unit": "ms",
                              "better": "lower", "source": "program_span",
                              "layer": "generator and prefix cache",
                              "moves": "ttft_p95_ms",
                              "workloads": ["tiny.burst"]})
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f)
    bench = Bench(root)
    w = bench.workload("tiny.burst")
    assert bench.traffic(w)["rate_per_s"] == 9.0
    assert bench.cell(w)["max_logit_gap"] == 0.1
    assert bench.reader("queue_wait_ms.tail")(None, "x") == 42.0
    assert [m["name"] for m in bench.metrics("per_layer", w)] == \
        ["queue_wait_ms.tail"]
    # a split metric finds its family's reader
    assert bench.reader("mfu.anything") is bench.reader("mfu.tail")
    with pytest.raises(KeyError):
        bench.workload("tiny.missing")


def test_the_run_refuses_without_a_card(monkeypatch, capsys):
    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(run, "set_cache_env", lambda: None)
    assert run.main(["--workload", "baichuan13b.chat", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 2
    out = capsys.readouterr()
    assert out.out == ""
    assert "CUDA" in out.err
