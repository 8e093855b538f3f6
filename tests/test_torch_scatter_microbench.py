"""The port's KV-append microbench (``tools/microbench_scatter.py``, the
JAX tool's formulations a-e in PyTorch) on the CPU at a tiny geometry:
(b)-(e) leave the cache bytes that (a) leaves, eagerly and replayed; a
form that writes other bytes is reported; the page runs of (e) cover
every slot once."""

import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.tools import microbench_scatter as mb

TINY = dict(num_layers=3, num_kv_heads=2, page_size=16, row_lanes=32,
            num_pages=6, device="cpu", iters=1)


@pytest.mark.parametrize("tokens,seed", [(5, 0), (12, 1), (40, 2)])
def test_every_form_leaves_the_bytes_of_a(tokens, seed):
    lines = []
    out = mb.run(tokens=tokens, seed=seed, log=lines.append, **TINY)
    assert out["same"] == {k: True for k in "abcde"}
    assert set(out["ms"]) == set(out["graph_ms"]) == set("abcde")
    assert all(v > 0 for v in out["ms"].values())
    assert len(lines) == 6 and lines[0].startswith("cache ")


def test_a_wrong_form_is_reported(monkeypatch):
    """(c) writing one slot off is seen: the check is not vacuous."""
    real = kv_ops.append_kv_rows_block

    def off_by_one(cache, scale, rows, srows, slots, spec):
        return real(cache, scale, rows, srows, slots + 1, spec)

    monkeypatch.setattr(kv_ops, "append_kv_rows_block", off_by_one)
    out = mb.run(tokens=6, log=lambda s: None, **TINY)
    assert out["same"] == dict(a=True, b=True, c=False, d=True, e=True)


def test_page_runs_cover_each_slot_once():
    slots = np.array([5, 3, 4, 17, 16, 15, 31, 32, 40])
    runs = mb.page_runs(slots, 16)
    assert runs == [(3, 3, [1, 2, 0]), (15, 1, [5]), (16, 2, [4, 3]),
                    (31, 1, [6]), (32, 1, [7]), (40, 1, [8])]
    covered = sorted(s0 + i for s0, n, _ in runs for i in range(n))
    assert covered == sorted(slots.tolist())


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mb.run(device="cuda")
