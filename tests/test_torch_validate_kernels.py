"""The port's validate_kernels on the CPU: ``--device cpu`` runs every
case through the plain versions and exits 0; its case names are the JAX
tool's (read from that file's ``check("...`` calls, their tags
expanded) plus ``page_read``; a kernel whose output is corrupted on
purpose makes its case print FAIL and the tool exit 1."""

import os
import re
import subprocess
import sys

import pytest
import torch

from ppl.llm.serving_tpu_torch.ops.kernels import cache_read
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as pk
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as qk
from ppl.llm.serving_tpu_torch.tools import validate_kernels as vk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_TOOL = os.path.join(REPO, "ppl", "llm", "serving_tpu", "tools",
                        "validate_kernels.py")
CARD_ONLY = {"i8i8/7b-downproj-tile", "w4a8/7b-downproj-tile"}


def jax_case_names():
    """The JAX tool's case names: each ``check(f"...`` string with its
    ``{tag}`` (bf16, int8) and ``{sname}`` (hit, fullhit) expanded."""
    with open(JAX_TOOL) as f:
        src = f.read()
    names = set()
    for raw in re.findall(r'check\(\s*f?"([^"]+)"', src):
        for tag in ("bf16", "int8"):
            for sname in ("hit", "fullhit"):
                names.add(raw.format(tag=tag, sname=sname))
    return names


def port_case_names(card_only):
    """Every case the port's tool would run, recorded without running."""
    v = vk.Validator(torch.device("cpu"), lambda s: None)
    names = []
    v.check = lambda name, fn: names.append(name)
    for quant in (False, True):
        v.attention_cases(quant)
    v.matmul_cases(card_only=card_only)
    v.page_read_case()
    return names


def test_case_names_are_the_jax_tools_plus_page_read():
    jax_names = jax_case_names()
    assert len(jax_names) == 21 and CARD_ONLY <= jax_names
    card = port_case_names(card_only=True)
    assert len(card) == len(set(card))
    assert set(card) == jax_names | {"page_read"}
    assert set(port_case_names(card_only=False)) == \
        (jax_names - CARD_ONLY) | {"page_read"}


def test_cpu_run_passes_every_case():
    proc = subprocess.run(
        [sys.executable, "-m", "ppl.llm.serving_tpu_torch.tools."
         "validate_kernels", "--device", "cpu"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    lines = proc.stdout.splitlines()
    assert lines[-1] == "ALL OK"
    ok = [m.group(1) for m in
          (re.match(r"  ok   (\S+)  \(", line) for line in lines) if m]
    assert set(ok) == (jax_case_names() - CARD_ONLY) | {"page_read"}
    assert "FAIL" not in proc.stdout


def test_a_corrupted_kernel_fails_the_run(monkeypatch, capsys):
    """K3's wrapper off by one in its output: its cases print FAIL, the
    others stay ok, and the tool says FAILURES PRESENT and exits 1."""
    real = qk.i8i8_matmul
    monkeypatch.setattr(qk, "i8i8_matmul",
                        lambda *a, **k: real(*a, **k) + 1)
    with pytest.raises(SystemExit) as exc:
        vk.main(["--device", "cpu"])
    assert exc.value.code == 1
    out = capsys.readouterr().out
    failed = set(re.findall(r"  FAIL (\S+):", out))
    assert failed == {"i8i8/2d", "i8i8/fused-c-leading", "i8i8/prefill-tile"}
    assert "  ok   w4a8/2d" in out
    assert out.splitlines()[-1] == "FAILURES PRESENT"


def _corrupt(fn, eps):
    def wrapped(*a, **k):
        out = fn(*a, **k)
        return out + eps * torch.ones_like(out)
    return wrapped


# (module, wrapper, a small move, the cases it must fail); the moves sit
# just past each case's tolerance (bf16 attention 3e-2, f32 2e-5)
CORRUPTIONS = [
    (pk, "paged_decode_attention", 0.05,
     {"decode/bf16", "decode/bf16/deferred", "decode/int8",
      "decode/int8/deferred"}),
    (pk, "paged_prefill_attention", 0.05,
     {"prefill/bf16", "prefill/bf16/deferred/hit",
      "prefill/bf16/deferred/fullhit", "prefill/int8",
      "prefill/int8/deferred/hit", "prefill/int8/deferred/fullhit"}),
    (qk, "w4a8_matmul", 1.0,
     {"w4a8/2d", "w4a8/fused-c-leading", "w4a8/prefill-tile",
      "w4a8/down-proj-g44"}),
    (cache_read, "page_read", 1.0, {"page_read"}),
]


@pytest.mark.parametrize("module,name,eps,cases", CORRUPTIONS,
                         ids=[c[1] for c in CORRUPTIONS])
def test_each_kernel_case_catches_a_wrong_output(monkeypatch, module, name,
                                                 eps, cases):
    monkeypatch.setattr(module, name, _corrupt(getattr(module, name), eps))
    v = vk.Validator(torch.device("cpu"), lambda s: None)
    for quant in (False, True):
        v.attention_cases(quant)
    v.page_read_case()
    if module is qk:
        v.matmul_cases(card_only=False)
    failed = {k for k, ok in v.results.items() if not ok}
    assert failed == cases


def test_append_block_case_catches_a_wrong_write(monkeypatch):
    """The KV write is held byte for byte to a row-by-row write."""
    from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
    real = kv_ops.append_kv_rows_block

    def off_by_one(cache, scale, rows, srows, slots, spec):
        return real(cache, scale, rows, srows, slots + 1, spec)

    monkeypatch.setattr(kv_ops, "append_kv_rows_block", off_by_one)
    v = vk.Validator(torch.device("cpu"), lambda s: None)
    for quant in (False, True):
        v.attention_cases(quant)
    assert {k for k, ok in v.results.items() if not ok} == \
        {"append_block/bf16", "append_block/int8"}


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        vk.run("cuda", log=lambda s: None)
