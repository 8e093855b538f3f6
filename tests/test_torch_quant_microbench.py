"""The port's K3/K4 microbench (``tools/microbench_quant_matmul.py``) on
the CPU: its shapes are the JAX tool's, its floors the weight bytes over
the given bandwidth, its split-K sweep the planner's choice, 1 and twice
the planner's; the wrappers' ``splits=`` override gives the plain
version's output bit for bit on the CPU and is checked; a CPU run prints
its rows and the ``[RESULT]`` line. The card's split-K agreement is in
``test_torch_kernels_gpu.py``."""

import re

import jax
import pytest
import torch

from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as qk
from ppl.llm.serving_tpu_torch.tools import microbench_quant_matmul as mb

H100_SXM = 3.35e12
SMS = 132


@pytest.fixture(scope="module")
def jax_tool():
    """The JAX tool, imported with the JAX compile-cache settings it
    changes at import put back afterwards."""
    saved = {k: getattr(jax.config, k) for k in (
        "jax_compilation_cache_dir",
        "jax_persistent_cache_min_compile_time_secs")}
    from ppl.llm.serving_tpu.tools import microbench_quant_matmul as jtool
    for k, v in saved.items():
        jax.config.update(k, v)
    return jtool


def test_shapes_are_the_jax_tools(jax_tool):
    assert mb.shapes_7b() == jax_tool.shapes_7b()
    assert mb.shapes_tiny() == jax_tool.shapes_tiny()


@pytest.mark.parametrize("method", ["i8i8", "w4a8"])
@pytest.mark.parametrize("bw", [H100_SXM, 2.0e12])
def test_floor_is_weight_bytes_over_the_bandwidth(method, bw):
    for name, d, c, n in mb.shapes_7b():
        wbytes = c * d * n // (1 if method == "i8i8" else 2)
        assert mb.weight_bytes(method, d, c, n) == wbytes
        assert mb.floor_us(wbytes, bw) == pytest.approx(wbytes / bw * 1e6,
                                                        rel=1e-15)
    # 7B wo: 16.8 MB int8 at 3.35 TB/s
    assert mb.floor_us(mb.weight_bytes("i8i8", 4096, 1, 4096), H100_SXM) == \
        pytest.approx(5.008124, abs=1e-6)


@pytest.mark.parametrize("method", ["i8i8", "w4a8"])
def test_split_candidates(method):
    for name, d, c, n in mb.shapes_7b():
        cands = mb.split_candidates(method, 8, d, c, n, SMS)
        if method == "i8i8":
            best = qk.plan_split_k(8, d, n, c, SMS)[0]
        else:
            best = qk.plan_split_k_w4(8, d // 2, n, c, SMS, mb.W4_GROUP)[0]
        assert cands[0] == best and 1 in cands and len(set(cands)) == \
            len(cands) and max(cands) <= 2 * best
        # above the decode tiles' tokens (K3's streaming tile takes 64,
        # K4's decode tile 16) the prefill tile runs whole
        big = qk.DECODE_MAX_T + 1 if method == "i8i8" else 32
        assert mb.split_candidates(method, big, d, c, n, SMS) == [1]
    if method == "i8i8":    # the streaming tile's pieces: one cluster
        for name, d, c, n in mb.shapes_7b():
            cands = mb.split_candidates(method, 32, d, c, n, SMS)
            assert cands[0] == qk.plan_split_k(32, d, n, c, SMS)[0]
            assert 1 in cands and max(cands) <= qk.MAX_PIECES


@pytest.mark.parametrize("splits", [1, 2, 3, 7, 10_000])
@pytest.mark.parametrize("d", [256, 4096, 11008])
def test_split_override_plans(splits, d):
    """An explicit piece count: whole stages a piece, none empty, the
    last ending at D (fewer pieces than asked where one would be
    empty)."""
    s, kchunk = qk.plan_split_k(8, d, 512, 1, SMS, splits)
    assert kchunk % qk.K_STAGE == 0 and (s - 1) * kchunk < d <= s * kchunk
    assert s <= splits
    s4, k4 = qk.plan_split_k_w4(8, d // 2, 512, 1, SMS, 64, splits)
    assert k4 % 64 == 0 and (s4 - 1) * k4 < d // 2 <= s4 * k4
    assert s4 <= splits
    # the planner's own choice is what no override gives
    assert qk.plan_split_k(8, d, 512, 1, SMS, None) == \
        qk.plan_split_k(8, d, 512, 1, SMS)


def test_split_override_refusals():
    with pytest.raises(ValueError, match="prefill tile"):
        qk.plan_split_k(qk.DECODE_MAX_T + 1, 4096, 512, 1, SMS, 2)
    assert qk.plan_split_k(qk.DECODE_MAX_T + 1, 4096, 512, 1, SMS, 1) == \
        qk.plan_split_k(qk.DECODE_MAX_T + 1, 4096, 512, 1, SMS)
    with pytest.raises(ValueError, match="prefill tile"):
        qk.plan_split_k_w4(17, 2048, 512, 1, SMS, 64, 2)
    x = torch.zeros((4, 64))
    with pytest.raises(ValueError, match="splits 0"):
        qk.i8i8_matmul(x, torch.zeros((64, 8), dtype=torch.int8),
                       torch.ones(8), splits=0)
    with pytest.raises(ValueError, match="splits 0"):
        qk.w4a8_matmul(x, torch.zeros((32, 8), dtype=torch.int8),
                       torch.ones((1, 8)), splits=0)


@pytest.mark.parametrize("splits", [None, 1, 2, 5])
@pytest.mark.parametrize("fused", [False, True])
def test_split_override_on_the_cpu_is_the_plain_version(splits, fused):
    g = torch.Generator().manual_seed(3)
    x = torch.randn((8, 256), generator=g)
    w = torch.randn(((256, 2, 96) if fused else (256, 96)), generator=g)
    wq, ws = quant_ops.quantize_weight(w)
    wp, wps = quant_ops.quantize_weight_int4(w, group=32)
    if fused:
        wq, ws = wq.permute(1, 0, 2).contiguous(), ws.contiguous()
        wp = wp.permute(1, 0, 2).contiguous()
        wps = wps.permute(1, 0, 2).contiguous()
    assert torch.equal(qk.i8i8_matmul(x, wq, ws, splits=splits),
                       quant_ops.i8i8_matmul(x, wq, ws))
    assert torch.equal(qk.w4a8_matmul(x, wp, wps, splits=splits),
                       quant_ops.w4a8_matmul(x, wp, wps))


@pytest.mark.parametrize("method", ["i8i8", "w4a8"])
def test_cpu_run(method, capsys):
    mb.main(["--device", "cpu", "--config", "tiny", "--method", method,
             "--only", "wo", "--t", "4", "--iters", "1"])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("device=cpu")
    rows = [line for line in out if re.match(r"  wo +S=\d+ ", line)]
    assert len(rows) == len(mb.split_candidates(method, 4, 2048, 1, 2048,
                                                SMS))
    assert re.fullmatch(r"\[RESULT\] sum-of-best [\d.]+ us \(cpu; no floor\)",
                        out[-1])


def test_cuda_without_a_gpu_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mb.run(device="cuda", log=lambda s: None)
