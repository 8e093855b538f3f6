"""The port's trace_summary over torch.profiler chrome traces: on a
synthetic trace (kernels named as the ``.cu`` files name them, a cuBLAS
gemm, a memcpy, PyTorch's own kernels, known gaps and host events)
``--group`` and ``--timeline`` print the exact ms, shares and gaps; a
real CPU run of the port's generator with ``trace_dir`` set writes the
``trace.json`` it reads, and it says that trace has no kernel events and
exits 1."""

import json

import pytest

from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)
from ppl.llm.serving_tpu_torch.connection import LocalConnection
from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.request import Request
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.tools import trace_summary as ts

from test_torch_generator import GEN, MODEL, RESOURCE, ByteTokenizer


def kernel(name, t, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7,
            "ts": t, "dur": dur, "args": {"device": 0, "stream": 7}}


def host(name, t, dur, cat="cpu_op"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1,
            "ts": t, "dur": dur}


# device busy [100, 260) [400, 630) [1000, 1300) [1310, 1405) [1500, 1600)
EVENTS = [
    {"ph": "M", "name": "process_name", "pid": 0, "args": {"name": "gpu"}},
    kernel("void paged_decode_tc_kernel<__nv_bfloat16, 64>(DecodeArgs)",
           100, 50),
    kernel("void i8i8_decode_kernel<__nv_bfloat16>(GemmArgs)", 150, 100),
    kernel("void quantize_rows_kernel<__nv_bfloat16>(__nv_bfloat16 const*, "
           "signed char*, float*, int, int)", 250, 10),
    host("cudaGraphLaunch", 270, 100, "cuda_runtime"),
    host("aten::copy_", 380, 40),
    kernel("sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_"
           "cublas", 400, 200),
    kernel("Memcpy DtoH (Device -> Pinned)", 600, 30, "gpu_memcpy"),
    kernel("void paged_prefill_tc_kernel<signed char, 64>(PrefillArgs)",
           1000, 300),
    kernel("void at::native::vectorized_elementwise_kernel<4, "
           "at::native::FillFunctor<float>, std::array<char*, 1ul> >(int, "
           "at::native::FillFunctor<float>, std::array<char*, 1ul>)",
           1000, 20),
    host("aten::index_select", 1290, 30),
    kernel("void w4a8_decode_kernel<64, float>(W4Args)", 1310, 90),
    kernel("_Z16page_read_kernelPKaPfxiii", 1400, 5),
    host("aten::topk", 1450, 150),
    kernel("void at_cuda_detail::cub::DeviceRadixSortOnesweepKernel<int>"
           "(int*)", 1500, 25),
    kernel("void my_custom_kernel(int)", 1525, 75),
]


@pytest.fixture
def trace(tmp_path):
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": EVENTS}))
    return tmp_path


def row(name, ms, pct, n):
    return f"{name:<64} {ms:>10.3f} {pct:>6.1f} {n:>8}"


def test_group_view_is_exact(trace, capsys):
    assert ts.main([str(trace), "--group"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out == [
        f"{'kernel':<64} {'ms':>10} {'%':>6} {'count':>8}",
        row("K2 paged_prefill_attention", 0.300, 33.1, 1),
        row("cuBLAS/cutlass gemm", 0.200, 22.1, 1),
        row("K3 i8i8_matmul (+ quantize_rows)", 0.110, 12.2, 2),
        row("K4 w4a8_matmul", 0.090, 9.9, 1),
        row("other", 0.075, 8.3, 1),
        row("K1 paged_decode_attention", 0.050, 5.5, 1),
        row("memcpy/memset", 0.030, 3.3, 1),
        row("sort/topk", 0.025, 2.8, 1),
        row("elementwise/reduce", 0.020, 2.2, 1),
        row("K5 page_read", 0.005, 0.6, 1),
        f"{'TOTAL(shown scope)':<64} {0.905:>10.3f}",
    ]


def test_timeline_is_exact(trace, capsys):
    assert ts.main([str(trace), "--group", "--timeline", "--top", "1"]) == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1] == row("K2 paged_prefill_attention", 0.300, 33.1, 1)
    assert out[3:] == [
        "span 1.500 ms, device busy 0.885 ms (59.0%), idle 0.615 ms",
        "largest gaps (4):",
        "      0.370 ms at +0.530 ms: host none traced (host Python)",
        "      0.140 ms at +0.160 ms: host cuda_runtime cudaGraphLaunch "
        "(0.100 ms of it)",
        "      0.095 ms at +1.305 ms: host cpu_op aten::topk (0.050 ms of it)",
        "      0.010 ms at +1.200 ms: host cpu_op aten::index_select "
        "(0.010 ms of it)",
    ]


def test_default_view_names_kernels_demangled(trace, capsys):
    assert ts.main([str(trace / "trace.json"), "--filter", "paged|page_"]) \
        == 0
    out = capsys.readouterr().out.splitlines()
    assert out[1:] == [
        row("paged_prefill_tc_kernel<signed char, 64>", 0.300, 84.5, 1),
        row("paged_decode_tc_kernel<__nv_bfloat16, 64>", 0.050, 14.1, 1),
        row("page_read_kernelPKaPfxiii", 0.005, 1.4, 1),
        f"{'TOTAL(shown scope)':<64} {0.355:>10.3f}",
    ]


@pytest.mark.parametrize("name,want", [
    ("_Z22paged_decode_tc_kernelIaLi128EEvPKT_",
     "paged_decode_tc_kernelIaLi128"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<float, "
     "unsigned int, 2, 64, 64>(float*, int)",
     "at::native::{anonymous}::CatArrayBatchedCopy<float, unsigned int, 2, "
     "64, 64>"),
    ("sm90_xmma_gemm_bf16bf16", "sm90_xmma_gemm_bf16bf16"),
])
def test_demangle(name, want):
    assert ts.demangle(name) == want


def test_a_cpu_run_of_the_generator_has_no_kernel_events(tmp_path, capsys):
    """The port's generator on the CPU with a trace window writes
    trace.json; the tool reads it and exits 1, saying why."""
    trace_dir = tmp_path / "trace"
    cfg = ModelConfig(**MODEL)
    gen_cfg = GeneratorConfig(**GEN, trace_dir=str(trace_dir),
                              trace_start_step=1, trace_num_steps=2)
    engine, kv_max, _ = create_engine(
        cfg, ResourceConfig(**dict(RESOURCE, device="cpu")), gen_cfg)
    conn = LocalConnection()
    gen = LLMGenerator(cfg, gen_cfg, engine, ByteTokenizer(), conn, kv_max)
    try:
        conn.set_wanted(2)
        for i in range(2):
            gen.process(Request(id=i, token_ids=[1, 5 + i, 9, 12],
                                generation_length=8, top_k=1,
                                early_stopping=False))
        assert conn.wait(timeout=120)
    finally:
        gen.shutdown()
    events = ts.load_trace(str(trace_dir))
    assert any(e.get("cat") == "cpu_op" for e in events)
    assert ts.main([str(trace_dir), "--group", "--timeline"]) == 1
    err = capsys.readouterr().err
    assert "no device kernel events" in err and "CPU-only" in err
