"""The trace reader: the traced window spans the trace's host and device
events, and its edges count as idle."""

import json

import pytest

from port_bench import trace


def write(tmp_path, events):
    p = tmp_path / "trace.json"
    p.write_text(json.dumps({"traceEvents": events}))
    return str(p)


def ev(cat, name, ts, dur):
    return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}


def test_summary_over_the_marked_window(tmp_path):
    path = write(tmp_path, [
        ev("cpu_op", "aten::empty", 0, 5),
        ev("kernel", "void i8i8_decode_kernel<64>(int)", 50, 100),
        ev("kernel", "void at::native::elementwise_kernel<1>(int)", 300,
           200),
        ev("kernel", "void paged_prefill_tc_kernel<1>(int)", 450, 100),
        ev("cuda_runtime", "cudaGraphLaunch", 600, 300),
        ev("gpu_memcpy", "Memcpy HtoD", 1050, 100),
        ev("cuda_runtime", "cudaDeviceSynchronize", 1100, 100)])
    s = trace.summarize(path)
    assert s["window_s"] == pytest.approx(1200e-6)
    assert s["groups"][trace.K3] == pytest.approx(100e-6)
    assert s["groups"][trace.K2] == pytest.approx(100e-6)
    assert trace.K1 not in s["groups"]
    # busy: [50,150) + [300,550) + [1050,1150)
    assert s["busy_s"] == pytest.approx(450e-6)
    assert s["idle_gaps"][0] == ["host: cuda_runtime cudaGraphLaunch",
                                 pytest.approx(500e-6)]
    assert sum(g for _, g in s["idle_gaps"]) == pytest.approx(750e-6)
    assert s["kernels"] == 3


def test_a_trace_without_kernels_is_refused(tmp_path):
    with pytest.raises(RuntimeError, match="no device kernel"):
        trace.summarize(write(tmp_path, [ev("cpu_op", "aten::mm", 1, 2)]))


def test_groups_follow_the_ports_kernel_names():
    assert trace.group_name("quantize_rows_kernel<bf16>") == trace.K3
    assert trace.group_name("paged_decode_tc_kernel<1>") == trace.K1
    assert trace.group_name("ncclKernel_AllReduce") == "NCCL collectives"
    assert trace.group_name("x", "gpu_memset") == "memcpy/memset"
    assert trace.demangle("void f<int, 2>(float*)") == "f<int, 2>"
