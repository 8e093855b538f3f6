"""The port's headline bench (``tools/bench.py``) on the CPU: one JSON
line with the JAX bench's keys, its decode roofline equal to the JAX
bench's formula (copied below, the bandwidth a parameter) at all seven
``BENCH_CONFIG``s' card widths, the refused knobs, and its failures:
without a GPU and without ``--device cpu`` it exits non-zero with no
throughput, and an exception inside exits 1. Every subprocess has a
deadline."""

import json
import os
import subprocess
import sys

import pytest

from ppl.llm.serving_tpu_torch.config import ConfigError
from ppl.llm.serving_tpu_torch.ops import kernels
from ppl.llm.serving_tpu_torch.tools import bench

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the keys of the JAX bench's result line (bench.py:370-385)
JAX_KEYS = {"metric", "value", "unit", "vs_baseline", "config",
            "p50_ttft_ms", "elapsed_s", "roofline_tokens_per_sec", "backend"}
H100_SXM = 3.35e12


def run_bench(*args, env=None, timeout=240):
    return subprocess.run(
        [sys.executable, "-m", "ppl.llm.serving_tpu_torch.tools.bench",
         *args], cwd=REPO, capture_output=True, text=True, timeout=timeout,
        env=dict(os.environ, **(env or {})))


def json_lines(stdout):
    out = []
    for line in stdout.splitlines():
        try:
            out.append(json.loads(line))
        except ValueError:
            continue
    return out


def test_cpu_run_prints_one_json_line_with_the_jax_keys():
    proc = run_bench("--device", "cpu")
    assert proc.returncode == 0, proc.stdout + proc.stderr[-3000:]
    (rec,) = json_lines(proc.stdout)
    assert proc.stdout.strip() == json.dumps(rec)
    assert JAX_KEYS <= set(rec) and {"device", "power_limit_w",
                                      "launches"} <= set(rec)
    assert rec["metric"] == "output_tokens_per_sec_per_chip"
    assert rec["value"] > 0 and rec["elapsed_s"] > 0
    assert rec["backend"] == "cpu" and rec["device"] == "cpu"
    assert rec["config"] == "tiny-smoke-b8-in16-out16"
    # no card: no roofline and no power limit, and no kernel launched
    assert rec["vs_baseline"] is None
    assert rec["roofline_tokens_per_sec"] is None
    assert rec["power_limit_w"] is None
    assert rec["launches"] == {k: 0 for k in kernels.launch_counts()}
    assert not any(k.startswith("partial") or k == "error" for k in rec)


def jax_roofline(model_cfg, variant, quantize_lm_head, batch, prompt_len,
                 gen_len, hbm_bytes_per_s):
    """The JAX bench's decode roofline (bench.py:347-368), copied, with
    its V5E_HBM_GBPS * 1e9 as a parameter."""
    wbytes = (1 if variant in ("i8i8", "i8i8_w")
              else 0.5 if variant == "w4" else 2)
    kvbytes = (1 + 2 / model_cfg.cache_quant_group
               if model_cfg.cache_quant_bit == 8 else 2)
    head_wbytes = (wbytes if quantize_lm_head else 2)
    param_bytes = (
        head_wbytes * model_cfg.vocab_size * model_cfg.hidden_dim
        + wbytes * model_cfg.num_layers * (
            model_cfg.hidden_dim * (model_cfg.num_heads
                                    + 2 * model_cfg.num_kv_heads)
            * model_cfg.head_dim
            + model_cfg.num_heads * model_cfg.head_dim * model_cfg.hidden_dim
            + 3 * model_cfg.hidden_dim * model_cfg.intermediate_dim))
    kv_bytes_per_seq = (model_cfg.num_layers * 2 * model_cfg.num_kv_heads
                        * model_cfg.head_dim * kvbytes
                        * (prompt_len + gen_len / 2))
    step_bytes = param_bytes + batch * kv_bytes_per_seq
    roofline_tps = hbm_bytes_per_s / step_bytes * batch
    return step_bytes, roofline_tps


# the JAX bench's variant after its 7B remap (bench.py:128)
JAX_VARIANT = {"i8i8_7b": "i8i8", "w4_7b": "w4"}


@pytest.mark.parametrize("config", bench.VARIANTS)
@pytest.mark.parametrize("bw", [H100_SXM, 819e9])
def test_roofline_is_the_jax_formula(config, bw):
    s = bench.bench_setup("cuda", {"BENCH_CONFIG": config})
    args = (s["model_cfg"], s["quant"], s["resource_cfg"].quantize_lm_head,
            s["batch"], s["prompt_len"], s["gen_len"], bw)
    want = jax_roofline(s["model_cfg"], JAX_VARIANT.get(config, config),
                        *args[2:])
    assert bench.decode_roofline(*args) == want


@pytest.mark.parametrize("config,model,batch,kv,roofline", [
    ("i8i8", "tinyllama1.1b", 64, 131072, 177_566),
    ("i8i8_7b", "llama2-7b", 48, 16384, 16_703),
])
def test_card_widths_and_rooflines(config, model, batch, kv, roofline):
    """TinyLlama b64 and the 7B north-star b48 as the JAX bench sizes
    them, and their rooflines on the H100 SXM's 3.35 TB/s (reckoned from
    the formula, not measured)."""
    s = bench.bench_setup("cuda", {"BENCH_CONFIG": config})
    m, r, g = s["model_cfg"], s["resource_cfg"], s["gen_cfg"]
    assert s["config"] == f"{model}-{config}-b{batch}-in128-out128"
    assert (s["batch"], r.kv_cache_max_tokens) == (batch, kv)
    assert (m.num_layers, m.cache_quant_bit, m.cache_quant_group) == \
        ((22 if model.startswith("tiny") else 32), 8, 8)
    assert r.quant_method == "online_i8i8" and r.quantize_lm_head
    assert r.multi_step == 16 and r.token_buckets == (128, 256, 8192)
    assert r.batch_buckets == (batch, 4 * batch)
    assert g.max_prefill_batch == (64 if model.startswith("tiny") else 16)
    assert g.max_running_batch == 4 * batch
    _, tps = bench.decode_roofline(m, s["quant"], r.quantize_lm_head, batch,
                                   128, 128, H100_SXM)
    assert round(tps) == roofline


def test_knobs_keep_their_jax_meaning():
    env = {"BENCH_CONFIG": "w4_7b", "BENCH_BATCH": "32",
           "BENCH_KV_TOKENS": "8192", "BENCH_MULTI_STEP": "8",
           "BENCH_MAX_PREFILL_BATCH": "4", "BENCH_QUANT_LM_HEAD": "0",
           "BENCH_SPEC_BLOCKS": "2", "BENCH_BLOCK_TAIL": "on",
           "BENCH_WAVES": "2", "BENCH_PROFILE": "2",
           "BENCH_TRACE_DIR": "/x", "BENCH_TRACE_START": "5",
           "BENCH_TRACE_STEPS": "6", "BENCH_DEADLINE": "30"}
    s = bench.bench_setup("cuda", env)
    r, g = s["resource_cfg"], s["gen_cfg"]
    assert (s["batch"], r.kv_cache_max_tokens, r.multi_step) == (32, 8192, 8)
    assert r.quant_method == "online_w4a8" and not r.quantize_lm_head
    assert r.block_tail == "on" and g.max_prefill_batch == 4
    assert (g.speculative_blocks, g.enable_profiling,
            g.profile_step_interval) == (2, True, 1)
    assert (g.trace_dir, g.trace_start_step, g.trace_num_steps) == \
        ("/x", 5, 6)
    assert (s["waves"], s["deadline"]) == (2, 30.0)
    # the CPU smoke keeps the 7B config's quantization at tiny widths
    cpu = bench.bench_setup("cpu", {"BENCH_CONFIG": "w4_7b"})
    assert cpu["model_cfg"].hidden_dim == 64 and cpu["deadline"] == 0
    assert cpu["resource_cfg"].quant_method == "online_w4a8"


@pytest.mark.parametrize("knob,value", [
    ("BENCH_AOT", "1"), ("BENCH_QUANT_IMPL", "pallas"),
    ("BENCH_QUANT_IMPL", "auto"), ("BENCH_SEQ_BLOCK", "8")])
def test_unported_knobs_raise(knob, value):
    with pytest.raises(ConfigError, match="not yet ported"):
        bench.bench_setup("cpu", {knob: value})


def test_aot_off_and_unknown_config():
    bench.bench_setup("cpu", {"BENCH_AOT": "0"})
    with pytest.raises(ConfigError, match="BENCH_CONFIG"):
        bench.bench_setup("cpu", {"BENCH_CONFIG": "fp8"})


def test_without_a_gpu_it_fails_and_prints_no_throughput():
    proc = run_bench(timeout=120)
    assert proc.returncode != 0
    (rec,) = json_lines(proc.stdout)
    assert rec["value"] == 0 and "cuda" in rec["error"]
    assert "elapsed_s" not in rec and "backend" not in rec


def test_a_refused_knob_exits_1_with_the_error_line():
    proc = run_bench("--device", "cpu", env={"BENCH_SEQ_BLOCK": "4"},
                     timeout=120)
    assert proc.returncode == 1
    (rec,) = json_lines(proc.stdout)
    assert rec["value"] == 0 and "not yet ported" in rec["error"]


def test_an_exception_inside_exits_1(monkeypatch, capsys):
    def boom(*a):
        raise RuntimeError("engine lost")

    monkeypatch.setattr(bench, "run", boom)
    assert bench.main(["--device", "cpu"]) == 1
    (rec,) = json_lines(capsys.readouterr().out)
    assert rec == {"metric": "output_tokens_per_sec_per_chip", "value": 0,
                   "unit": "tokens/s", "vs_baseline": 0,
                   "error": "RuntimeError: engine lost"}


@pytest.mark.parametrize("partial,rc", [
    (dict(partial_last_wave=True), 0),
    (dict(partial_last_wave=True, error="measured wave timed out"), 1),
    (dict(partial_warmup=True, error="warmup incomplete"), 1)])
def test_a_deadline_cut_run_keeps_its_flags(monkeypatch, capsys, partial,
                                            rc):
    """The JAX bench's partial flags stay on the line; a run cut before a
    measured wave finished carries an error and exits 1."""
    monkeypatch.setattr(bench, "run", lambda *a: dict(
        metric=bench.METRIC, value=12.5, unit="tokens/s", **partial))
    assert bench.main(["--device", "cpu"]) == rc
    (rec,) = json_lines(capsys.readouterr().out)
    assert {k: rec[k] for k in partial} == partial
