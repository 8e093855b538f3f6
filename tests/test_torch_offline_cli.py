"""The port's entry points: the offline CLI on the CPU (every model
family), no silent CPU fallback when a GPU is asked for, and every
not-yet-ported option refused by name."""

import os
import subprocess
import sys

import pytest
import torch

from ppl.llm.serving_tpu_torch.config import (ConfigError, GeneratorConfig,
                                              ModelConfig, ResourceConfig)
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = os.path.join(REPO, "tests", "data", "params_tiny.json")
# the same widths with an int8 group-8 KV cache
TINY_INT8KV = os.path.join(REPO, "tests", "data", "params_tiny_int8kv.json")
# the model families: ALiBi over int8 KV (Baichuan), qkv/o biases (InternLM)
TINY_ALIBI = os.path.join(REPO, "tests", "data", "params_tiny_alibi.json")
TINY_BIAS = os.path.join(REPO, "tests", "data", "params_tiny_bias.json")


@pytest.mark.parametrize("quant,params", [
    pytest.param("none", TINY, id="none"),
    pytest.param("online_i8i8", TINY, id="online_i8i8"),
    pytest.param("online_w4a8", TINY_INT8KV, id="online_w4a8-int8_kv"),
])
def test_offline_cli_on_cpu(quant, params):
    last = run_cli(["--quant-method", quant, "--model-param-path", params])[-1]
    assert last.startswith("generated ")
    n = int(last.split()[1])
    assert 1 <= n <= 12
    assert last.endswith("on cpu")


def run_cli(args, gen_len=6):
    """The offline CLI on the CPU over two prompts; its output lines."""
    cmd = [sys.executable, "-m",
           "ppl.llm.serving_tpu_torch.tools.offline_inference",
           "--device", "cpu", "--model-format", "random",
           "--model-param-path", TINY, "--tokenizer-type", "dummy", "--dtype", "float32",
           "--kv-cache-max-tokens", "2048", "--generation-len", str(gen_len),
           "--max-total-tokens-per-request", "256",
           "--prompt", "hello", "--prompt", "world", *args]
    out = subprocess.run(cmd, cwd=REPO, capture_output=True, timeout=180)
    text = out.stdout.decode("utf-8", errors="replace")
    assert out.returncode == 0, text + out.stderr.decode(errors="replace")
    lines = [line for line in text.splitlines() if line.strip()]
    assert lines[-1].startswith("generated ") and lines[-1].endswith(
        "on cpu"), text
    return lines


@pytest.mark.parametrize("args", [
    pytest.param(["--multi-step", "8"], id="multi_step=8"),
    pytest.param(["--block-tail", "on", "--speculative-blocks", "2"],
                 id="block_tail=on"),
])
def test_block_options_serve_through_cli(args):
    """Multi-step blocks (the default) and block-tail mode serve through
    the CLI, and print what the per-step loop prints."""
    got = run_cli(args + ["--quant-method", "online_i8i8"], gen_len=20)
    want = run_cli(["--multi-step", "1", "--quant-method", "online_i8i8"],
                   gen_len=20)
    assert got[:-1] == want[:-1]


def tiny_cfgs(**resource):
    mc = ModelConfig.from_params_json(TINY)
    rc = ResourceConfig(model_format="random", kv_cache_max_tokens=1024,
                        **resource)
    return mc, rc, GeneratorConfig(max_running_batch=4)


def test_default_device_raises_without_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mc, rc, gc = tiny_cfgs()
    assert rc.device == "cuda"
    with pytest.raises(RuntimeError, match="cuda"):
        create_engine(mc, rc, gc)


def test_cpu_engine_builds():
    mc, rc, gc = tiny_cfgs(device="cpu")
    engine, kv_max, max_running_batch = create_engine(mc, rc, gc)
    assert kv_max == 1024
    assert max_running_batch == gc.max_running_batch
    assert engine.kv_cache.device.type == "cpu"
    assert engine.kv_scale is None


def test_cpu_engine_builds_w4a8_int8_kv():
    mc = ModelConfig.from_params_json(TINY_INT8KV)
    rc = ResourceConfig(device="cpu", model_format="random",
                        kv_cache_max_tokens=1024,
                        quant_method="online_w4a8", quantize_lm_head=True)
    engine, _, _ = create_engine(mc, rc, GeneratorConfig(max_running_batch=4))
    assert engine.kv_cache.dtype == torch.int8
    assert engine.kv_scale.dtype == torch.bfloat16
    assert engine.kv_scale.shape[0] == engine.kv_cache.shape[1]
    layer = engine._params["layers"][0]
    d, inter = mc.hidden_dim, mc.intermediate_dim
    assert tuple(layer["w_gate_up_q"].shape) == (2, d // 2, inter)
    assert tuple(layer["w_gate_up_s"].shape) == (2, d // 32, inter)
    assert engine._params["lm_head_q"].dtype == torch.int8


@pytest.mark.parametrize("dtype,kv8", [("bfloat16", False),
                                       ("bfloat16", True)])
def test_kv_pool_sizing_matches_jax(dtype, kv8):
    """compute_kv_cache_max_tokens counts 2-byte (bf16) elements, or
    1-byte int8 elements plus one bf16 scale per group of 8, as the JAX
    package's does."""
    from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
    from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
    from ppl.llm.serving_tpu.engine import (
        compute_kv_cache_max_tokens as j_compute)
    from ppl.llm.serving_tpu_torch.engine import compute_kv_cache_max_tokens
    # LLaMA-2-7B widths (bench.py's 7B configuration)
    widths = dict(hidden_dim=4096, intermediate_dim=11008, num_layers=32,
                  num_heads=32, num_kv_heads=32, vocab_size=32000,
                  dtype=dtype)
    if kv8:
        widths.update(cache_quant_bit=8, cache_quant_group=8)
    for free in (0, 40 << 30, 70_000_000_123):
        want = j_compute(JModelConfig(**widths), JResourceConfig(), free)
        got = compute_kv_cache_max_tokens(ModelConfig(**widths),
                                          ResourceConfig(), free)
        assert got == want


@pytest.mark.parametrize("field,value,what", [
    ("tensor_parallel_size", 2, "tensor parallelism"),
])
def test_resource_options_not_ported(field, value, what):
    rc = ResourceConfig(device="cpu", **{field: value})
    with pytest.raises(ConfigError, match="not yet ported") as e:
        rc.validate()
    assert what in str(e.value)


def test_model_format_hf_accepted():
    """``hf`` is the default, as in the JAX package, and validates;
    an unknown format does not."""
    from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
    assert ResourceConfig().model_format == JResourceConfig().model_format
    for fmt in ("hf", "random"):
        ResourceConfig(device="cpu", model_format=fmt).validate()
    with pytest.raises(ConfigError, match="unknown model_format"):
        ResourceConfig(device="cpu", model_format="onnx").validate()


def test_block_defaults_follow_jax():
    """The JAX package's defaults: blocks of 8 steps with per-step cache
    writes, one speculative block, admission cadence 1; the CLI's flags
    the same."""
    from ppl.llm.serving_tpu.config import GeneratorConfig as JGeneratorConfig
    from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
    from ppl.llm.serving_tpu_torch.tools import common
    rc, jrc = ResourceConfig(device="cpu"), JResourceConfig()
    assert (rc.multi_step, rc.block_tail) == (jrc.multi_step, jrc.block_tail)
    gc, jgc = GeneratorConfig(), JGeneratorConfig()
    assert ((gc.speculative_blocks, gc.prefill_admission_cadence)
            == (jgc.speculative_blocks, jgc.prefill_admission_cadence))
    import argparse
    p = argparse.ArgumentParser()
    common.add_model_args(p)
    common.add_generator_args(p)
    args = p.parse_args(["--model-param-path", TINY, "--device", "cpu"])
    _, rcfg, gcfg = common.build_configs(args)
    assert (rcfg.multi_step, rcfg.block_tail) == (8, "auto")
    assert gcfg.speculative_blocks == 1
    rcfg.validate()
    ResourceConfig(device="cpu", block_tail="on").validate()
    with pytest.raises(ConfigError, match="block_tail"):
        ResourceConfig(device="cpu", block_tail="sometimes").validate()


def test_w4a8_and_int8_kv_accepted():
    ResourceConfig(device="cpu", quant_method="online_w4a8",
                   quantize_lm_head=True).validate()
    ModelConfig.from_params_json(TINY_INT8KV).validate()
    # the JAX package's rule: int4 nibble pairs need the whole contraction
    with pytest.raises(ConfigError, match="tensor_parallel_size == 1"):
        ResourceConfig(device="cpu", quant_method="online_w4a8",
                       tensor_parallel_size=2).validate()


@pytest.mark.parametrize("field,value", [
    ("position_encoding", "alibi"),
    ("attn_bias", True),
])
def test_model_families_validate(field, value):
    """ALiBi (Baichuan-13B) and qkv/o biases (InternLM-7B) are served."""
    mc = ModelConfig.from_params_json(TINY)
    setattr(mc, field, value)
    mc.validate()
    with pytest.raises(ConfigError, match="position_encoding"):
        ModelConfig(**dict(vars(mc), position_encoding="xpos")).validate()


@pytest.mark.parametrize("params,family", [
    pytest.param(TINY_ALIBI, dict(model_type="baichuan",
                                  position_encoding="alibi"),
                 id="baichuan-alibi-int8_kv"),
    pytest.param(TINY_BIAS, dict(model_type="internlm", attn_bias=True),
                 id="internlm-attn_bias"),
])
def test_family_fixture_serves_through_cli(params, family):
    """A params.json naming the family serves on the CPU; multi-step
    blocks print what the per-step loop prints."""
    mc = ModelConfig.from_params_json(params)
    assert {k: getattr(mc, k) for k in family} == family
    args = ["--model-param-path", params, "--quant-method", "online_i8i8"]
    got = run_cli(args, gen_len=12)
    assert got[:-1] == run_cli(args + ["--multi-step", "1"], gen_len=12)[:-1]


def test_sentencepiece_tokenizer_not_ported(tmp_path):
    """No longer refused: a ``tokenizer.model`` resolves to the port's
    sentencepiece tokenizer, by path and by type."""
    from test_sp_tokenizer import VOCAB, build_model_bytes
    from ppl.llm.serving_tpu_torch.tokenizer.sp_tokenizer import SPTokenizer
    path = tmp_path / "tokenizer.model"
    path.write_bytes(build_model_bytes(VOCAB))
    for tok in (create_tokenizer("llama", str(path)),
                create_tokenizer("llama", str(path), "sentencepiece")):
        assert isinstance(tok._backend, SPTokenizer)
        assert tok.encode("hello world")[0] == tok.bos_id == 1
