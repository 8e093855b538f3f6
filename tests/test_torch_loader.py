"""The port's HF safetensors loader against the JAX package's, on
checkpoints written at test time by ``safetensors.torch.save_file`` (a
writer independent of the port's reader), at tiny widths (2 layers,
hidden 64):

- four families: LLaMA with GQA, Baichuan's fused ``W_pack``, InternLM's
  q/k/v/o biases, tied embeddings without ``lm_head.weight``; BF16, F16
  and F32 tensors; two shards; a header with ``__metadata__``. The port's
  parameters equal the JAX ``load_hf_safetensors`` output carried over by
  ``params_from_jax`` byte for byte.
- Loading layer by layer with ``online_i8i8`` / ``online_w4a8`` equals
  loading float and then ``quantize_model_params``, byte for byte.
- A loaded checkpoint's logits match HF ``LlamaForCausalLM``'s (the JAX
  test_loaded_model_matches_hf_forward bound: atol 2e-4, rtol 1e-4).
- A missing tensor, a name in two files and an unknown dtype raise.
- chip_smoke's inverse mapping (port parameters -> HF checkpoint)
  round-trips through the loader.
- The CLI: ``--model-format`` defaults to ``hf``; ``--cache-quant-bit``
  and ``--prefill-admission-cadence`` reach the configs as in the JAX
  ``build_configs``; ``create_engine`` and the offline CLI serve a
  checkpoint directory.
"""

import argparse
import json
import os
import struct
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch
from safetensors.torch import save_file
from transformers import LlamaConfig, LlamaForCausalLM

from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.models import loader as jloader
from ppl.llm.serving_tpu.tools import common as jcommon
from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)
from ppl.llm.serving_tpu_torch.models import llama, loader
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv
from ppl.llm.serving_tpu_torch.ops import sampling as tsamp
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.tools import common

import chip_smoke
from test_sp_tokenizer import VOCAB, build_model_bytes
from test_torch_weight_build import assert_same_bytes as _same_in_order

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
D, I, L, H, KVH, V = 64, 128, 2, 4, 2, 320
HD = D // H
DTYPES = {"BF16": torch.bfloat16, "F16": torch.float16, "F32": torch.float32}
FAMILIES = ("llama_gqa", "baichuan_w_pack", "internlm_bias", "tied")


def assert_same_bytes(got, want):
    """Equal byte for byte, whatever the order of the keys."""
    def ordered(p):
        out = {k: p[k] for k in sorted(p) if k != "layers"}
        out["layers"] = [{k: lp[k] for k in sorted(lp)}
                         for lp in p["layers"]]
        return out
    _same_in_order(ordered(got), ordered(want))


def hf_model(kv_heads=KVH, seed=1):
    torch.manual_seed(seed)
    cfg = LlamaConfig(hidden_size=D, intermediate_size=I,
                      num_hidden_layers=L, num_attention_heads=H,
                      num_key_value_heads=kv_heads, vocab_size=V,
                      rms_norm_eps=1e-5, tie_word_embeddings=False,
                      attention_bias=False)
    return LlamaForCausalLM(cfg).eval()


def family_tensors(family):
    """(state dict in HF names, config.json) of a family."""
    doc = {"hidden_size": D, "intermediate_size": I,
           "num_hidden_layers": L, "num_attention_heads": H,
           "num_key_value_heads": KVH, "vocab_size": V,
           "rms_norm_eps": 1e-5, "rope_theta": 10000.0,
           "max_position_embeddings": 256, "model_type": "llama",
           "tie_word_embeddings": False}
    if family == "baichuan_w_pack":
        # Baichuan is MHA: q, k and v rows fused as W_pack [q | k | v]
        sd = dict(hf_model(kv_heads=H).state_dict())
        doc.update(num_key_value_heads=H, model_type="baichuan")
        for i in range(L):
            pre = f"model.layers.{i}.self_attn."
            sd[pre + "W_pack.weight"] = torch.cat(
                [sd.pop(pre + f"{n}_proj.weight") for n in "qkv"])
        return sd, doc
    sd = dict(hf_model().state_dict())
    if family == "internlm_bias":
        doc.update(model_type="internlm", bias=True)
        gen = torch.Generator().manual_seed(3)
        for i in range(L):
            pre = f"model.layers.{i}.self_attn."
            for n, width in (("q", H * HD), ("k", KVH * HD),
                             ("v", KVH * HD), ("o", D)):
                sd[pre + f"{n}_proj.bias"] = 0.1 * torch.randn(
                    width, generator=gen)
    if family == "tied":
        doc.update(tie_word_embeddings=True)
        del sd["lm_head.weight"]
    return sd, doc


def write_checkpoint(path, sd, doc, dtype="F32", shards=2):
    """``sd`` in ``dtype`` over ``shards`` safetensors files (split in name
    order, each with ``__metadata__``) and ``config.json``."""
    os.makedirs(path, exist_ok=True)
    names = list(sd)
    per = -(-len(names) // shards)
    for s in range(shards):
        part = {n: sd[n].detach().to(DTYPES[dtype]).contiguous()
                for n in names[s * per:(s + 1) * per]}
        save_file(part, os.path.join(
            path, f"model-{s + 1:05d}-of-{shards:05d}.safetensors"),
            metadata={"format": "pt"})
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(doc, f)
    return path


def cfg_dtype(file_dtype):
    return "bfloat16" if file_dtype == "BF16" else "float32"


def jax_params(path, dtype):
    jcfg = JModelConfig.from_hf_config(os.path.join(path, "config.json"),
                                       dtype=dtype)
    jp = jloader.load_hf_safetensors(path, jcfg)
    return llama.params_from_jax(jax.tree_util.tree_map(np.asarray, jp),
                                 "cpu", dtype=llama.torch_dtype(dtype))


def port_params(path, dtype, **kw):
    cfg = ModelConfig.from_hf_config(os.path.join(path, "config.json"),
                                     dtype=dtype)
    return cfg, loader.load_hf_safetensors(path, cfg, **kw)


@pytest.mark.parametrize("file_dtype", list(DTYPES))
@pytest.mark.parametrize("family", FAMILIES)
def test_loader_matches_jax_loader(tmp_path, family, file_dtype):
    path = write_checkpoint(str(tmp_path), *family_tensors(family),
                            dtype=file_dtype)
    dtype = cfg_dtype(file_dtype)
    cfg, got = port_params(path, dtype)
    assert_same_bytes(got, jax_params(path, dtype))
    assert got["lm_head"].shape == (D, V) and got["lm_head"].is_contiguous()
    assert ("bqkv" in got["layers"][0]) == (family == "internlm_bias")
    if family == "tied":
        assert torch.equal(got["lm_head"], got["embedding"].T)


@pytest.mark.parametrize("file_dtype", ["F16", "F32"])
def test_loader_casts_to_bf16_as_jax(tmp_path, file_dtype):
    path = write_checkpoint(str(tmp_path), *family_tensors("llama_gqa"),
                            dtype=file_dtype)
    _, got = port_params(path, "bfloat16")
    assert_same_bytes(got, jax_params(path, "bfloat16"))
    assert got["embedding"].dtype == torch.bfloat16


@pytest.mark.parametrize("method,lm_head", [("online_i8i8", False),
                                            ("online_i8i8", True),
                                            ("online_w4a8", True)])
@pytest.mark.parametrize("family", ["llama_gqa", "internlm_bias", "tied"])
def test_layer_by_layer_load_is_byte_equal(tmp_path, family, method,
                                           lm_head):
    path = write_checkpoint(str(tmp_path), *family_tensors(family),
                            dtype="BF16")
    _, float_params = port_params(path, "bfloat16")
    _, got = port_params(path, "bfloat16", quant_method=method,
                         quantize_lm_head=lm_head)
    assert_same_bytes(got, llama.quantize_model_params(float_params, method,
                                                       lm_head))
    assert all("wqkv_q" in lp and "wqkv" not in lp for lp in got["layers"])


def greedy_input(seq, pages, qp):
    b = 1
    pt = np.full((b, 4), pages, np.int32)
    pt[0, 0] = 0
    padded = np.zeros((b, qp), np.int32)
    padded[0, :len(seq)] = seq
    ones, zeros = torch.ones(b), torch.zeros(b)
    return llama.StepInput(
        decode_tokens=torch.zeros(0, dtype=torch.int32),
        decode_pos=torch.zeros(0, dtype=torch.int32),
        prefill_tokens=torch.from_numpy(padded),
        prefill_start=torch.zeros(b, dtype=torch.int32),
        prefill_len=torch.tensor([len(seq)], dtype=torch.int32),
        page_table=torch.from_numpy(pt),
        context_len=torch.tensor([len(seq)], dtype=torch.int32),
        batch_slots=torch.zeros(b, dtype=torch.int32),
        sampling=tsamp.SamplingParams(
            ones, torch.ones(b, dtype=torch.int32), zeros,
            torch.zeros(b, dtype=torch.bool), ones, zeros, zeros))


@pytest.mark.parametrize("family", ["llama_gqa", "tied"])
def test_loaded_model_matches_hf_forward(tmp_path, family):
    """Load from disk, run the port's step (plain versions on the CPU),
    compare the last position's logits with HF's."""
    sd, doc = family_tensors(family)
    path = write_checkpoint(str(tmp_path), sd, doc)
    model = hf_model()
    if family == "tied":
        model.lm_head.weight = model.model.embed_tokens.weight
    cfg = ModelConfig.from_hf_config(os.path.join(path, "config.json"),
                                     dtype="float32", page_size=16)
    params = loader.load_params(cfg, "hf", path, device="cpu")
    spec = tkv.CacheSpec(num_layers=L, num_pages=8, page_size=16,
                         num_kv_heads=KVH, head_dim=HD, dtype=torch.float32)
    step = llama.make_step_fn(cfg, spec, return_logits=True,
                              greedy_only=True)
    cache, _ = tkv.init_cache(spec, "cpu")
    seq = np.array([5, 17, 31, 44, 2, 9, 80, 13, 300, 7])
    out = step(params, cache, None, torch.zeros((1, 1), dtype=torch.int32),
               greedy_input(seq, spec.num_pages, 16))
    with torch.no_grad():
        want = model(torch.tensor(seq[None])).logits[0, -1].numpy()
    np.testing.assert_allclose(out.logits[0].numpy(), want, atol=2e-4,
                               rtol=1e-4)


def test_missing_tensor_raises(tmp_path):
    sd, doc = family_tensors("llama_gqa")
    del sd["model.layers.1.mlp.up_proj.weight"]
    path = write_checkpoint(str(tmp_path), sd, doc)
    with pytest.raises(loader.CheckpointError,
                       match="model.layers.1.mlp.up_proj.weight"):
        port_params(path, "float32")


def test_duplicate_tensor_raises(tmp_path):
    sd, doc = family_tensors("llama_gqa")
    path = write_checkpoint(str(tmp_path), sd, doc)
    save_file({"model.norm.weight": sd["model.norm.weight"]},
              os.path.join(path, "extra.safetensors"))
    with pytest.raises(loader.CheckpointError, match="model.norm.weight"):
        port_params(path, "float32")


@pytest.mark.parametrize("dtype", [torch.float64, torch.int64])
def test_unknown_dtype_raises(tmp_path, dtype):
    sd, doc = family_tensors("llama_gqa")
    sd["model.norm.weight"] = sd["model.norm.weight"].to(dtype)
    path = str(tmp_path)
    os.makedirs(path, exist_ok=True)
    save_file({k: v.contiguous() for k, v in sd.items()},
              os.path.join(path, "model.safetensors"))
    with open(os.path.join(path, "config.json"), "w") as f:
        json.dump(doc, f)
    with pytest.raises(loader.CheckpointError, match="dtype"):
        port_params(path, "float32")


def test_no_safetensors_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        loader.SafetensorsDir(str(tmp_path))


def test_header_past_end_raises(tmp_path):
    path = tmp_path / "model.safetensors"
    path.write_bytes(struct.pack("<Q", 1 << 20) + b"{}")
    with pytest.raises(loader.CheckpointError, match="header"):
        loader.SafetensorsDir(str(tmp_path))


def test_reader_maps_without_reading_whole_files(tmp_path):
    """``get`` returns a view of the file's mapping (no copy on the host
    until a device or a dtype asks for one)."""
    sd, doc = family_tensors("llama_gqa")
    path = write_checkpoint(str(tmp_path), sd, doc, shards=1)
    st = loader.SafetensorsDir(path)
    t = st.get("model.embed_tokens.weight")
    assert isinstance(st._maps[st.files[0]], np.memmap)
    assert torch.equal(t, sd["model.embed_tokens.weight"])
    assert len(st) == len(sd)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_chip_smoke_checkpoint_round_trips(tmp_path, dtype):
    """chip_smoke writes the port's parameters as an HF checkpoint (two
    shards, their index, config.json); the loader reads the same bytes."""
    widths = dict(hidden_dim=D, intermediate_dim=I, num_layers=L,
                  num_heads=H, num_kv_heads=KVH, vocab_size=V)
    cfg = ModelConfig(**widths, dtype={torch.bfloat16: "bfloat16",
                                       torch.float32: "float32"}[dtype])
    params = llama.init_params(cfg, torch.Generator().manual_seed(9),
                               dtype=dtype)
    path = str(tmp_path)
    total = chip_smoke.write_hf_checkpoint(torch, params, widths, path)
    with open(os.path.join(path, "model.safetensors.index.json")) as f:
        index = json.load(f)
    assert sorted(set(index["weight_map"].values())) == [
        "model-00001-of-00002.safetensors",
        "model-00002-of-00002.safetensors"]
    assert index["metadata"]["total_size"] == total
    got_cfg = ModelConfig.from_hf_config(os.path.join(path, "config.json"),
                                         dtype=cfg.dtype)
    assert (got_cfg.num_layers, got_cfg.num_kv_heads) == (L, KVH)
    assert_same_bytes(loader.load_hf_safetensors(path, got_cfg), params)
    assert_same_bytes(jax_params(path, cfg.dtype), params)


def parse(argv, mod):
    p = argparse.ArgumentParser()
    mod.add_model_args(p)
    mod.add_generator_args(p)
    return p.parse_args(argv)


@pytest.mark.parametrize("flags", [
    [],
    ["--cache-quant-bit", "8", "--prefill-admission-cadence", "0"],
    ["--cache-quant-bit", "0", "--prefill-admission-cadence", "3"],
], ids=["defaults", "kv8-cadence0", "kv0-cadence3"])
def test_cli_flags_reach_configs_as_in_jax(tmp_path, flags):
    sd, doc = family_tensors("llama_gqa")
    path = write_checkpoint(str(tmp_path), sd, doc)
    argv = ["--model-dir", path] + flags
    m, r, g = common.build_configs(parse(argv, common))
    jm, jr, jg = jcommon.build_configs(parse(argv, jcommon))
    assert r.model_format == jr.model_format == "hf"
    for key in ("cache_quant_bit", "cache_quant_group", "num_layers",
                "num_kv_heads", "page_size", "dtype"):
        assert getattr(m, key) == getattr(jm, key), key
    assert g.prefill_admission_cadence == jg.prefill_admission_cadence
    assert r.tokenizer_path == jr.tokenizer_path == path


def test_create_engine_loads_a_checkpoint(tmp_path):
    sd, doc = family_tensors("llama_gqa")
    path = write_checkpoint(str(tmp_path), sd, doc, dtype="BF16")
    cfg = ModelConfig.from_hf_config(os.path.join(path, "config.json"),
                                     dtype="bfloat16", page_size=16)
    engine, _, _ = create_engine(
        cfg, ResourceConfig(device="cpu", model_dir=path,
                            quant_method="online_i8i8",
                            kv_cache_max_tokens=256),
        GeneratorConfig(max_running_batch=4, max_prefill_batch=2,
                        max_tokens_per_step=64,
                        max_total_tokens_per_request=64))
    _, want = port_params(path, "bfloat16", quant_method="online_i8i8")
    assert_same_bytes(engine._params, want)


def test_offline_cli_serves_a_checkpoint(tmp_path):
    """``offline_inference --model-dir D``: the weights, the widths and
    the sentencepiece tokenizer all come from D."""
    sd, doc = family_tensors("llama_gqa")
    path = write_checkpoint(str(tmp_path), sd, doc)
    (tmp_path / "tokenizer.model").write_bytes(build_model_bytes(VOCAB))
    out = subprocess.run(
        [sys.executable, "-m",
         "ppl.llm.serving_tpu_torch.tools.offline_inference", "--device",
         "cpu", "--model-dir", path, "--dtype", "float32", "--page-size",
         "16", "--kv-cache-max-tokens", "1024", "--generation-len", "6",
         "--max-total-tokens-per-request", "256", "--prompt",
         "hello world"], cwd=REPO, capture_output=True, text=True,
        timeout=180)
    assert out.returncode == 0, out.stdout + out.stderr
    last = out.stdout.strip().splitlines()[-1]
    assert last.startswith("generated ") and last.endswith("on cpu")
