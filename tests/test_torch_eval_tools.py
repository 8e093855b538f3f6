"""The port's eval tools against the JAX package's, on the CPU at tiny
widths, the same inputs through both:

- ``eval_ppl.main`` on a checkpoint written at test time (safetensors +
  a sentencepiece ``tokenizer.model``), ``--device cpu``, f32: the same
  token count and the JAX tool's perplexity within 1e-5 relative, for
  float weights over float KV and i8i8 over int8 KV.
- ``eval_accuracy_delta``: ``hf_to_params`` and
  ``degrade_params_int4_pertensor`` byte-equal to the JAX tool's on one
  state dict; ``eval_nll``'s per-chunk NLL sums within 1e-5 relative and
  KL sums within 1e-6 absolute of the JAX tool's for the float32 configs;
  ``paired_bootstrap_delta`` equal; ``load_corpus`` equal on the same
  files; and the JAX tool's ``main``, fed the port's probe, corpus and
  NLLs, writes the port's JSON: the same bootstrap CIs, KL CIs, power
  and budget gates, verdicts and exit code.
- The probe ``ProbeLlama``'s forward equals HF ``LlamaForCausalLM``'s on
  the same weights (atol 1e-5), and its training is repeatable.
- A 5-step CPU run of the tool writes its JSON; ``--device cuda``
  raises without a GPU.
"""

import json
import math
import os
import re
import sys

import jax
import numpy as np
import pytest
import torch
from transformers import LlamaConfig, LlamaForCausalLM

from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.tools import eval_accuracy_delta as jead
from ppl.llm.serving_tpu.tools import eval_ppl as jeval_ppl
from ppl.llm.serving_tpu_torch.config import ModelConfig
from ppl.llm.serving_tpu_torch.models import llama
from ppl.llm.serving_tpu_torch.tools import eval_accuracy_delta as ead
from ppl.llm.serving_tpu_torch.tools import eval_ppl

import test_sp_crossval as crossval
from test_torch_loader import (assert_same_bytes, family_tensors,
                               write_checkpoint)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROBE = dict(hidden_dim=64, intermediate_dim=128, num_layers=2,
             num_heads=4, num_kv_heads=2, vocab_size=256, norm_eps=1e-5,
             rope_theta=10000.0, cache_mode=1, page_size=16,
             dtype="float32")
PROBE_ARGS = ["--hidden", "64", "--layers", "2", "--heads", "4",
              "--kv-heads", "2", "--intermediate", "128", "--seq-len", "64",
              "--batch", "2", "--eval-chunks", "6"]
RESULT = re.compile(r"\[RESULT\] tokens: (\d+)  mean NLL: (\S+)  "
                    r"perplexity: (\S+)")


def from_jax(jparams):
    return llama.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams),
                                 "cpu")


def probe(seed=0):
    return ead.ProbeLlama(ModelConfig(**PROBE),
                          torch.Generator().manual_seed(seed)).eval()


def corpus():
    return ead.load_corpus([os.path.join(REPO, "README.md")], min_bytes=0)


@pytest.fixture(scope="module")
def checkpoint(tmp_path_factory):
    """A tiny LLaMA checkpoint whose vocabulary covers the protobuf
    runtime's tokenizer of tests/test_sp_crossval.py, beside it."""
    d = tmp_path_factory.mktemp("ckpt")
    sd, doc = family_tensors("llama_gqa")
    n = len(crossval.PIECES)
    gen = torch.Generator().manual_seed(4)
    sd["model.embed_tokens.weight"] = torch.randn(n, 64, generator=gen)
    sd["lm_head.weight"] = 0.05 * torch.randn(n, 64, generator=gen)
    doc["vocab_size"] = n
    write_checkpoint(str(d), sd, doc)
    (d / "tokenizer.model").write_bytes(
        crossval._google_model_bytes(crossval.PIECES))
    text = d / "corpus.txt"
    text.write_text(open(os.path.join(REPO, "README.md")).read()[:4000])
    return d


@pytest.mark.parametrize("flags", [
    [], ["--quant-method", "online_i8i8", "--cache-quant-bit", "8"]],
    ids=["float", "i8i8_kv8"])
def test_eval_ppl_matches_jax_tool(checkpoint, flags, capsys, monkeypatch):
    argv = ["--model-dir", str(checkpoint), "--dtype", "float32",
            "--page-size", "16", "--text-file",
            str(checkpoint / "corpus.txt"), "--seq-len", "64",
            "--max-chunks", "4"] + flags
    got = eval_ppl.main(["--device", "cpu"] + argv)
    port_line = RESULT.search(capsys.readouterr().out)
    monkeypatch.setattr(sys, "argv", ["eval_ppl"] + argv)
    jeval_ppl.main()
    jax_line = RESULT.search(capsys.readouterr().out)
    assert port_line and jax_line
    assert got["tokens"] == int(jax_line.group(1)) == int(port_line.group(1))
    assert got["chunks"] == 4
    ppl = float(jax_line.group(3))
    assert abs(got["perplexity"] - ppl) <= 1e-5 * ppl
    assert abs(float(port_line.group(3)) - ppl) <= 1e-5 * ppl


def test_eval_ppl_needs_a_gpu_for_cuda(checkpoint):
    with pytest.raises(RuntimeError, match="cuda"):
        eval_ppl.main(["--device", "cuda", "--model-dir", str(checkpoint),
                       "--text-file", str(checkpoint / "corpus.txt")])


def test_hf_to_params_and_degrade_match_jax():
    model = probe()
    cfg = ModelConfig(**PROBE)
    params = ead.hf_to_params(model, cfg)
    jparams = jead.hf_to_params(model, JModelConfig(**PROBE))
    assert_same_bytes(params, from_jax(jparams))
    assert_same_bytes(ead.degrade_params_int4_pertensor(params),
                      from_jax(jead.degrade_params_int4_pertensor(jparams)))


@pytest.mark.parametrize("quant,kv", [("none", 0), ("online_i8i8", 8),
                                      ("online_w4a8", 8)])
def test_eval_nll_matches_jax(quant, kv):
    """Per-chunk NLL sums and KL(fp32 || config) sums of the float32
    configs, with the fp32 run's log-softmax collected by each tool."""
    model, data = probe(), corpus()[:3000]
    cfg, jcfg = ModelConfig(**PROBE), JModelConfig(**PROBE)
    params = ead.hf_to_params(model, cfg)
    jparams = jead.hf_to_params(model, jcfg)
    base, jbase = [], []
    fp32 = dict(quant_method="none", cache_quant=0, quantize_lm_head=False,
                dtype="float32")
    kw = dict(quant_method=quant, cache_quant=kv, quantize_lm_head=False,
              dtype="float32")
    ead.eval_nll(cfg, params, data, 64, 8, base_logprobs=base, **fp32)
    jead.eval_nll(jcfg, jparams, data, 64, 8, base_logprobs=jbase, **fp32)
    got = ead.eval_nll(cfg, params, data, 64, 8, base_logprobs=base, **kw)
    want = jead.eval_nll(jcfg, jparams, data, 64, 8, base_logprobs=jbase,
                         **kw)
    assert got[2] == want[2] and (got[4] == want[4]).all()
    np.testing.assert_allclose(got[3], want[3], rtol=1e-5, atol=0)
    np.testing.assert_allclose(got[5], want[5], rtol=0, atol=1e-6 * 64)
    assert abs(got[1] - want[1]) <= 1e-5 * want[1]


def test_paired_bootstrap_and_corpus_match_jax():
    rng = np.random.default_rng(2)
    tok = rng.integers(50, 64, 20).astype(np.int64)
    base = rng.uniform(1.0, 3.0, 20) * tok
    cfg = base * rng.uniform(0.99, 1.02, 20)
    assert (ead.paired_bootstrap_delta(base, tok, cfg, tok)
            == jead.paired_bootstrap_delta(base, tok, cfg, tok))
    paths = [os.path.join(REPO, p) for p in ("README.md", "SURVEY.md")]
    assert (ead.load_corpus(paths, min_bytes=0)
            == jead.load_corpus(paths, min_bytes=0))


def test_probe_forward_matches_hf():
    model = probe(seed=3)
    hf = LlamaForCausalLM(LlamaConfig(
        hidden_size=64, intermediate_size=128, num_hidden_layers=2,
        num_attention_heads=4, num_key_value_heads=2, vocab_size=256,
        rms_norm_eps=1e-5, rope_theta=10000.0, max_position_embeddings=256,
        attention_bias=False, tie_word_embeddings=False)).eval()
    hf.load_state_dict(model.state_dict(), strict=True)
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 256, (2, 40)))
    with torch.no_grad():
        np.testing.assert_allclose(model(ids).numpy(),
                                   hf(input_ids=ids).logits.numpy(),
                                   atol=1e-5, rtol=0)


def test_probe_training_is_repeatable():
    cfg, data = ModelConfig(**PROBE), corpus()
    a = ead.train_probe(cfg, data, 3, 32, 2, "cpu", seed=5)
    b = ead.train_probe(cfg, data, 3, 32, 2, "cpu", seed=5)
    sa, sb = a.state_dict(), b.state_dict()
    assert list(sa) == list(sb)
    assert all(torch.equal(sa[k], sb[k]) for k in sa)
    assert not torch.equal(sa["lm_head.weight"],
                           probe(seed=5).state_dict()["lm_head.weight"])


def test_gates_and_json_match_jax_tool(tmp_path, monkeypatch):
    """Both tools' ``main`` on one probe and corpus, the JAX tool's NLLs
    computed by the port's ``eval_nll``: the same JSON document (every
    config's NLL, ppl, deltas, CIs, KL CIs; the power gate, the int8 and
    int4 budgets and verdicts) and the same exit code."""
    model, data = probe(seed=1), corpus()
    monkeypatch.setattr(ead, "load_corpus", lambda paths: data)
    monkeypatch.setattr(ead, "train_probe", lambda *a, **k: model)
    monkeypatch.setattr(jead, "load_corpus", lambda paths: data)
    monkeypatch.setattr(jead, "train_tiny_llama", lambda *a, **k: model)

    def port_eval_nll(jcfg, jparams, *args, **kw):
        cfg = ModelConfig(**{k: getattr(jcfg, k) for k in PROBE})
        return ead.eval_nll(cfg, from_jax(jparams), *args, **kw)

    monkeypatch.setattr(jead, "eval_nll", port_eval_nll)
    port_json, jax_json = tmp_path / "port.json", tmp_path / "jax.json"
    rc = ead.main(["--device", "cpu", "--json-out", str(port_json)]
                  + PROBE_ARGS)
    monkeypatch.setattr(sys, "argv", ["eval_accuracy_delta", "--json-out",
                                      str(jax_json)] + PROBE_ARGS)
    with pytest.raises(SystemExit) as e:
        jead.main()
    assert e.value.code == rc
    got, want = json.loads(port_json.read_text()), json.loads(
        jax_json.read_text())
    for key in ("results", "worst_kl_ci95", "worst_config", "power_ok",
                "budget_nats", "verdict", "budget4_nats", "verdict_int4",
                "train_steps"):
        assert got[key] == want[key], key
    assert set(got["results"]) == {name for name, _ in ead.CONFIGS}


def test_tool_writes_its_json_in_5_cpu_steps(tmp_path):
    out = tmp_path / "acc.json"
    rc = ead.main(["--device", "cpu", "--train-steps", "5", "--eval-chunks",
                   "3", "--json-out", str(out)] + PROBE_ARGS[:-2])
    doc = json.loads(out.read_text())
    assert rc == (0 if doc["verdict"] == doc["verdict_int4"] == "PASS"
                  else 1)
    assert doc["train_steps"] == 5 and doc["model"]["hidden_dim"] == 64
    for name, _ in ead.CONFIGS:
        r = doc["results"][name]
        assert math.isfinite(r["mean_nll"]) and r["tokens"] == 3 * 63
    assert doc["verdict"] in ("PASS", "FAIL")


def test_tool_needs_a_gpu_for_cuda():
    with pytest.raises(RuntimeError, match="cuda"):
        ead.main(["--device", "cuda", "--train-steps", "1"])
