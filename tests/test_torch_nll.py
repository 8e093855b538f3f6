"""The port's ``make_nll_fn`` (the perplexity forward: one prefill row of
the whole sequence through the serving layers, K2 at start 0) against the
JAX package's, run as tests/test_ppl_eval.py runs it (XLA attention and
matmuls), on the same numpy-seeded weights (``params_from_jax``) and
tokens, in f32 at 2 layers, hidden 64, 50 valid tokens of 64:

- for float, ``online_i8i8`` and ``online_w4a8`` weights, over float and
  int8 group-8 KV, for LLaMA (RoPE), ALiBi (Baichuan) and qkv/o biases
  (InternLM): the masks equal, the valid positions' NLL and log-softmax
  within atol 1e-5, except with quantized weights over int8 KV, held to
  tests/test_torch_step.py's int8-KV rule (atol 2e-3): there an f32
  summation-order difference upstream may flip one K/V element's int8
  rounding, which moves a score, and the NLLs after it, by about one
  quantization step (seen once in these 6 cases, 1.6e-3, w4a8 LLaMA);
- the float case against HF ``LlamaForCausalLM``'s NLL (the JAX bound,
  atol 3e-4, rtol 1e-3), and the i8i8 perplexity within 5 % of it;
- the int8-KV trap: K2 must read the chunk's own keys as the cache holds
  them (int8 rows and their scales), as the JAX function reads them back;
  float K/V handed over instead would move the NLL by far more than the
  tolerance, which the last test shows.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.models import llama as jllama
from ppl.llm.serving_tpu.ops import kv_cache as jkv
from ppl.llm.serving_tpu_torch.config import ModelConfig
from ppl.llm.serving_tpu_torch.models import llama as tllama
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv

from test_model_numerics import CFG, hf_model, hf_to_params  # noqa: F401

WIDTHS = dict(hidden_dim=64, intermediate_dim=128, num_layers=2,
              num_heads=4, num_kv_heads=2, vocab_size=96, page_size=16,
              dtype="float32")
FAMILIES = {"llama": {}, "alibi": dict(position_encoding="alibi"),
            "attn_bias": dict(attn_bias=True)}
LENGTH, N_VALID = 64, 50
ATOL = 1e-5
INT8_FLIP_ATOL = 2e-3


def specs(kv8, pages=LENGTH // 16):
    kw = dict(num_layers=2, num_pages=pages, page_size=16, num_kv_heads=2,
              head_dim=16, quant_bit=8 if kv8 else 0,
              quant_group=8 if kv8 else 1)
    return (jkv.CacheSpec(dtype=jnp.float32, **kw),
            tkv.CacheSpec(dtype=torch.float32, **kw))


def tokens(n_valid=N_VALID, length=LENGTH, seed=5, vocab=96):
    toks = np.zeros(length, np.int32)
    toks[:n_valid] = np.random.RandomState(seed).randint(0, vocab, n_valid)
    return toks


def jax_nll(jcfg, jspec, jparams, toks, n_valid, quant):
    fn = jllama.make_nll_fn(jcfg, jspec, quant_method=quant,
                            return_logprobs=True)
    cache, scale = jkv.init_cache(jspec)
    if scale is None:
        scale = jnp.zeros((1,), jnp.float32)
    pt = jnp.asarray(np.arange(jspec.num_pages, dtype=np.int32)[None])
    out = fn(jparams, cache, scale, jnp.asarray(toks),
             jnp.asarray(n_valid, jnp.int32), pt)
    return tuple(np.asarray(x) for x in out)


def port_nll(cfg, spec, params, toks, n_valid, quant):
    fn = tllama.make_nll_fn(cfg, spec, quant_method=quant,
                            return_logprobs=True)
    cache, scale = tkv.init_cache(spec, "cpu")
    pt = torch.arange(spec.num_pages, dtype=torch.int32)[None]
    out = fn(params, cache, scale, torch.from_numpy(toks), n_valid, pt)
    return tuple(x.numpy() for x in out)


def both(family, quant, kv8, seed=3):
    kw = dict(WIDTHS, **FAMILIES[family])
    if kv8:
        kw.update(cache_quant_bit=8, cache_quant_group=8)
    jcfg, cfg = JModelConfig(**kw), ModelConfig(**kw)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(seed),
                                 dtype=jnp.float32)
    if quant != "none":
        jparams = jllama.quantize_model_params(jparams, quant)
    params = tllama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    return jcfg, cfg, jparams, params


@pytest.mark.parametrize("kv8", [False, True], ids=["float_kv", "int8_kv"])
@pytest.mark.parametrize("quant", ["none", "online_i8i8", "online_w4a8"])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_nll_matches_jax(family, quant, kv8):
    jcfg, cfg, jparams, params = both(family, quant, kv8)
    jspec, spec = specs(kv8)
    toks = tokens()
    jn, jm, jlp = jax_nll(jcfg, jspec, jparams, toks, N_VALID, quant)
    n, m, lp = port_nll(cfg, spec, params, toks, N_VALID, quant)
    np.testing.assert_array_equal(m, jm)
    assert m.sum() == N_VALID - 1 and n.shape == (LENGTH - 1,)
    assert lp.shape == (LENGTH - 1, 96) and lp.dtype == np.float32
    atol = INT8_FLIP_ATOL if kv8 and quant != "none" else ATOL
    np.testing.assert_allclose(n[m], jn[jm], atol=atol, rtol=0)
    np.testing.assert_allclose(lp[m], jlp[jm], atol=10 * atol, rtol=0)


@pytest.mark.parametrize("n_valid", [2, 33, 64])
def test_nll_mask_and_padding(n_valid):
    """Any valid length, the whole row included: the mask is the JAX
    function's and the padded positions' writes land in the trash page."""
    jcfg, cfg, jparams, params = both("llama", "none", False)
    jspec, spec = specs(False)
    toks = tokens(n_valid)
    jn, jm, _ = jax_nll(jcfg, jspec, jparams, toks, n_valid, "none")
    fn = tllama.make_nll_fn(cfg, spec)
    cache, _ = tkv.init_cache(spec, "cpu")
    n, m = fn(params, cache, None, torch.from_numpy(toks), n_valid,
              torch.arange(spec.num_pages, dtype=torch.int32)[None])
    np.testing.assert_array_equal(m.numpy(), jm)
    np.testing.assert_allclose(n.numpy()[jm], jn[jm], atol=ATOL, rtol=0)
    # every valid position's row is in pages 0.., the rest in the trash
    # page's first slot
    written = (cache != 0).any(dim=2).any(dim=0)
    for layer in range(2):
        rows = written[layer * spec.num_slots:(layer + 1) * spec.num_slots]
        assert rows[:n_valid].all() and not rows[n_valid:LENGTH].any()


def test_nll_matches_hf(hf_model):  # noqa: F811
    """The float NLL against HF transformers (tests/test_ppl_eval.py's
    bound) on HF's own weights, and the i8i8 perplexity within 5 %."""
    jparams = hf_to_params(hf_model)
    params = tllama.params_from_jax(
        jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    cfg = ModelConfig(**{k: getattr(CFG, k) for k in (
        "hidden_dim", "intermediate_dim", "num_layers", "num_heads",
        "num_kv_heads", "vocab_size", "norm_eps", "rope_theta",
        "page_size", "dtype")})
    _, spec = specs(False, pages=2)
    seq = np.random.RandomState(3).randint(0, CFG.vocab_size, size=24)
    toks = np.zeros(32, np.int32)
    toks[:24] = seq
    n, m, _ = port_nll(cfg, spec, params, toks, 24, "none")
    assert m.sum() == 23
    with torch.no_grad():
        logits = hf_model(torch.tensor(seq[None])).logits[0]
        lp = torch.log_softmax(logits, -1)
        hf_nll = -lp[torch.arange(23), torch.tensor(seq[1:])].numpy()
    np.testing.assert_allclose(n[:23], hf_nll, atol=3e-4, rtol=1e-3)
    nq, _, _ = port_nll(cfg, spec, tllama.quantize_model_params(params),
                        toks, 24, "online_i8i8")
    ppl_f, ppl_q = np.exp(n[m].mean()), np.exp(nq[m].mean())
    assert abs(ppl_q - ppl_f) / ppl_f < 0.05, (ppl_f, ppl_q)


@pytest.mark.parametrize("family", list(FAMILIES))
def test_int8_kv_reads_quantized_rows(family):
    """With int8 KV the JAX function reads the chunk's keys back from its
    cache, quantized. The port hands K2 the same int8 rows and scales and
    matches it within ATOL; the float K/V (what a float-KV forward of the
    same weights reads) miss it by over 100x that."""
    jcfg, cfg, jparams, params = both(family, "none", True)
    jspec, spec = specs(True)
    toks = tokens()
    jn, jm, _ = jax_nll(jcfg, jspec, jparams, toks, N_VALID, "none")
    n, m, _ = port_nll(cfg, spec, params, toks, N_VALID, "none")
    np.testing.assert_allclose(n[m], jn[jm], atol=ATOL, rtol=0)
    _, float_spec = specs(False)
    nf, _, _ = port_nll(cfg, float_spec, params, toks, N_VALID, "none")
    assert np.abs(nf[m] - jn[jm]).max() > 100 * ATOL
