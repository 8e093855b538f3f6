"""Model families of the port vs the JAX package on the CPU: ALiBi
position encoding (Baichuan-13B) and qkv/o projection biases
(InternLM-7B), on the same numpy inputs and weights.

- ``alibi_slopes`` equal the JAX package's, 40 heads (not a power of
  two) included.
- ALiBi decode and prefill attention: the port's plain versions and the
  K1/K2 wrappers' CPU path against the JAX package's XLA references and
  its Pallas kernels in interpret mode, f32 and int8 KV, deferred mode
  with prefix hits (``start > 0``), at atol 2e-4 (the JAX package's own
  ALiBi kernel-vs-reference tolerance, tests/test_model_families.py):
  the bias ``slope * k_pos`` reaches ~20 at these positions, so the
  scores' f32 roundings are ~100x those of the RoPE tests.
- K1's tail phase with ALiBi against the JAX Pallas decode in interpret
  mode with ``tail_kv``.
- One mixed step of each family, with float and i8i8 weights, against
  the JAX step (XLA attention) on the JAX weights (``params_from_jax``):
  logits within tests/test_torch_step.py's tolerances, greedy tokens
  equal.
- The generator end to end for each family, at ``multi_step`` 1 and 8
  and in block-tail mode, against the JAX generator: greedy tokens equal.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.config import GeneratorConfig as JGeneratorConfig
from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
from ppl.llm.serving_tpu.connection import LocalConnection as JConnection
from ppl.llm.serving_tpu.generator import LLMGenerator as JGenerator
from ppl.llm.serving_tpu.models import llama as jllama
from ppl.llm.serving_tpu.ops import attention as jattn
from ppl.llm.serving_tpu.ops import kv_cache as jkv
from ppl.llm.serving_tpu.ops.pallas import paged_attention as jpk
from ppl.llm.serving_tpu.request import Request as JRequest
from ppl.llm.serving_tpu.resources import create_engine as j_create_engine
from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)
from ppl.llm.serving_tpu_torch.connection import LocalConnection
from ppl.llm.serving_tpu_torch.engine import LLMEngine
from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.models import llama as tllama
from ppl.llm.serving_tpu_torch.ops import attention as tattn
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as tpk
from ppl.llm.serving_tpu_torch.ops.kv_cache import CacheSpec
from ppl.llm.serving_tpu_torch.request import Request

import test_torch_attention as ta
import test_torch_block_tail as tb
import test_torch_step as ts_
from test_torch_multi_step import GEN, MODEL, RESOURCE, ByteTokenizer, serve

ALIBI_TOL = dict(atol=2e-4, rtol=0)
FAMILIES = {"alibi": dict(position_encoding="alibi"),
            "attn_bias": dict(attn_bias=True)}


@pytest.mark.parametrize("n", [4, 6, 8, 32, 40])
def test_alibi_slopes_match_jax(n):
    np.testing.assert_array_equal(tattn.alibi_slopes(n).numpy(),
                                  np.asarray(jattn.alibi_slopes(n)))


def q8_or_f32(kv8):
    """(JAX spec, port spec, cache, JAX scale rows, port scale rows)."""
    if not kv8:
        js, ts = ta.specs()
        return js, ts, ta.random_cache(ts, 40), None, None
    js, ts = ta.q8_specs(ta.KVH)
    return (js, ts) + ta.q8_cache(js, ts, 41)


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "int8_kv"])
def test_alibi_decode_matches_jax(kv8):
    js, ts, cache, j_scale, t_scale = q8_or_f32(kv8)
    pt = ta.page_table([p for p, _ in ta.DECODE_ROWS], 4)
    ctx = np.array([c for _, c in ta.DECODE_ROWS], np.int32)
    rng = np.random.default_rng(42)
    b = len(ta.DECODE_ROWS)
    q = rng.standard_normal((b, ta.HQ, ta.HD)).astype(np.float32)
    fk = rng.standard_normal((b, ta.KVH, ta.HD)).astype(np.float32)
    fv = rng.standard_normal((b, ta.KVH, ta.HD)).astype(np.float32)
    slopes = jattn.alibi_slopes(ta.HQ)

    jargs = (jnp.asarray(q), jnp.asarray(cache), j_scale, jnp.asarray(pt),
             jnp.asarray(ctx), js)
    jkw = dict(layer=1, fresh_k=jnp.asarray(fk), fresh_v=jnp.asarray(fv),
               alibi=slopes)
    j_ref = np.asarray(jattn.decode_attention_ref(*jargs, **jkw))
    j_kern = np.asarray(jpk.paged_decode_attention(
        *jargs, seq_block=1, interpret=True, **jkw))

    targs = (torch.from_numpy(q), torch.from_numpy(cache), t_scale,
             torch.from_numpy(pt), torch.from_numpy(ctx), ts)
    tkw = dict(layer=1, fresh_k=torch.from_numpy(fk),
               fresh_v=torch.from_numpy(fv),
               alibi=tattn.alibi_slopes(ta.HQ))
    t_ref = tattn.decode_attention_ref(*targs, **tkw).numpy()
    t_wrap = tpk.paged_decode_attention(*targs, **tkw).numpy()

    live = ctx > 0
    np.testing.assert_allclose(t_ref, j_ref, **ALIBI_TOL)
    np.testing.assert_allclose(t_wrap[live], j_kern[live], **ALIBI_TOL)
    np.testing.assert_array_equal(t_wrap[~live], 0.0)
    # the bias moved the output: a lost slope would not pass
    plain = tattn.decode_attention_ref(*targs, **dict(tkw, alibi=None))
    assert np.abs(plain.numpy()[live] - t_ref[live]).max() > 1e-2


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "int8_kv"])
def test_alibi_prefill_matches_jax(kv8):
    """Rows at start 0, at start 2 pages (a prefix hit), the full-hit
    replay row and a padding row."""
    layer = 1
    js, ts, cache, j_scale, t_scale = q8_or_f32(kv8)
    pt = ta.page_table([p for p, _, _ in ta.PREFILL_ROWS], 5)
    start = np.array([s for _, s, _ in ta.PREFILL_ROWS], np.int32)
    new_len = np.array([n for _, _, n in ta.PREFILL_ROWS], np.int32)
    rng = np.random.default_rng(43)
    bp = len(ta.PREFILL_ROWS)
    q = rng.standard_normal((bp, ta.QP, ta.HQ, ta.HD)).astype(np.float32)
    fk = rng.standard_normal((bp, ta.QP, ta.KVH, ta.HD)).astype(np.float32)
    fv = rng.standard_normal((bp, ta.QP, ta.KVH, ta.HD)).astype(np.float32)
    j_fscale = t_fscale = None
    if kv8:
        # this step's K/V as the step quantizes it; the references take
        # it dequantized, as the JAX step does
        qk, sk = jkv.quantize_kv(jnp.asarray(fk), 8)
        qv, sv = jkv.quantize_kv(jnp.asarray(fv), 8)
        fslab = np.asarray(jkv.pack_kv_rows(qk, qv, js))
        j_fscale = jkv._pack_scale_rows(sk, sv, js)
        t_fscale = ta.port_scale_rows(j_fscale, ts)
        fk = np.array(jkv.dequantize_kv(qk, sk, 8, jnp.float32))
        fv = np.array(jkv.dequantize_kv(qv, sv, 8, jnp.float32))
    else:
        fslab = np.concatenate([fk, fv], axis=-1)
    fslab = np.ascontiguousarray(fslab.transpose(0, 2, 1, 3))
    # the replay row's position is already in the cache (a full hit)
    r, s = 2, ta.PREFILL_ROWS[2][1]
    slot = layer * ts.num_slots + pt[r, s // ta.PS] * ta.PS + s % ta.PS
    cache[:, slot] = fslab[r, :, 0]
    if kv8:
        j_scale = j_scale.at[slot].set(j_fscale[r, 0])
        t_scale[slot] = t_fscale[r, 0]
    slopes = jattn.alibi_slopes(ta.HQ)

    jargs = (jnp.asarray(q), jnp.asarray(cache), j_scale, jnp.asarray(pt),
             jnp.asarray(start), jnp.asarray(new_len), js)
    j_ref = np.asarray(jattn.prefill_attention_ref(
        *jargs, layer=layer, fresh_k=jnp.asarray(fk),
        fresh_v=jnp.asarray(fv), alibi=slopes))
    j_kern = np.asarray(jpk.paged_prefill_attention(
        *jargs, layer=layer, fresh_kv=jnp.asarray(fslab),
        fresh_scale=j_fscale, q_block=16, interpret=True, alibi=slopes))

    targs = (torch.from_numpy(q), torch.from_numpy(cache), t_scale,
             torch.from_numpy(pt), torch.from_numpy(start),
             torch.from_numpy(new_len), ts)
    t_slopes = tattn.alibi_slopes(ta.HQ)
    t_ref = tattn.prefill_attention_ref(
        *targs, layer=layer, fresh_k=torch.from_numpy(fk),
        fresh_v=torch.from_numpy(fv), alibi=t_slopes).numpy()
    t_wrap = tpk.paged_prefill_attention(
        *targs, layer=layer, fresh_kv=torch.from_numpy(fslab),
        fresh_scale=t_fscale, alibi=t_slopes).numpy()

    v = ta.valid_rows(new_len)
    np.testing.assert_allclose(t_ref, j_ref, **ALIBI_TOL)
    np.testing.assert_allclose(t_wrap[v], j_kern[v], **ALIBI_TOL)
    np.testing.assert_array_equal(t_wrap[~v], 0.0)


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "int8_kv"])
@pytest.mark.parametrize("tail_len", [1, tb.J - 1])
def test_alibi_tail_phase_matches_jax_kernel(tail_len, kv8):
    """K1's tail phase with ALiBi: the tail rows sit after the cached
    tokens, the self-term after the tail (tests/test_torch_block_tail.py's
    rows: cached pages, tail + self only, a padding row)."""
    js, ts = tb.specs(kv8)
    b, layer = len(tb.TAIL_ROWS), 1
    n = js.num_layers * js.num_slots
    rows, j_srows = tb.packed_rows(js, n, 50)
    cache = np.ascontiguousarray(rows.transpose(1, 0, 2))
    trows, j_tsrows = tb.packed_rows(js, js.num_layers * b * tb.J, 51)
    tail = np.ascontiguousarray(trows.reshape(
        js.num_layers, b, tb.J, tb.KVH, -1).transpose(0, 1, 3, 2, 4))
    pt = np.full((b, 4), tb.NPAGES, np.int32)
    for r, (pages, _) in enumerate(tb.TAIL_ROWS):
        pt[r, :len(pages)] = pages
    ctx = np.array([c for _, c in tb.TAIL_ROWS], np.int32)
    rng = np.random.default_rng(52)
    q = rng.standard_normal((b, tb.HQ, tb.HD)).astype(np.float32)
    fk = rng.standard_normal((b, tb.KVH, tb.HD)).astype(np.float32)
    fv = rng.standard_normal((b, tb.KVH, tb.HD)).astype(np.float32)
    tlen = np.array([tail_len], np.int32)

    j_tscale = (j_tsrows.reshape(js.num_layers, b, tb.J, -1) if kv8
                else None)
    j_out = np.asarray(jpk.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), j_srows, jnp.asarray(pt),
        jnp.asarray(ctx), js, layer=layer, fresh_k=jnp.asarray(fk),
        fresh_v=jnp.asarray(fv), seq_block=1, interpret=True,
        tail_kv=jnp.asarray(tail), tail_scale=j_tscale,
        tail_len=jnp.asarray(tlen), alibi=jattn.alibi_slopes(tb.HQ)))

    args = (torch.from_numpy(q), torch.from_numpy(cache),
            tb.port_scale_rows(j_srows, ts) if kv8 else None,
            torch.from_numpy(pt), torch.from_numpy(ctx), ts)
    kw = dict(layer=layer, fresh_k=torch.from_numpy(fk),
              fresh_v=torch.from_numpy(fv), tail_kv=torch.from_numpy(tail),
              tail_scale=tb.port_scale_rows(j_tscale, ts) if kv8 else None,
              tail_len=torch.from_numpy(tlen),
              alibi=tattn.alibi_slopes(tb.HQ))
    t_ref = tattn.decode_attention_ref(*args, **kw).numpy()
    t_wrap = tpk.paged_decode_attention(*args, **kw).numpy()
    np.testing.assert_allclose(t_ref, j_out, **ALIBI_TOL)
    np.testing.assert_allclose(t_wrap, j_out, **ALIBI_TOL)
    np.testing.assert_array_equal(t_ref[ctx == 0], 0.0)


# ------------------------------------------------------------ the step


def run_steps(family, quant_method):
    """One mixed step (tests/test_torch_step.py's plan: decode rows, a
    fresh prompt, a prefix-hit continuation) of ``family`` on the JAX
    step (XLA attention) and the port's, from the JAX weights."""
    jcfg, tcfg = ts_.configs()
    jcfg = dataclasses.replace(jcfg, **FAMILIES[family])
    tcfg = dataclasses.replace(tcfg, **FAMILIES[family])
    js, tspec = ts_.specs(jcfg)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(6),
                                 dtype=jnp.float32)
    if quant_method != "none":
        jparams = jllama.quantize_model_params(jparams, quant_method)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu", torch.float32)
    f, live = ts_.plan(jcfg, jcfg.page_size)
    cache0, _, _ = ts_.initial_cache(js, tspec)
    jstep = jllama.make_step_fn(jcfg, js, return_logits=True,
                                quant_method=quant_method, attn_impl="xla",
                                quant_impl="xla", greedy_only=True)
    jout = jstep(jparams, jnp.asarray(cache0), jnp.zeros((1,), jnp.float32),
                 jnp.zeros((1, 1), jnp.int32), ts_.to_input(f, "jax"),
                 jax.random.PRNGKey(0))
    tstep = tllama.make_step_fn(tcfg, tspec, return_logits=True,
                                quant_method=quant_method, greedy_only=True)
    tout = tstep(tparams, torch.from_numpy(cache0.copy()), None,
                 torch.zeros((1, 1), dtype=torch.int32),
                 ts_.to_input(f, "torch"))
    return jout, tout, live, jparams, tparams


@pytest.mark.parametrize("quant_method,logit_tol", [
    ("none", 1e-4), ("online_i8i8", 2e-3)])
@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_step_matches_jax(family, quant_method, logit_tol):
    jout, tout, live, jparams, tparams = run_steps(family, quant_method)
    np.testing.assert_allclose(tout.logits.numpy()[live],
                               np.asarray(jout.logits)[live],
                               atol=logit_tol, rtol=logit_tol)
    np.testing.assert_array_equal(tout.tokens.numpy()[live],
                                  np.asarray(jout.tokens)[live])
    if family == "attn_bias":
        # the biases crossed over unchanged, through quantization too
        for jl, tl in zip(jparams["layers"], tparams["layers"]):
            for key in ("bqkv", "bo"):
                np.testing.assert_array_equal(tl[key].numpy(),
                                              np.asarray(jl[key]))


def test_init_params_follow_jax_with_biases():
    kw = FAMILIES["attn_bias"]
    jcfg, tcfg = ts_.configs()
    jp = jllama.init_params(dataclasses.replace(jcfg, **kw),
                            jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = tllama.init_params(dataclasses.replace(tcfg, **kw),
                            torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == {
            k: tuple(v.shape) for k, v in jl.items()}
        # the JAX scale: N(0, 0.02^2)
        assert 0.01 < float(tl["bqkv"].std()) < 0.03
    q = tllama.quantize_model_params(tp, "online_i8i8")
    assert q["layers"][0]["bqkv"] is tp["layers"][0]["bqkv"]
    assert q["layers"][0]["bo"] is tp["layers"][0]["bo"]


# ------------------------------------------------------- the generator


@pytest.fixture(scope="module")
def jax_generators():
    """One JAX generator per family (8-step blocks, XLA attention; the
    JAX package holds its tokens equal at every block size and in
    block-tail mode)."""
    gens = {}

    def get(family):
        if family not in gens:
            cfg = JModelConfig(**MODEL, **FAMILIES[family])
            gen_cfg = JGeneratorConfig(**GEN)
            engine, kv_max = j_create_engine(
                cfg, JResourceConfig(multi_step=8, **RESOURCE), gen_cfg)
            conn = JConnection()
            gens[family] = (JGenerator(cfg, gen_cfg, engine,
                                       ByteTokenizer(), conn, kv_max),
                            conn, engine, kv_max)
        return gens[family]

    yield get
    for gen, *_ in gens.values():
        gen.shutdown()


def reqs(prompts, gen_len):
    return [dict(tokens=ByteTokenizer().encode(p), gen_len=gen_len)
            for p in prompts]


@pytest.mark.parametrize("family", list(FAMILIES))
def test_family_generator_matches_jax(jax_generators, family):
    specs = reqs([f"{family} family {i}" for i in range(3)], 20)
    jgen, jconn, jengine, kv_max = jax_generators(family)
    want = serve(jgen, jconn, JRequest, specs)[0]
    cfg = ModelConfig(**MODEL, **FAMILIES[family])
    params = tllama.params_from_jax(
        jax.tree.map(np.asarray, jengine._params), "cpu", torch.float32)
    spec = CacheSpec(num_layers=cfg.num_layers,
                     num_pages=kv_max // cfg.page_size,
                     page_size=cfg.page_size, num_kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.head_dim, dtype=torch.float32)
    for multi_step, block_tail in ((1, "auto"), (8, "auto"), (8, "on")):
        rcfg = ResourceConfig(device="cpu", multi_step=multi_step,
                              block_tail=block_tail, **RESOURCE)
        gen_cfg = GeneratorConfig(**GEN)
        engine = LLMEngine(cfg, rcfg, params, spec, device="cpu")
        gen = LLMGenerator(cfg, gen_cfg, engine, ByteTokenizer(),
                           LocalConnection(), kv_max)
        try:
            got = serve(gen, gen.conn, Request, specs)[0]
        finally:
            gen.shutdown()
        assert got == want, (multi_step, block_tail)
        assert all(len(t) == 20 for t in got)
