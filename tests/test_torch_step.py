"""One mixed decode+prefill step of the port vs the JAX package's
``make_step_fn(attn_impl="xla")`` on the same weights (converted with
``params_from_jax``), the same cache contents and the same plan, at the
tests/data/params_tiny.json widths in f32.

Tolerances (f32):
- quant_method none: logits atol/rtol 1e-4 (matmul and softmax sums run
  in another order), greedy tokens exact; cache rows this step wrote to
  1e-5, every other row byte-identical.
- online_i8i8: identical int8 weights; logits atol 2e-3 (a summation-order
  difference upstream may flip one activation's int8 rounding, which moves
  a logit by about one quantization step), cache rows 1e-3, greedy tokens
  exact on this seed.
- int8 KV (with none, online_i8i8 and online_w4a8 weights, the w4a8
  weights identical packed int4): the written rows are compared
  dequantized (int8 x bf16 scale) within one int8 step of the largest
  scale, the scale rows' used lanes within 2e-2 relative: with i8i8
  weights a flipped upstream activation rounding moves a k/v element by
  about 1 %, and with it its group's absmax (seen: 1.2 %, and 0 with
  float or w4a8 weights, which match bit for bit on this seed); logits
  atol 2e-3 for quantized weights and 1e-3 for float ones (a flipped k/v
  rounding moves a score by about one step), greedy tokens exact on this
  seed; untouched rows and their scales byte-identical.
Padding rows (decode rows with ctx 0, the trash page) are excluded: the
port's decode kernel contract writes zeros there, the XLA reference a
self-term.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.models import llama as jllama
from ppl.llm.serving_tpu.ops import kv_cache as jkv
from ppl.llm.serving_tpu.ops import sampling as jsamp
from ppl.llm.serving_tpu_torch.config import ModelConfig
from ppl.llm.serving_tpu_torch.models import llama as tllama
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv
from ppl.llm.serving_tpu_torch.ops import sampling as tsamp

PARAMS_JSON = "tests/data/params_tiny.json"
NPAGES = 16


def configs():
    return (JModelConfig.from_params_json(PARAMS_JSON),
            ModelConfig.from_params_json(PARAMS_JSON))


def specs(cfg, kv8=False):
    kw = dict(num_layers=cfg.num_layers, num_pages=NPAGES,
              page_size=cfg.page_size, num_kv_heads=cfg.num_kv_heads,
              head_dim=cfg.head_dim)
    if kv8:
        kw.update(quant_bit=8, quant_group=8)
    return (jkv.CacheSpec(dtype=jnp.float32, **kw),
            tkv.CacheSpec(dtype=torch.float32, **kw))


def plan(cfg, ps):
    """4 decode rows (the last one padding), 2 prefill rows: a fresh
    prompt and a prefix-hit continuation at start = one page."""
    rng = np.random.default_rng(11)
    v = cfg.vocab_size
    bd, bp, qp, kvp = 4, 2, 32, 4
    b = bd + bp
    pt = np.full((b, kvp), NPAGES, np.int32)
    pt[0, :2] = [0, 1]
    pt[1, :1] = [2]
    pt[2, :3] = [3, 4, 5]
    pt[4, :2] = [6, 7]
    pt[5, :3] = [8, 9, 10]
    ctx = np.array([20, 5, 40, 0, 25, ps + 30], np.int32)
    dec_pos = np.array([19, 4, 39, 0], np.int32)
    pre_start = np.array([0, ps], np.int32)
    pre_len = np.array([25, 30], np.int32)
    f = dict(
        decode_tokens=rng.integers(0, v, bd).astype(np.int32),
        decode_pos=dec_pos,
        prefill_tokens=rng.integers(0, v, (bp, qp)).astype(np.int32),
        prefill_start=pre_start, prefill_len=pre_len, page_table=pt,
        context_len=ctx, batch_slots=np.zeros(b, np.int32),
        temperature=np.ones(b, np.float32), top_k=np.ones(b, np.int32),
        top_p=np.zeros(b, np.float32), do_sample=np.zeros(b, bool),
        rep_pen=np.ones(b, np.float32), pres_pen=np.zeros(b, np.float32),
        freq_pen=np.zeros(b, np.float32))
    live = np.array([True, True, True, False, True, True])
    return f, live


def to_input(f, lib):
    if lib == "jax":
        a = jnp.asarray
        return jllama.StepInput(
            a(f["decode_tokens"]), a(f["decode_pos"]),
            a(f["prefill_tokens"]), a(f["prefill_start"]),
            a(f["prefill_len"]), a(f["page_table"]), a(f["context_len"]),
            a(f["batch_slots"]),
            jsamp.SamplingParams(a(f["temperature"]), a(f["top_k"]),
                                 a(f["top_p"]), a(f["do_sample"]),
                                 a(f["rep_pen"]), a(f["pres_pen"]),
                                 a(f["freq_pen"])))
    a = torch.from_numpy
    return tllama.StepInput(
        a(f["decode_tokens"]), a(f["decode_pos"]), a(f["prefill_tokens"]),
        a(f["prefill_start"]), a(f["prefill_len"]), a(f["page_table"]),
        a(f["context_len"]), a(f["batch_slots"]),
        tsamp.SamplingParams(a(f["temperature"]), a(f["top_k"]),
                             a(f["top_p"]), a(f["do_sample"]),
                             a(f["rep_pen"]), a(f["pres_pen"]),
                             a(f["freq_pen"])))


def initial_cache(js, ts):
    """Random cache contents (and, under int8 KV, random positive scale
    rows: the JAX package's 128-lane rows and the port's, equal on the
    used lanes)."""
    rng = np.random.default_rng(5)
    shape = (js.num_kv_heads, js.num_layers * js.num_slots, js.row_lanes)
    if not js.quantized:
        return rng.standard_normal(shape).astype(np.float32), None, None
    cache0 = rng.integers(-127, 128, shape).astype(np.int8)
    used = js.num_kv_heads * js.scale_lane_stride
    s = np.zeros((shape[1], js.scale_lanes), np.float32)
    s[:, :used] = rng.uniform(0.005, 0.03, (shape[1], used))
    j_scale = jnp.asarray(s).astype(jnp.bfloat16)
    t_scale = torch.from_numpy(s[:, :ts.scale_lanes].copy()).to(
        torch.bfloat16)
    return cache0, j_scale, t_scale


def run_both(quant_method, kv8=False):
    jcfg, tcfg = configs()
    js, ts = specs(jcfg, kv8)
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(0),
                                 dtype=jnp.float32)
    if quant_method != "none":
        jparams = jllama.quantize_model_params(jparams, quant_method)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu", torch.float32)
    f, live = plan(jcfg, jcfg.page_size)
    cache0, j_scale, t_scale = initial_cache(js, ts)

    jstep = jllama.make_step_fn(jcfg, js, return_logits=True,
                                quant_method=quant_method, attn_impl="xla",
                                quant_impl="xla", greedy_only=True)
    jout = jstep(jparams, jnp.asarray(cache0),
                 j_scale if kv8 else jnp.zeros((1,), jnp.float32),
                 jnp.zeros((1, 1), jnp.int32), to_input(f, "jax"),
                 jax.random.PRNGKey(0))
    tstep = tllama.make_step_fn(tcfg, ts, return_logits=True,
                                quant_method=quant_method, greedy_only=True)
    tcache = torch.from_numpy(cache0.copy())
    tout = tstep(tparams, tcache, t_scale,
                 torch.zeros((1, 1), dtype=torch.int32), to_input(f, "torch"))
    return (jout, tout, np.asarray(jout.kv_cache), tcache.numpy(), cache0,
            live, js, t_scale)


def written_rows(cache_after_j, cache0, js):
    changed = np.any(cache_after_j != cache0, axis=(0, 2))
    trash = np.zeros_like(changed)
    for layer in range(js.num_layers):
        lo = layer * js.num_slots + js.trash_page * js.page_size
        trash[lo:lo + js.page_size] = True
    return changed & ~trash, trash


@pytest.mark.parametrize("quant_method,logit_tol,cache_tol", [
    ("none", 1e-4, 1e-5), ("online_i8i8", 2e-3, 1e-3)])
def test_mixed_step_matches_jax(quant_method, logit_tol, cache_tol):
    jout, tout, jc, tc, cache0, live, js, _ = run_both(quant_method)
    np.testing.assert_allclose(tout.logits.numpy()[live],
                               np.asarray(jout.logits)[live],
                               atol=logit_tol, rtol=logit_tol)
    np.testing.assert_array_equal(tout.tokens.numpy()[live],
                                  np.asarray(jout.tokens)[live])
    np.testing.assert_allclose(tout.logprobs.numpy()[live],
                               np.asarray(jout.logprobs)[live],
                               atol=logit_tol, rtol=logit_tol)
    wrote, trash = written_rows(jc, cache0, js)
    assert wrote.sum() == 2 * (3 + 25 + 30)   # layers x live tokens
    np.testing.assert_allclose(tc[:, wrote], jc[:, wrote], atol=cache_tol,
                               rtol=cache_tol)
    untouched = ~wrote & ~trash
    assert tc[:, untouched].tobytes() == cache0[:, untouched].tobytes()


def dequantized_rows(cache, scale_bf16_f32, js):
    """int8 rows [KVH, N, 2*hd] x their scale rows [N, lanes] (as f32)
    -> f32 [KVH, N, 2*hd]."""
    kvh, n, lanes = cache.shape
    g = js.scale_groups
    s = scale_bf16_f32[:, :kvh * 2 * g].reshape(n, kvh, 2 * g)
    s = np.repeat(s.transpose(1, 0, 2), js.quant_group, axis=-1)
    return cache.astype(np.float32) * s


@pytest.mark.parametrize("quant_method,logit_tol", [
    ("online_w4a8", 2e-3), ("online_i8i8", 2e-3), ("none", 1e-3)])
def test_mixed_step_int8_kv_matches_jax(quant_method, logit_tol):
    jout, tout, jc, tc, cache0, live, js, t_scale = run_both(
        quant_method, kv8=True)
    np.testing.assert_allclose(tout.logits.numpy()[live],
                               np.asarray(jout.logits)[live],
                               atol=logit_tol, rtol=logit_tol)
    np.testing.assert_array_equal(tout.tokens.numpy()[live],
                                  np.asarray(jout.tokens)[live])
    wrote, trash = written_rows(jc, cache0, js)
    assert wrote.sum() == 2 * (3 + 25 + 30)   # layers x live tokens
    used = js.num_kv_heads * js.scale_lane_stride
    js_f = np.asarray(jout.kv_scale.astype(jnp.float32))[:, :used]
    ts_f = t_scale.float().numpy()[:, :used]
    np.testing.assert_allclose(ts_f[wrote], js_f[wrote], rtol=2e-2, atol=0)
    step = float(js_f[wrote].max())
    np.testing.assert_allclose(dequantized_rows(tc, ts_f, js)[:, wrote],
                               dequantized_rows(jc, js_f, js)[:, wrote],
                               atol=step, rtol=0)
    untouched = ~wrote & ~trash
    assert tc[:, untouched].tobytes() == cache0[:, untouched].tobytes()
    _, s0, _ = initial_cache(js, js)
    s0 = np.asarray(s0.astype(jnp.float32))[:, :used]
    np.testing.assert_array_equal(ts_f[untouched], s0[untouched])


def test_port_quantization_matches_jax_params():
    check_quantization_matches_jax("online_i8i8")


def test_port_w4a8_quantization_matches_jax_params():
    """Packed int4 bytes and group scales, gate|up C-leading for both,
    int4 lm_head: identical to the JAX package's."""
    check_quantization_matches_jax("online_w4a8")


def check_quantization_matches_jax(method):
    jcfg, tcfg = configs()
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(1),
                                 dtype=jnp.float32)
    jq = jax.tree.map(np.asarray, jllama.quantize_model_params(
        jparams, method, quantize_lm_head=True))
    tq = tllama.quantize_model_params(
        tllama.params_from_jax(jax.tree.map(np.asarray, jparams), "cpu"),
        method, quantize_lm_head=True)
    assert sorted(tq) == sorted(jq)
    for jl, tl in zip(jq["layers"], tq["layers"]):
        assert sorted(jl) == sorted(tl)
        for k in jl:
            np.testing.assert_array_equal(tl[k].numpy(), jl[k])
    np.testing.assert_array_equal(tq["lm_head_q"].numpy(), jq["lm_head_q"])
    np.testing.assert_array_equal(tq["lm_head_s"].numpy(), jq["lm_head_s"])


def test_init_params_shapes_follow_jax():
    jcfg, tcfg = configs()
    jp = jllama.init_params(jcfg, jax.random.PRNGKey(0), dtype=jnp.float32)
    tp = tllama.init_params(tcfg, torch.Generator().manual_seed(0),
                            dtype=torch.float32)
    for k in ("embedding", "final_norm", "lm_head"):
        assert tuple(tp[k].shape) == tuple(jp[k].shape)
    for jl, tl in zip(jp["layers"], tp["layers"]):
        assert {k: tuple(v.shape) for k, v in tl.items()} == {
            k: tuple(v.shape) for k, v in jl.items()}
