"""Block-tail mode of the port vs the JAX package on the CPU.

- K1's tail phase: the port's plain version (``decode_attention_ref`` with
  ``tail_kv``) and the K1 wrapper's CPU path against the JAX package's
  Pallas ``paged_decode_attention`` in interpret mode, on the same numpy
  inputs: ``tail_len`` 0, 1 and J-1, rows with cached pages, a row whose
  whole context is tail + self-term, a padding row (ctx 0); f32 atol/rtol
  2e-5 and, with int8 KV, atol 1e-3 / rtol 1e-2 (tests/test_pallas_
  attention.py's tolerances; the JAX kernel dequantizes int8 in its
  compute dtype through a one-hot matmul).
- ``make_multi_step_fn`` called directly on one decode-only StepInput, in
  both modes (per-step writes against the JAX block with XLA attention;
  block-tail against the JAX block with interpret-mode Pallas attention):
  greedy tokens [N, B] equal on the live rows; with int8 KV and w4a8
  weights every cache and scale byte outside the trash page equal, with
  float weights and cache the written rows within 1e-5.
- The generator end to end with ``block_tail="on"`` against the JAX
  generator with interpret-mode Pallas attention and ``block_tail="on"``
  (as tests/test_multi_step.py builds it): greedy tokens equal.
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
from ppl.llm.serving_tpu.ops.pallas import paged_attention as jpk
from ppl.llm.serving_tpu_torch.config import ModelConfig
from ppl.llm.serving_tpu_torch.models import llama as tllama
from ppl.llm.serving_tpu_torch.ops import attention as tattn
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv
from ppl.llm.serving_tpu_torch.ops import sampling as tsamp
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as tpk

from test_torch_multi_step import MODEL, POOL, reqs, run_both

TOL = dict(atol=2e-5, rtol=2e-5)
Q8_TOL = dict(atol=1e-3, rtol=1e-2)
PS, HD, HQ, KVH, NPAGES, J = 16, 32, 4, 2, 24, 8


def specs(kv8, head_dim=HD):
    kw = dict(num_layers=2, num_pages=NPAGES, page_size=PS,
              num_kv_heads=KVH, head_dim=head_dim)
    if kv8:
        kw.update(quant_bit=8, quant_group=8)
    return (jkv.CacheSpec(dtype=jnp.float32, **kw),
            tkv.CacheSpec(dtype=torch.float32, **kw))


def port_scale_rows(j_rows, ts):
    """The JAX package's 128-lane scale rows -> the port's (the used
    lanes, zero-padded to scale_lanes)."""
    used = ts.num_kv_heads * ts.scale_lane_stride
    j_rows = np.asarray(jnp.asarray(j_rows).astype(jnp.float32))
    out = np.zeros(j_rows.shape[:-1] + (ts.scale_lanes,), np.float32)
    out[..., :used] = j_rows[..., :used]
    return torch.from_numpy(out).to(torch.bfloat16)


def packed_rows(js, n, seed):
    """n random K/V rows packed as the cache packs them (int8 with JAX's
    scale rows under int8 KV): (rows [n, KVH, 2*hd], scale rows | None)."""
    rng = np.random.default_rng(seed)
    k = rng.standard_normal((n, KVH, js.head_dim)).astype(np.float32)
    v = rng.standard_normal((n, KVH, js.head_dim)).astype(np.float32)
    if not js.quantized:
        return np.asarray(jkv.pack_kv_rows(jnp.asarray(k), jnp.asarray(v),
                                           js)), None
    qk, sk = jkv.quantize_kv(jnp.asarray(k), 8)
    qv, sv = jkv.quantize_kv(jnp.asarray(v), 8)
    return (np.asarray(jkv.pack_kv_rows(qk, qv, js)),
            jkv._pack_scale_rows(sk, sv, js))


# (pages, ctx incl. the current token): cached pages, tail + self only
# (ctx 2), a padding row, a row longer than a page
TAIL_ROWS = [([3, 5, 7], 40), ([1], 2), ([NPAGES], 0), ([0, 2], 20),
             ([9, 10, 11], 48)]


@pytest.mark.parametrize("kv8", [False, True], ids=["f32", "int8_kv"])
@pytest.mark.parametrize("tail_len", [0, 1, J - 1])
def test_tail_phase_matches_jax_kernel(tail_len, kv8):
    js, ts = specs(kv8)
    b, layer = len(TAIL_ROWS), 1
    n = js.num_layers * js.num_slots
    rows, j_srows = packed_rows(js, n, 20)
    cache = np.ascontiguousarray(rows.transpose(1, 0, 2))
    trows, j_tsrows = packed_rows(js, js.num_layers * b * J, 21)
    tail = np.ascontiguousarray(trows.reshape(
        js.num_layers, b, J, KVH, -1).transpose(0, 1, 3, 2, 4))
    pt = np.full((b, 4), NPAGES, np.int32)
    for r, (pages, _) in enumerate(TAIL_ROWS):
        pt[r, :len(pages)] = pages
    ctx = np.array([c for _, c in TAIL_ROWS], np.int32)
    rng = np.random.default_rng(22)
    q = rng.standard_normal((b, HQ, HD)).astype(np.float32)
    fk = rng.standard_normal((b, KVH, HD)).astype(np.float32)
    fv = rng.standard_normal((b, KVH, HD)).astype(np.float32)
    tlen = np.array([tail_len], np.int32)

    j_tscale = (j_tsrows.reshape(js.num_layers, b, J, -1) if kv8 else None)
    j_out = np.asarray(jpk.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), j_srows, jnp.asarray(pt),
        jnp.asarray(ctx), js, layer=layer, fresh_k=jnp.asarray(fk),
        fresh_v=jnp.asarray(fv), seq_block=1, interpret=True,
        tail_kv=jnp.asarray(tail), tail_scale=j_tscale,
        tail_len=jnp.asarray(tlen)))

    t_scale = port_scale_rows(j_srows, ts) if kv8 else None
    t_tscale = port_scale_rows(j_tscale, ts) if kv8 else None
    args = (torch.from_numpy(q), torch.from_numpy(cache), t_scale,
            torch.from_numpy(pt), torch.from_numpy(ctx), ts)
    kw = dict(layer=layer, fresh_k=torch.from_numpy(fk),
              fresh_v=torch.from_numpy(fv), tail_kv=torch.from_numpy(tail),
              tail_scale=t_tscale, tail_len=torch.from_numpy(tlen))
    t_ref = tattn.decode_attention_ref(*args, **kw).numpy()
    t_wrap = tpk.paged_decode_attention(*args, **kw).numpy()

    tol = Q8_TOL if kv8 else TOL
    np.testing.assert_allclose(t_ref, j_out, **tol)
    np.testing.assert_allclose(t_wrap, j_out, **tol)
    np.testing.assert_array_equal(t_ref[ctx == 0], 0.0)
    if tail_len == 0:
        # an empty tail is the plain deferred mode
        plain = tattn.decode_attention_ref(
            *args, layer=layer, fresh_k=kw["fresh_k"],
            fresh_v=kw["fresh_v"]).numpy()
        live = ctx > 0
        np.testing.assert_allclose(t_ref[live], plain[live], **TOL)


# -------------------------------------------------- make_multi_step_fn


def block_input(lib, rows, n_pages_row, vocab, seed):
    """One decode-only plan: ``rows`` = ctx per row (0 = padding)."""
    rng = np.random.default_rng(seed)
    bd = len(rows)
    ctx = np.array(rows, np.int32)
    pt = np.full((bd, 4), NPAGES, np.int32)
    nxt = 0
    for r, c in enumerate(ctx):
        if c:
            pt[r, :n_pages_row] = np.arange(nxt, nxt + n_pages_row)
            nxt += n_pages_row
    f = dict(decode_tokens=rng.integers(3, vocab, bd).astype(np.int32),
             decode_pos=np.maximum(ctx - 1, 0).astype(np.int32),
             prefill_tokens=np.zeros((0, 1), np.int32),
             prefill_start=np.zeros(0, np.int32),
             prefill_len=np.zeros(0, np.int32), page_table=pt,
             context_len=ctx, batch_slots=np.zeros(bd, np.int32),
             temperature=np.ones(bd, np.float32),
             top_k=np.ones(bd, np.int32), top_p=np.zeros(bd, np.float32),
             do_sample=np.zeros(bd, bool), rep_pen=np.ones(bd, np.float32),
             pres_pen=np.zeros(bd, np.float32),
             freq_pen=np.zeros(bd, np.float32))
    sp = ("temperature", "top_k", "top_p", "do_sample", "rep_pen",
          "pres_pen", "freq_pen")
    head = ("decode_tokens", "decode_pos", "prefill_tokens", "prefill_start",
            "prefill_len", "page_table", "context_len", "batch_slots")
    if lib == "jax":
        a = jnp.asarray
        return jllama.StepInput(*[a(f[k]) for k in head],
                                jsamp.SamplingParams(*[a(f[k]) for k in sp]))
    a = torch.from_numpy
    return tllama.StepInput(*[a(f[k]) for k in head],
                            tsamp.SamplingParams(*[a(f[k]) for k in sp]))


@pytest.mark.parametrize("block_tail", ["auto", "on"])
@pytest.mark.parametrize("quant", ["none", "online_w4a8-int8_kv"])
def test_multi_step_fn_matches_jax(block_tail, quant):
    """A 4-step block on 6 rows (two padding, one crossing a page
    mid-block) from the same weights and cache contents."""
    quant_method, kv8 = {"none": ("none", False),
                         "online_w4a8-int8_kv": ("online_w4a8", True)}[quant]
    kv = dict(cache_quant_bit=8, cache_quant_group=8) if kv8 else {}
    jcfg, tcfg = JModelConfig(**MODEL, **kv), ModelConfig(**MODEL, **kv)
    js, ts = specs(kv8, tcfg.head_dim)
    n_steps = 4
    jparams = jllama.init_params(jcfg, jax.random.PRNGKey(3),
                                 dtype=jnp.float32)
    if quant_method != "none":
        jparams = jllama.quantize_model_params(jparams, quant_method,
                                               quantize_lm_head=True)
    tparams = tllama.params_from_jax(jax.tree.map(np.asarray, jparams),
                                     "cpu", torch.float32)
    n = js.num_layers * js.num_slots
    rows, j_srows = packed_rows(js, n, 30)
    cache0 = np.ascontiguousarray(rows.transpose(1, 0, 2))
    ctx = [20, 0, 16, 5, 0, 40]                 # row 2 crosses a page
    jblock = jllama.make_multi_step_fn(
        jcfg, js, n_steps, block_tail=block_tail,
        attn_impl="pallas_interpret" if block_tail == "on" else "xla",
        quant_method=quant_method, quant_impl="xla", seq_block=2,
        greedy_only=True)
    j_toks, _, j_cache, j_scale, _ = jblock(
        jparams, jnp.asarray(cache0),
        j_srows if kv8 else jnp.zeros((1,), jnp.float32),
        jnp.zeros((1, 1), jnp.int32),
        block_input("jax", ctx, 4, jcfg.vocab_size, 31),
        jax.random.PRNGKey(0))
    tblock = tllama.make_multi_step_fn(
        tcfg, ts, n_steps, block_tail=block_tail, quant_method=quant_method,
        greedy_only=True)
    t_cache = torch.from_numpy(cache0.copy())
    t_scale = port_scale_rows(j_srows, ts) if kv8 else None
    t_toks, _ = tblock(tparams, t_cache, t_scale,
                       torch.zeros((1, 1), dtype=torch.int32),
                       block_input("torch", ctx, 4, tcfg.vocab_size, 31))

    live = np.array(ctx) > 0
    assert t_toks.shape == (n_steps, len(ctx))
    np.testing.assert_array_equal(t_toks.numpy()[:, live],
                                  np.asarray(j_toks)[:, live])
    keep = np.ones(n, bool)
    for layer in range(js.num_layers):
        lo = layer * js.num_slots + js.trash_page * PS
        keep[lo:lo + PS] = False
    jc, tc = np.asarray(j_cache)[:, keep], t_cache.numpy()[:, keep]
    written = np.any(jc != cache0[:, keep], axis=(0, 2))
    # every live row wrote n_steps tokens in each layer
    assert written.sum() == js.num_layers * n_steps * live.sum()
    if kv8:
        assert tc.tobytes() == jc.tobytes()
        used = ts.num_kv_heads * ts.scale_lane_stride
        js_f = np.asarray(j_scale.astype(jnp.float32))[keep, :used]
        np.testing.assert_array_equal(t_scale.float().numpy()[keep, :used],
                                      js_f)
    else:
        np.testing.assert_allclose(tc[:, written], jc[:, written],
                                   atol=1e-5, rtol=1e-5)
        assert tc[:, ~written].tobytes() == jc[:, ~written].tobytes()


def test_block_tail_off_knob_matches_on():
    """block_tail "off" and "auto" are the per-step mode; "on" gives the
    same block tokens on the port."""
    jcfg, tcfg = JModelConfig(**MODEL), ModelConfig(**MODEL)
    js, ts = specs(False, tcfg.head_dim)
    params = tllama.params_from_jax(jax.tree.map(
        np.asarray, jllama.init_params(jcfg, jax.random.PRNGKey(4),
                                       dtype=jnp.float32)), "cpu")
    cache0 = torch.from_numpy(np.ascontiguousarray(
        packed_rows(js, ts.num_layers * ts.num_slots,
                    32)[0].transpose(1, 0, 2)))
    out = {}
    for mode in ("auto", "off", "on"):
        block = tllama.make_multi_step_fn(tcfg, ts, 5, block_tail=mode,
                                          greedy_only=True)
        out[mode] = block(params, cache0.clone(), None,
                          torch.zeros((1, 1), dtype=torch.int32),
                          block_input("torch", [30, 7, 0, 17], 4,
                                      tcfg.vocab_size, 33))[0]
    live = [0, 1, 3]
    assert torch.equal(out["auto"], out["off"])
    assert torch.equal(out["on"][:, live], out["auto"][:, live])
    with pytest.raises(ValueError, match="block_tail"):
        tllama.make_multi_step_fn(tcfg, ts, 5, block_tail="yes")


# ----------------------------------------------------- generator, tail on


@pytest.fixture(scope="module", autouse=True)
def _jax_generators():
    yield
    POOL.close()



@pytest.mark.parametrize("quant", ["none", "none-int8_kv"])
def test_generator_block_tail_matches_jax(quant):
    """The generator with block_tail="on" (4-step blocks) against the JAX
    generator with interpret-mode Pallas attention and block-tail on."""
    want, got = run_both(
        reqs([f"tail equivalence {i}" for i in range(2)], 12), 4, quant,
        resource_kw=dict(block_tail="on"),
        jax_resource_kw=dict(attention_impl="pallas_interpret",
                             attention_seq_block=2))
    assert got[0] == want[0]
    assert all(len(t) == 12 for t in got[0])
