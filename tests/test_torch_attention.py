"""Port attention vs the JAX package: the plain PyTorch versions and the
K1/K2 wrappers' CPU path against the Pallas kernels in interpret mode and
against the XLA references, on the same numpy inputs.

Tolerance: f32 atol/rtol 2e-5, the JAX package's own kernel-vs-reference
tolerance (tests/test_pallas_attention.py); with int8 KV the plain
versions still hold 2e-5 against the XLA references (both dequantize
exactly in f32) and the wrappers hold atol 1e-3 / rtol 1e-2 against the
Pallas kernels, that file's int8 tolerance."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.ops import attention as jattn
from ppl.llm.serving_tpu.ops import kv_cache as jkv
from ppl.llm.serving_tpu.ops.pallas import paged_attention as jpk
from ppl.llm.serving_tpu_torch.ops import attention as tattn
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as tpk

TOL = dict(atol=2e-5, rtol=2e-5)
PS, HD, KVH, HQ, NPAGES = 16, 32, 2, 4, 24


def specs(num_layers=2):
    j = jkv.CacheSpec(num_layers=num_layers, num_pages=NPAGES, page_size=PS,
                      num_kv_heads=KVH, head_dim=HD, dtype=jnp.float32)
    t = tkv.CacheSpec(num_layers=num_layers, num_pages=NPAGES, page_size=PS,
                      num_kv_heads=KVH, head_dim=HD, dtype=torch.float32)
    return j, t


def random_cache(spec_t, seed):
    rng = np.random.default_rng(seed)
    return rng.standard_normal(
        (KVH, spec_t.num_layers * spec_t.num_slots, spec_t.row_lanes)
    ).astype(np.float32)


def page_table(rows, width):
    pt = np.full((len(rows), width), NPAGES, np.int32)
    for r, pages in enumerate(rows):
        pt[r, :len(pages)] = pages
    return pt


# rows: (pages, ctx incl. the current token); ctx 0 = padding row
DECODE_ROWS = [([3, 5, 7], 40), ([1], 1), ([0, 2], 17), ([NPAGES], 0),
               ([9, 10, 11], 48)]


@pytest.mark.parametrize("layer", [0, 1])
def test_decode_matches_jax(layer):
    js, ts = specs()
    cache = random_cache(ts, 0)
    pt = page_table([p for p, _ in DECODE_ROWS], 4)
    ctx = np.array([c for _, c in DECODE_ROWS], np.int32)
    rng = np.random.default_rng(1)
    b = len(DECODE_ROWS)
    q = rng.standard_normal((b, HQ, HD)).astype(np.float32)
    fk = rng.standard_normal((b, KVH, HD)).astype(np.float32)
    fv = rng.standard_normal((b, KVH, HD)).astype(np.float32)

    j_ref = np.asarray(jattn.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(cache), None, jnp.asarray(pt),
        jnp.asarray(ctx), js, layer=layer, fresh_k=jnp.asarray(fk),
        fresh_v=jnp.asarray(fv)))
    j_kern = np.asarray(jpk.paged_decode_attention(
        jnp.asarray(q), jnp.asarray(cache), None, jnp.asarray(pt),
        jnp.asarray(ctx), js, layer=layer, fresh_k=jnp.asarray(fk),
        fresh_v=jnp.asarray(fv), seq_block=1, interpret=True))

    args = (torch.from_numpy(q), torch.from_numpy(cache), None,
            torch.from_numpy(pt), torch.from_numpy(ctx), ts)
    kw = dict(layer=layer, fresh_k=torch.from_numpy(fk),
              fresh_v=torch.from_numpy(fv))
    t_ref = tattn.decode_attention_ref(*args, **kw).numpy()
    t_wrap = tpk.paged_decode_attention(*args, **kw).numpy()

    np.testing.assert_allclose(t_ref, j_ref, **TOL)
    np.testing.assert_allclose(t_wrap, j_kern, **TOL)
    # the kernel contract: ctx == 0 rows are zeros, others equal the ref
    live = ctx > 0
    np.testing.assert_array_equal(t_wrap[~live], 0.0)
    np.testing.assert_allclose(t_wrap[live], j_ref[live], **TOL)


def test_decode_without_self_term_matches_jax():
    js, ts = specs(1)
    cache = random_cache(ts, 2)
    rows = [([2, 4], 20), ([6], 5)]
    pt = page_table([p for p, _ in rows], 2)
    ctx = np.array([c for _, c in rows], np.int32)
    q = np.random.default_rng(3).standard_normal((2, HQ, HD)).astype(
        np.float32)
    j_ref = np.asarray(jattn.decode_attention_ref(
        jnp.asarray(q), jnp.asarray(cache), None, jnp.asarray(pt),
        jnp.asarray(ctx), js))
    t_ref = tattn.decode_attention_ref(
        torch.from_numpy(q), torch.from_numpy(cache), None,
        torch.from_numpy(pt), torch.from_numpy(ctx), ts).numpy()
    np.testing.assert_allclose(t_ref, j_ref, **TOL)


# (pages, start, new_len): start 0, start = 2 pages (prefix hit), the
# full-hit replay row (start = hit - 1, new_len = 1), a padding row
PREFILL_ROWS = [([0, 1, 2], 0, 30), ([3, 4, 5, 6], 2 * PS, 20),
                ([7, 8], 2 * PS - 1, 1), ([NPAGES], 0, 0)]
QP = 32


def prefill_inputs(seed):
    js, ts = specs()
    cache = random_cache(ts, seed)
    pt = page_table([p for p, _, _ in PREFILL_ROWS], 5)
    start = np.array([s for _, s, _ in PREFILL_ROWS], np.int32)
    new_len = np.array([n for _, _, n in PREFILL_ROWS], np.int32)
    rng = np.random.default_rng(seed + 1)
    bp = len(PREFILL_ROWS)
    q = rng.standard_normal((bp, QP, HQ, HD)).astype(np.float32)
    fk = rng.standard_normal((bp, QP, KVH, HD)).astype(np.float32)
    fv = rng.standard_normal((bp, QP, KVH, HD)).astype(np.float32)
    return js, ts, cache, pt, start, new_len, q, fk, fv


def valid_rows(new_len):
    return np.arange(QP)[None, :] < new_len[:, None]


@pytest.mark.parametrize("layer", [0, 1])
def test_prefill_matches_jax(layer):
    js, ts, cache, pt, start, new_len, q, fk, fv = prefill_inputs(4)
    # the replay row's position start is already in the cache (a full
    # hit): make the cached copy equal the fresh one, as a real step has
    r, s = 2, PREFILL_ROWS[2][1]
    slot = layer * ts.num_slots + pt[r, s // PS] * PS + s % PS
    cache[:, slot, :HD] = fk[r, 0]
    cache[:, slot, HD:] = fv[r, 0]

    jargs = (jnp.asarray(q), jnp.asarray(cache), None, jnp.asarray(pt),
             jnp.asarray(start), jnp.asarray(new_len), js)
    j_ref = np.asarray(jattn.prefill_attention_ref(
        *jargs, layer=layer, fresh_k=jnp.asarray(fk),
        fresh_v=jnp.asarray(fv)))
    fslab = np.concatenate([fk, fv], axis=-1).transpose(0, 2, 1, 3)
    j_kern = np.asarray(jpk.paged_prefill_attention(
        *jargs, layer=layer, fresh_kv=jnp.asarray(fslab), q_block=16,
        interpret=True))

    targs = (torch.from_numpy(q), torch.from_numpy(cache), None,
             torch.from_numpy(pt), torch.from_numpy(start),
             torch.from_numpy(new_len), ts)
    t_ref = tattn.prefill_attention_ref(
        *targs, layer=layer, fresh_k=torch.from_numpy(fk),
        fresh_v=torch.from_numpy(fv)).numpy()
    t_wrap = tpk.paged_prefill_attention(
        *targs, layer=layer,
        fresh_kv=torch.from_numpy(np.ascontiguousarray(fslab))).numpy()

    np.testing.assert_allclose(t_ref, j_ref, **TOL)
    np.testing.assert_allclose(t_wrap, j_ref, **TOL)
    # the Pallas kernel leaves padding query rows unspecified only in
    # its inactive blocks' neighbours; compare the rows it defines
    v = valid_rows(new_len)
    np.testing.assert_allclose(t_wrap[v], j_kern[v], **TOL)
    np.testing.assert_array_equal(t_wrap[~v], 0.0)


def test_prefill_cache_only_matches_jax():
    """No fresh inputs: this step's K/V already sits in the cache."""
    js, ts, cache, pt, start, new_len, q, _, _ = prefill_inputs(7)
    j_ref = np.asarray(jattn.prefill_attention_ref(
        jnp.asarray(q), jnp.asarray(cache), None, jnp.asarray(pt),
        jnp.asarray(start), jnp.asarray(new_len), js))
    t_ref = tattn.prefill_attention_ref(
        torch.from_numpy(q), torch.from_numpy(cache), None,
        torch.from_numpy(pt), torch.from_numpy(start),
        torch.from_numpy(new_len), ts).numpy()
    v = valid_rows(new_len)
    np.testing.assert_allclose(t_ref[v], j_ref[v], **TOL)


def test_wrappers_refuse_other_devices():
    _, ts = specs(1)
    meta = torch.empty((1, 4, 32), device="meta")
    with pytest.raises(ValueError):
        tpk.paged_decode_attention(
            meta, meta, None, meta, meta, ts, layer=0, fresh_k=meta,
            fresh_v=meta)


# ------------------------------------------------------------- int8 KV

Q8_TOL = dict(atol=1e-3, rtol=1e-2)


def q8_specs(kvh, num_layers=2):
    kw = dict(num_layers=num_layers, num_pages=NPAGES, page_size=PS,
              num_kv_heads=kvh, head_dim=HD, quant_bit=8, quant_group=8)
    return (jkv.CacheSpec(dtype=jnp.float32, **kw),
            tkv.CacheSpec(dtype=torch.float32, **kw))


def port_scale_rows(j_rows, ts):
    """The JAX package's 128-lane scale rows -> the port's (the used
    lanes, zero-padded to scale_lanes)."""
    used = ts.num_kv_heads * ts.scale_lane_stride
    out = np.zeros(np.asarray(j_rows).shape[:-1] + (ts.scale_lanes,),
                   np.float32)
    out[..., :used] = np.asarray(j_rows, np.float32)[..., :used]
    return torch.from_numpy(out).to(torch.bfloat16)


def q8_cache(js, ts, seed):
    """Random K/V quantized by the JAX package into a whole int8 cache
    and its scale rows (JAX's [L*S, 128] and the port's [L*S, 8k])."""
    rng = np.random.default_rng(seed)
    n = ts.num_layers * ts.num_slots
    k = rng.standard_normal((n, ts.num_kv_heads, HD)).astype(np.float32)
    v = rng.standard_normal((n, ts.num_kv_heads, HD)).astype(np.float32)
    qk, sk = jkv.quantize_kv(jnp.asarray(k), 8)
    qv, sv = jkv.quantize_kv(jnp.asarray(v), 8)
    cache = np.ascontiguousarray(np.asarray(
        jkv.pack_kv_rows(qk, qv, js)).transpose(1, 0, 2))
    j_scale = jkv._pack_scale_rows(sk, sv, js)
    return cache, j_scale, port_scale_rows(j_scale, ts)


@pytest.mark.parametrize("hq,kvh", [(HQ, KVH), (4, 4)])   # G=2, G=1 (MHA)
@pytest.mark.parametrize("layer", [0, 1])
def test_int8_decode_matches_jax(hq, kvh, layer):
    js, ts = q8_specs(kvh)
    cache, j_scale, t_scale = q8_cache(js, ts, 10)
    pt = page_table([p for p, _ in DECODE_ROWS], 4)
    ctx = np.array([c for _, c in DECODE_ROWS], np.int32)
    rng = np.random.default_rng(11)
    b = len(DECODE_ROWS)
    q = rng.standard_normal((b, hq, HD)).astype(np.float32)
    fk = rng.standard_normal((b, kvh, HD)).astype(np.float32)
    fv = rng.standard_normal((b, kvh, HD)).astype(np.float32)

    jargs = (jnp.asarray(q), jnp.asarray(cache), j_scale, jnp.asarray(pt),
             jnp.asarray(ctx), js)
    jkw = dict(layer=layer, fresh_k=jnp.asarray(fk), fresh_v=jnp.asarray(fv))
    j_ref = np.asarray(jattn.decode_attention_ref(*jargs, **jkw))
    j_kern = np.asarray(jpk.paged_decode_attention(
        *jargs, seq_block=1, interpret=True, **jkw))

    targs = (torch.from_numpy(q), torch.from_numpy(cache), t_scale,
             torch.from_numpy(pt), torch.from_numpy(ctx), ts)
    tkw = dict(layer=layer, fresh_k=torch.from_numpy(fk),
               fresh_v=torch.from_numpy(fv))
    t_ref = tattn.decode_attention_ref(*targs, **tkw).numpy()
    t_wrap = tpk.paged_decode_attention(*targs, **tkw).numpy()

    np.testing.assert_allclose(t_ref, j_ref, **TOL)
    np.testing.assert_allclose(t_wrap, j_kern, **Q8_TOL)
    live = ctx > 0
    np.testing.assert_array_equal(t_wrap[~live], 0.0)
    np.testing.assert_allclose(t_wrap[live], t_ref[live], atol=0, rtol=0)


@pytest.mark.parametrize("hq,kvh", [(HQ, KVH), (4, 4)])
def test_int8_prefill_matches_jax(hq, kvh):
    layer = 1
    js, ts = q8_specs(kvh)
    cache, j_scale, t_scale = q8_cache(js, ts, 12)
    pt = page_table([p for p, _, _ in PREFILL_ROWS], 5)
    start = np.array([s for _, s, _ in PREFILL_ROWS], np.int32)
    new_len = np.array([n for _, _, n in PREFILL_ROWS], np.int32)
    rng = np.random.default_rng(13)
    bp = len(PREFILL_ROWS)
    q = rng.standard_normal((bp, QP, hq, HD)).astype(np.float32)
    fk = rng.standard_normal((bp, QP, kvh, HD)).astype(np.float32)
    fv = rng.standard_normal((bp, QP, kvh, HD)).astype(np.float32)
    # this step's K/V, quantized as the step does: the int8 fresh slab
    # [Bp, KVH, Qp, 2*hd] and its scale rows [Bp, Qp, lanes]
    qk, sk = jkv.quantize_kv(jnp.asarray(fk), 8)
    qv, sv = jkv.quantize_kv(jnp.asarray(fv), 8)
    fslab = np.ascontiguousarray(np.asarray(
        jkv.pack_kv_rows(qk, qv, js)).transpose(0, 2, 1, 3))
    j_fscale = jkv._pack_scale_rows(sk, sv, js)
    t_fscale = port_scale_rows(j_fscale, ts)
    # the replay row's position is already in the cache (a full hit)
    r, s = 2, PREFILL_ROWS[2][1]
    slot = layer * ts.num_slots + pt[r, s // PS] * PS + s % PS
    cache[:, slot] = fslab[r, :, 0]
    j_scale = j_scale.at[slot].set(j_fscale[r, 0])
    t_scale[slot] = t_fscale[r, 0]
    # the XLA reference takes the dequantized fresh k/v, as the JAX step
    kd = jkv.dequantize_kv(qk, sk, 8, jnp.float32)
    vd = jkv.dequantize_kv(qv, sv, 8, jnp.float32)

    jargs = (jnp.asarray(q), jnp.asarray(cache), j_scale, jnp.asarray(pt),
             jnp.asarray(start), jnp.asarray(new_len), js)
    j_ref = np.asarray(jattn.prefill_attention_ref(
        *jargs, layer=layer, fresh_k=kd, fresh_v=vd))
    j_kern = np.asarray(jpk.paged_prefill_attention(
        *jargs, layer=layer, fresh_kv=jnp.asarray(fslab),
        fresh_scale=j_fscale, q_block=16, interpret=True))

    targs = (torch.from_numpy(q), torch.from_numpy(cache), t_scale,
             torch.from_numpy(pt), torch.from_numpy(start),
             torch.from_numpy(new_len), ts)
    t_ref = tattn.prefill_attention_ref(
        *targs, layer=layer, fresh_k=torch.from_numpy(np.array(kd)),
        fresh_v=torch.from_numpy(np.array(vd))).numpy()
    t_wrap = tpk.paged_prefill_attention(
        *targs, layer=layer, fresh_kv=torch.from_numpy(fslab),
        fresh_scale=t_fscale).numpy()

    v = valid_rows(new_len)
    np.testing.assert_allclose(t_ref, j_ref, **TOL)
    np.testing.assert_allclose(t_wrap, t_ref, atol=0, rtol=0)
    np.testing.assert_allclose(t_wrap[v], j_kern[v], **Q8_TOL)
    np.testing.assert_array_equal(t_wrap[~v], 0.0)
