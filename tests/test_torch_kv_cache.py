"""Port KV-cache layout vs the JAX package: the same new K/V rows written
by ``append_kv_rows_block`` give identical cache bytes (bf16 and f32),
and under int8 KV the same int8 values and bf16 scales (the used lanes
of the scale rows; the JAX package pads them to 128 lanes, the port to
8), with untouched rows byte-identical."""

import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.ops import kv_cache as jkv
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv

PS, NPAGES, KVH, HD, L = 16, 6, 2, 32, 3


def cache_bytes(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16).tobytes()
    return a.tobytes()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_append_rows_block_identical_bytes(dtype):
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = {"float32": torch.float32, "bfloat16": torch.bfloat16}[dtype]
    js = jkv.CacheSpec(num_layers=L, num_pages=NPAGES, page_size=PS,
                       num_kv_heads=KVH, head_dim=HD, dtype=jdt)
    ts = tkv.CacheSpec(num_layers=L, num_pages=NPAGES, page_size=PS,
                       num_kv_heads=KVH, head_dim=HD, dtype=tdt)
    rng = np.random.default_rng(0)
    # two rows' tokens on pages [2, 4] and [1], positions through the
    # page table as the step computes them
    pt = np.array([[2, 4], [1, NPAGES]], np.int32)
    pos = np.array([0, 5, 16, 20, 3, 15], np.int32)
    rows_of = np.array([0, 0, 0, 0, 1, 1], np.int32)
    t = len(pos)
    k = rng.standard_normal((L, t, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((L, t, KVH, HD)).astype(np.float32)

    j_slots = jkv.token_slots(jnp.asarray(pt), jnp.asarray(pos),
                              jnp.asarray(rows_of), PS)
    t_slots = tkv.token_slots(torch.from_numpy(pt), torch.from_numpy(pos),
                              torch.from_numpy(rows_of), PS)
    np.testing.assert_array_equal(t_slots.numpy(), np.asarray(j_slots))

    j_rows = jkv.pack_kv_rows(jnp.asarray(k).astype(jdt),
                              jnp.asarray(v).astype(jdt), js)
    t_rows = tkv.pack_kv_rows(torch.from_numpy(k).to(tdt),
                              torch.from_numpy(v).to(tdt), ts)
    assert cache_bytes(t_rows) == cache_bytes(j_rows)

    j_cache, _ = jkv.init_cache(js)
    j_cache, _ = jkv.append_kv_rows_block(j_cache, None, j_rows, None,
                                          j_slots, js)
    t_cache, t_scale = tkv.init_cache(ts, "cpu")
    assert t_scale is None
    out, _ = tkv.append_kv_rows_block(t_cache, None, t_rows, None, t_slots,
                                      ts)
    assert out.data_ptr() == t_cache.data_ptr()   # written in place
    assert tuple(t_cache.shape) == tuple(j_cache.shape)
    assert cache_bytes(t_cache) == cache_bytes(j_cache)

    # gathering the pages back gives the JAX package's dense K/V
    for layer in range(L):
        jk, jv = jkv.gather_pages(j_cache, None, jnp.asarray(pt), js,
                                  dtype=jnp.float32, layer=layer)
        tk, tv = tkv.gather_pages(t_cache, None, torch.from_numpy(pt), ts,
                                  torch.float32, layer=layer)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def int8_specs(head_dim=HD, kvh=KVH):
    kw = dict(num_layers=L, num_pages=NPAGES, page_size=PS,
              num_kv_heads=kvh, head_dim=head_dim, quant_bit=8,
              quant_group=8)
    return (jkv.CacheSpec(dtype=jnp.float32, **kw),
            tkv.CacheSpec(dtype=torch.float32, **kw))


def bf16_bits(x):
    if isinstance(x, torch.Tensor):
        return x.view(torch.int16).numpy()
    return np.asarray(x).view(np.int16)


@pytest.mark.parametrize("shape", [(5, 2, 32), (3, 7, 4, 16)])
def test_quantize_kv_matches_jax(shape):
    x = np.random.default_rng(1).standard_normal(shape).astype(np.float32)
    x[0, 0, :8] = 0.0            # an all-zero group: scale 0, values 0
    x[1, 0, :8] *= 1e-9          # a group below the 1e-8 scale clamp
    jq, js = jkv.quantize_kv(jnp.asarray(x), 8)
    tq, ts = tkv.quantize_kv(torch.from_numpy(x), 8)
    assert tq.dtype == torch.int8 and ts.dtype == torch.bfloat16
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(bf16_bits(ts), bf16_bits(js))
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.bfloat16, torch.bfloat16)):
        jd = jkv.dequantize_kv(jq, js, 8, dt_j)
        td = tkv.dequantize_kv(tq, ts, 8, dt_t)
        np.testing.assert_array_equal(td.float().numpy(),
                                      np.asarray(jd).astype(np.float32))


@pytest.mark.parametrize("kvh,head_dim", [(KVH, HD), (3, 16)])
def test_scale_rows_match_jax(kvh, head_dim):
    js, ts = int8_specs(head_dim, kvh)
    assert ts.scale_lanes % 8 == 0
    assert ts.scale_lanes >= kvh * ts.scale_lane_stride
    used = kvh * ts.scale_lane_stride
    assert used == kvh * js.scale_lane_stride
    rng = np.random.default_rng(2)
    sk = rng.standard_normal((4, kvh, head_dim // 8)).astype(np.float32)
    sv = rng.standard_normal((4, kvh, head_dim // 8)).astype(np.float32)
    j = jkv._pack_scale_rows(jnp.asarray(sk).astype(jnp.bfloat16),
                             jnp.asarray(sv).astype(jnp.bfloat16), js)
    t = tkv.pack_scale_rows(torch.from_numpy(sk).to(torch.bfloat16),
                            torch.from_numpy(sv).to(torch.bfloat16), ts)
    assert tuple(t.shape) == (4, ts.scale_lanes)
    np.testing.assert_array_equal(bf16_bits(t)[:, :used],
                                  bf16_bits(j)[:, :used])
    assert not bf16_bits(t)[:, used:].any()


def test_int8_append_and_gather_match_jax():
    js, ts = int8_specs()
    rng = np.random.default_rng(3)
    pt = np.array([[2, 4], [1, NPAGES]], np.int32)
    pos = np.array([0, 5, 16, 20, 3, 15], np.int32)
    rows_of = np.array([0, 0, 0, 0, 1, 1], np.int32)
    t = len(pos)
    k = rng.standard_normal((L, t, KVH, HD)).astype(np.float32)
    v = rng.standard_normal((L, t, KVH, HD)).astype(np.float32)
    slots = np.array(jkv.token_slots(jnp.asarray(pt), jnp.asarray(pos),
                                       jnp.asarray(rows_of), PS))

    jqk, jsk = jkv.quantize_kv(jnp.asarray(k), 8)
    jqv, jsv = jkv.quantize_kv(jnp.asarray(v), 8)
    j_rows = jkv.pack_kv_rows(jqk, jqv, js)
    j_srows = jkv._pack_scale_rows(jsk, jsv, js)
    j_cache, j_scale = jkv.init_cache(js)
    j_cache, j_scale = jkv.append_kv_rows_block(
        j_cache, j_scale, j_rows, j_srows, jnp.asarray(slots), js)

    tqk, tsk = tkv.quantize_kv(torch.from_numpy(k), 8)
    tqv, tsv = tkv.quantize_kv(torch.from_numpy(v), 8)
    t_rows = tkv.pack_kv_rows(tqk, tqv, ts)
    t_srows = tkv.pack_scale_rows(tsk, tsv, ts)
    t_cache, t_scale = tkv.init_cache(ts, "cpu")
    assert t_cache.dtype == torch.int8 and t_scale.dtype == torch.bfloat16
    out_c, out_s = tkv.append_kv_rows_block(
        t_cache, t_scale, t_rows, t_srows, torch.from_numpy(slots), ts)
    assert out_c.data_ptr() == t_cache.data_ptr()
    assert out_s.data_ptr() == t_scale.data_ptr()

    # int8 rows identical everywhere (untouched rows stay zero on both)
    assert t_cache.numpy().tobytes() == np.asarray(j_cache).tobytes()
    used = KVH * ts.scale_lane_stride
    np.testing.assert_array_equal(bf16_bits(t_scale)[:, :used],
                                  bf16_bits(j_scale)[:, :used])
    assert not bf16_bits(t_scale)[:, used:].any()

    for layer in range(L):
        jk, jv = jkv.gather_pages(j_cache, j_scale, jnp.asarray(pt), js,
                                  dtype=jnp.float32, layer=layer)
        tk, tv = tkv.gather_pages(t_cache, t_scale, torch.from_numpy(pt),
                                  ts, torch.float32, layer=layer)
        np.testing.assert_array_equal(tk.numpy(), np.asarray(jk))
        np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_int8_append_leaves_other_rows_untouched():
    """Rows the write does not address keep their bytes, values and
    scales alike."""
    _, ts = int8_specs()
    rng = np.random.default_rng(4)
    cache0 = rng.integers(-127, 128, (KVH, L * ts.num_slots,
                                      ts.row_lanes)).astype(np.int8)
    scale0 = torch.from_numpy(rng.standard_normal(
        (L * ts.num_slots, ts.scale_lanes)).astype(np.float32)).to(
            torch.bfloat16)
    cache = torch.from_numpy(cache0.copy())
    scale = scale0.clone()
    slots = torch.tensor([3, 17, 40], dtype=torch.int32)
    k = torch.from_numpy(rng.standard_normal((L, 3, KVH, HD)).astype(
        np.float32))
    qk, sk = tkv.quantize_kv(k, 8)
    tkv.append_kv_rows_block(cache, scale, tkv.pack_kv_rows(qk, qk, ts),
                             tkv.pack_scale_rows(sk, sk, ts), slots, ts)
    hit = np.zeros(L * ts.num_slots, bool)
    for layer in range(L):
        hit[layer * ts.num_slots + slots.numpy()] = True
    assert cache.numpy()[:, ~hit].tobytes() == cache0[:, ~hit].tobytes()
    assert (bf16_bits(scale)[~hit] == bf16_bits(scale0)[~hit]).all()
    assert (cache.numpy()[:, hit] != cache0[:, hit]).any()
