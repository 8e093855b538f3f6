"""Port i8i8 and w4a8 quantization vs the JAX package, on the same numpy
inputs.

- ``quantize_weight`` / ``quantize_activation``: bytes and scales exact.
- plain and fused ``i8i8_matmul`` (and the K3 wrapper's CPU path) against
  the XLA composition: exact, since the quantized operands and the int32
  sums are exact and the epilogue multiplies in the same order.
- against ``i8i8_matmul_pallas(interpret=True)``: max |diff| <= 1e-5 of
  max |ref|, the JAX package's own Pallas-vs-XLA bound (its body scales
  by absmax * (1/127) where ops/quant.py divides; the port follows
  ops/quant.py).
- ``quantize_weight_int4`` / ``unpack_int4``: packed bytes and group
  scales exact, in the plain and the fused C-leading contracts and where
  the group halves to fit D/2.
- ``w4a8_matmul`` (plain, and the K4 wrapper's CPU path) against the XLA
  composition and ``w4a8_matmul_pallas(interpret=True)``: atol/rtol
  1e-5, the JAX package's own Pallas-vs-XLA tolerance
  (tests/test_quant_w4.py): the groups' f32 partial sums are added in
  another order.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.ops import quant as jq
from ppl.llm.serving_tpu.ops.pallas.quant_matmul import (
    i8i8_matmul_pallas, w4a8_matmul_pallas)
from ppl.llm.serving_tpu_torch.ops import quant as tq
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as tk


def rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape)
            * scale).astype(np.float32)


@pytest.mark.parametrize("shape,axis", [((64, 48), 0), ((32, 2, 40), 0),
                                        ((32, 2, 3, 8), 0)])
def test_quantize_weight_exact(shape, axis):
    w = rand(shape, 0, 0.1)
    w[:, 0] = 0.0   # an all-zero channel: scale 0, values 0
    jqv, jsv = jq.quantize_weight(jnp.asarray(w), contract_axis=axis)
    tqv, tsv = tq.quantize_weight(torch.from_numpy(w), contract_axis=axis)
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))


def test_quantize_activation_exact():
    x = rand((9, 64), 1)
    x[3] = 0.0
    jqv, jsv = jq.quantize_activation(jnp.asarray(x))
    tqv, tsv = tq.quantize_activation(torch.from_numpy(x))
    np.testing.assert_array_equal(tqv.numpy(), np.asarray(jqv))
    np.testing.assert_array_equal(tsv.numpy(), np.asarray(jsv))


def weights(w_shape, seed):
    w = rand(w_shape, seed, 0.1)
    jqv, jsv = jq.quantize_weight(jnp.asarray(w), contract_axis=0)
    return np.array(jqv), np.array(jsv)


@pytest.mark.parametrize("t,w_shape", [(8, (64, 128)), (33, (64, 2, 3, 16)),
                                       (1, (128, 64))])
def test_i8i8_plain_matches_jax(t, w_shape):
    x = rand((t, w_shape[0]), 2)
    wq, ws = weights(w_shape, 3)
    j_xla = np.asarray(jq.i8i8_matmul(jnp.asarray(x), jnp.asarray(wq),
                                      jnp.asarray(ws)))
    j_pal = np.asarray(i8i8_matmul_pallas(jnp.asarray(x), jnp.asarray(wq),
                                          jnp.asarray(ws), interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(wq), torch.from_numpy(ws))
    t_plain = tq.i8i8_matmul(*args).numpy()
    t_wrap = tk.i8i8_matmul(*args).numpy()
    np.testing.assert_array_equal(t_plain, j_xla)
    np.testing.assert_array_equal(t_wrap, j_xla)
    denom = float(np.abs(j_pal).max()) or 1.0
    assert float(np.abs(t_wrap - j_pal).max()) / denom <= 1e-5


def test_i8i8_fused_c_leading_matches_jax():
    t, d, n = 12, 64, 96
    x = rand((t, d), 4)
    wq, ws = weights((d, 2, n), 5)
    wq_c = np.ascontiguousarray(wq.transpose(1, 0, 2))      # [C, D, N]
    j_xla = np.asarray(jq.i8i8_matmul(jnp.asarray(x), jnp.asarray(wq_c),
                                      jnp.asarray(ws)))
    j_pal = np.asarray(i8i8_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wq_c), jnp.asarray(ws), interpret=True))
    t_wrap = tk.i8i8_matmul(torch.from_numpy(x), torch.from_numpy(wq_c),
                            torch.from_numpy(ws)).numpy()
    assert t_wrap.shape == (2, t, n)
    np.testing.assert_array_equal(t_wrap, j_xla)
    assert float(np.abs(t_wrap - j_pal).max()) / float(
        np.abs(j_pal).max()) <= 1e-5


def test_i8i8_bf16_in_and_out():
    """bf16 activations and a bf16 epilogue (the main path's setting):
    equal to the f32 result rounded to bf16, as the Pallas kernel's."""
    x = torch.from_numpy(rand((8, 64), 6)).to(torch.bfloat16)
    wq, ws = weights((64, 32), 7)
    wq, ws = torch.from_numpy(wq), torch.from_numpy(ws)
    f32 = tk.i8i8_matmul(x, wq, ws)
    bf = tk.i8i8_matmul(x, wq, ws, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, f32.to(torch.bfloat16), atol=0, rtol=0)
    x_j = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    j = np.asarray(i8i8_matmul_pallas(x_j, jnp.asarray(wq.numpy()),
                                      jnp.asarray(ws.numpy()),
                                      interpret=True))
    assert float(np.abs(f32.numpy() - j).max()) / float(
        np.abs(j).max()) <= 1e-5


W4_TOL = dict(atol=1e-5, rtol=1e-5)


def test_int4_search_factors_are_jax_linspace():
    want = np.asarray(jnp.linspace(1.0, 0.55, 12))
    np.testing.assert_array_equal(tq._search_factors(12).numpy(), want)
    for n in (2, 5, 16):
        np.testing.assert_array_equal(
            tq._search_factors(n).numpy(),
            np.asarray(jnp.linspace(1.0, 0.55, n)))


@pytest.mark.parametrize("shape,group,seed", [
    ((256, 40), 64, 0),          # plain contract, 4 groups
    ((512, 24), 128, 1),         # group 128: XLA's 4-window tree sum
    ((64, 16), 64, 2),           # D/2 = 32: the group halves to 32
    ((96, 8), 64, 3),            # D/2 = 48: the group halves to 16
    ((128, 2, 20), 64, 4),       # fused gate|up [D, 2, I]
    ((256, 2, 3, 8), 64, 5),     # wqkv-like [D, KVH, G+2, hd]
])
def test_quantize_weight_int4_exact(shape, group, seed):
    w = rand(shape, seed, 0.1)
    w[:, 0] = 0.0   # an all-zero column: scale 0, nibbles 0
    jp, js = jq.quantize_weight_int4(jnp.asarray(w), group=group)
    tp, ts = tq.quantize_weight_int4(torch.from_numpy(w), group=group)
    assert tp.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(),
                                  np.asarray(jq.unpack_int4(jp)))


def test_unpack_int4_nibble_pairing():
    """Byte i holds w[i] in its low nibble and w[i + D/2] in its high
    one; every nibble value sign-extends as the JAX shifts do."""
    lo = np.arange(-8, 8, dtype=np.int32)
    hi = lo[::-1].copy()
    packed = (((hi & 0xF) << 4) | (lo & 0xF)).astype(np.int8)[:, None]
    want = np.asarray(jq.unpack_int4(jnp.asarray(packed)))
    got = tq.unpack_int4(torch.from_numpy(packed)).numpy()
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got[:16, 0], lo)
    np.testing.assert_array_equal(got[16:, 0], hi)


def w4_weights(w_shape, seed, group=64):
    w = rand(w_shape, seed, 0.1)
    jp, js = jq.quantize_weight_int4(jnp.asarray(w), group=group)
    return np.array(jp), np.array(js)


@pytest.mark.parametrize("t,w_shape,group", [
    (8, (256, 128), 64), (33, (256, 2, 3, 16), 64), (1, (128, 64), 32),
    (5, (512, 32), 128)])
def test_w4a8_plain_matches_jax(t, w_shape, group):
    x = rand((t, w_shape[0]), 6)
    wp, ws = w4_weights(w_shape, 7, group)
    j_xla = np.asarray(jq.w4a8_matmul(jnp.asarray(x), jnp.asarray(wp),
                                      jnp.asarray(ws)))
    j_pal = np.asarray(w4a8_matmul_pallas(jnp.asarray(x), jnp.asarray(wp),
                                          jnp.asarray(ws), interpret=True))
    args = (torch.from_numpy(x), torch.from_numpy(wp), torch.from_numpy(ws))
    t_plain = tq.w4a8_matmul(*args).numpy()
    t_wrap = tk.w4a8_matmul(*args).numpy()
    assert t_plain.shape == j_xla.shape
    np.testing.assert_array_equal(t_wrap, t_plain)
    np.testing.assert_allclose(t_plain, j_xla, **W4_TOL)
    np.testing.assert_allclose(t_wrap, j_pal, **W4_TOL)


def test_w4a8_fused_c_leading_matches_jax():
    t, d, n = 12, 256, 96
    x = rand((t, d), 8)
    wp, ws = w4_weights((d, 2, n), 9)                 # [D/2, 2, N], [G, 2, N]
    wp_c = np.ascontiguousarray(wp.transpose(1, 0, 2))
    ws_c = np.ascontiguousarray(ws.transpose(1, 0, 2))
    j_xla = np.asarray(jq.w4a8_matmul(jnp.asarray(x), jnp.asarray(wp_c),
                                      jnp.asarray(ws_c)))
    j_pal = np.asarray(w4a8_matmul_pallas(
        jnp.asarray(x), jnp.asarray(wp_c), jnp.asarray(ws_c),
        interpret=True))
    t_wrap = tk.w4a8_matmul(torch.from_numpy(x), torch.from_numpy(wp_c),
                            torch.from_numpy(ws_c)).numpy()
    assert t_wrap.shape == (2, t, n)
    np.testing.assert_allclose(t_wrap, j_xla, **W4_TOL)
    np.testing.assert_allclose(t_wrap, j_pal, **W4_TOL)


def test_w4a8_bf16_in_and_out():
    x = torch.from_numpy(rand((8, 256), 10)).to(torch.bfloat16)
    wp, ws = w4_weights((256, 32), 11)
    wp, ws = torch.from_numpy(wp), torch.from_numpy(ws)
    f32 = tk.w4a8_matmul(x, wp, ws)
    bf = tk.w4a8_matmul(x, wp, ws, out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    torch.testing.assert_close(bf, f32.to(torch.bfloat16), atol=0, rtol=0)
    x_j = jnp.asarray(x.float().numpy()).astype(jnp.bfloat16)
    j = np.asarray(w4a8_matmul_pallas(x_j, jnp.asarray(wp.numpy()),
                                      jnp.asarray(ws.numpy()),
                                      interpret=True))
    np.testing.assert_allclose(f32.numpy(), j, **W4_TOL)


def test_w4a8_wrapper_refuses_other_devices():
    meta = torch.empty((4, 64), device="meta")
    with pytest.raises(ValueError):
        tk.w4a8_matmul(meta, meta, meta)
