"""The port's CUDA kernels against their plain PyTorch versions on the
card. Marked ``gpu``: each test skips (with its reason) where PyTorch sees
no CUDA device, and runs on the GPU machine with

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu

Tolerances: f32 atol/rtol 2e-5 for attention (only the order of the
softmax sums differs), bf16 2e-2 (bf16 inputs, f32 accumulation on both
sides, bf16 output rounding); with int8 KV the same (the kernels
dequantize in f32, exactly as the plain version does before its bf16
rounding); i8i8 exact in f32 (same quantized operands, exact int32 sums,
same epilogue order) and within one bf16 rounding in bf16; K1's block-tail
phase as K1; w4a8 (both tensor-core tiles, groups 16-128) within
1e-5 of max|ref| in f32 (the groups' f32 partials are added in another
order) and, in bf16, within 2^-8 |ref| + 1e-5 max|ref| per element, and
with split-K bit-equal to itself across two runs and a graph replay.
K1/K2 with ALiBi: f32 atol 2e-4 (the JAX package's ALiBi tolerance; the
scores carry slope * k_pos, up to ~270 at 13B widths, whose f32 ulp is
~3e-5), bf16 as without. K5 (the page read) exact. K1's tensor-core
body (bf16 q, the context split over S CTAs) at chip_smoke's bf16 limits,
3e-2 and, with ALiBi, 3e-2 + 2^-7 |ref|, and bit-equal to itself across
two runs and a CUDA graph replay.
"""

import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu_torch.ops import attention as attn_ops
from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.ops import kernels
from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
from ppl.llm.serving_tpu_torch.ops.kernels import cache_read
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as pk
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as qk
from ppl.llm.serving_tpu_torch.ops.kv_cache import CacheSpec

pytestmark = pytest.mark.gpu

TOLS = {torch.float32: dict(atol=2e-5, rtol=2e-5),
        torch.bfloat16: dict(atol=2e-2, rtol=2e-2)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (PyTorch sees none)")
    return torch.device("cuda")


def make_cache(spec, dev, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    return torch.randn((spec.num_kv_heads, spec.num_layers * spec.num_slots,
                        spec.row_lanes), generator=g, device=dev).to(
                            spec.dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kvh,hd", [(32, 4, 64), (4, 2, 16)])
def test_decode_kernel_matches_plain(cuda, dtype, hq, kvh, hd):
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=16,
                     num_kv_heads=kvh, head_dim=hd, dtype=dtype)
    cache = make_cache(spec, cuda, 0)
    ctx = torch.tensor([0, 1, 17, 160, 300, 33], dtype=torch.int32,
                       device=cuda)
    b = ctx.numel()
    # 20 pages per row cover ctx 300 at page size 16; rows may share
    # pages (attention only reads them)
    rng = np.random.default_rng(0)
    pt = torch.from_numpy(rng.integers(0, 40, (b, 20)).astype(
        np.int32)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn((b, hq, hd), generator=g, device=cuda).to(dtype)
    fk = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    fv = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    out = pk.paged_decode_attention(q, cache, None, pt, ctx, spec, layer=1,
                                    fresh_k=fk, fresh_v=fv)
    torch.cuda.synchronize()
    ref = attn_ops.decode_attention_ref(q, cache, None, pt, ctx, spec,
                                        layer=1, fresh_k=fk, fresh_v=fv)
    ref = torch.where((ctx > 0)[:, None, None], ref, torch.zeros(
        (), dtype=ref.dtype, device=cuda))
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kvh,hd", [(32, 4, 64), (4, 2, 16)])
def test_prefill_kernel_matches_plain(cuda, dtype, hq, kvh, hd):
    ps, qp = 16, 64
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=ps,
                     num_kv_heads=kvh, head_dim=hd, dtype=dtype)
    cache = make_cache(spec, cuda, 2)
    start = torch.tensor([0, 2 * ps, 2 * ps - 1, 0], dtype=torch.int32,
                         device=cuda)
    new_len = torch.tensor([50, 64, 1, 0], dtype=torch.int32, device=cuda)
    bp = start.numel()
    pt = (torch.arange(bp * 8, dtype=torch.int32, device=cuda)
          .reshape(bp, 8) % 40)
    g = torch.Generator(device=cuda).manual_seed(3)
    q = torch.randn((bp, qp, hq, hd), generator=g, device=cuda).to(dtype)
    fresh = torch.randn((bp, kvh, qp, 2 * hd), generator=g,
                        device=cuda).to(dtype)
    out = pk.paged_prefill_attention(q, cache, None, pt, start, new_len,
                                     spec, layer=1, fresh_kv=fresh)
    torch.cuda.synchronize()
    fk = fresh[..., :hd].permute(0, 2, 1, 3)
    fv = fresh[..., hd:].permute(0, 2, 1, 3)
    ref = attn_ops.prefill_attention_ref(q, cache, None, pt, start, new_len,
                                         spec, layer=1, fresh_k=fk,
                                         fresh_v=fv)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


# K3 at T on either side of the decode tile's 8-row token tiles and 64
# rows and of the prefill tile's 128, at 256 x 192 and at the edges the
# tiles mask: D % 32 != 0, N not a multiple of the 128-column tile (nor of
# 16: the prefill tile at every T, with 4-byte weight copies)
K3_TS = [1, 8, 9, 16, 17, 24, 32, 48, 64, 100, 1024, 4096]


@pytest.mark.parametrize("t", K3_TS)
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("d,n", [(256, 192), (260, 196)])
def test_i8i8_kernel_matches_plain(cuda, t, fused, d, n):
    """Exact in f32 and in bf16 (the same f32 value rounded once), on the
    tile ``k3_tile`` routes T and N to, whose launch counter moves."""
    g = torch.Generator(device=cuda).manual_seed(4)
    w = torch.randn(((2, d, n) if fused else (d, n)), generator=g,
                    device=cuda) * 0.05
    if fused:
        qs = [quant_ops.quantize_weight(w[c]) for c in range(2)]
        wq = torch.stack([q for q, _ in qs]).contiguous()
        ws = torch.stack([s for _, s in qs]).contiguous()
    else:
        wq, ws = quant_ops.quantize_weight(w)
    x = torch.randn((t, d), generator=g, device=cuda)
    tile = qk.k3_tile(t, n)
    before = kernels.launch_counts()
    out = qk.i8i8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    after = kernels.launch_counts()
    assert after["i8i8_matmul"] == before["i8i8_matmul"] + 1
    for name in qk.TILES:
        key = f"i8i8_matmul_{name}"
        assert after[key] == before[key] + (name == tile), key
    ref = quant_ops.i8i8_matmul(x, wq, ws)
    torch.testing.assert_close(out, ref, atol=0, rtol=0)
    out_bf = qk.i8i8_matmul(x.to(torch.bfloat16), wq, ws,
                            out_dtype=torch.bfloat16)
    ref_bf = quant_ops.i8i8_matmul(x.to(torch.bfloat16), wq, ws)
    torch.testing.assert_close(out_bf.float(), ref_bf.to(torch.bfloat16)
                               .float(), atol=0, rtol=0)


def make_int8_cache(spec, dev, seed):
    """Random K/V quantized into a whole int8 cache and its scale rows."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = spec.num_layers * spec.num_slots
    k = torch.randn((n, spec.num_kv_heads, spec.head_dim), generator=g,
                    device=dev)
    v = torch.randn((n, spec.num_kv_heads, spec.head_dim), generator=g,
                    device=dev)
    qk, sk = kv_ops.quantize_kv(k, 8)
    qv, sv = kv_ops.quantize_kv(v, 8)
    cache = kv_ops.pack_kv_rows(qk, qv, spec).permute(1, 0, 2).contiguous()
    return cache, kv_ops.pack_scale_rows(sk, sv, spec).contiguous()


INT8_GEOMS = [(32, 32, 128), (32, 4, 64)]   # LLaMA-2-7B (G=1), TinyLlama


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kvh,hd", INT8_GEOMS)
def test_int8_decode_kernel_matches_plain(cuda, dtype, hq, kvh, hd):
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=16,
                     num_kv_heads=kvh, head_dim=hd, quant_bit=8,
                     quant_group=8, dtype=dtype)
    cache, scale = make_int8_cache(spec, cuda, 5)
    ctx = torch.tensor([0, 1, 17, 160, 300, 33], dtype=torch.int32,
                       device=cuda)
    b = ctx.numel()
    rng = np.random.default_rng(5)
    pt = torch.from_numpy(rng.integers(0, 40, (b, 20)).astype(
        np.int32)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(6)
    q = torch.randn((b, hq, hd), generator=g, device=cuda).to(dtype)
    fk = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    fv = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    out = pk.paged_decode_attention(q, cache, scale, pt, ctx, spec, layer=1,
                                    fresh_k=fk, fresh_v=fv)
    torch.cuda.synchronize()
    ref = attn_ops.decode_attention_ref(q, cache, scale, pt, ctx, spec,
                                        layer=1, fresh_k=fk, fresh_v=fv)
    ref = torch.where((ctx > 0)[:, None, None], ref, torch.zeros(
        (), dtype=ref.dtype, device=cuda))
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kvh,hd", INT8_GEOMS)
def test_int8_prefill_kernel_matches_plain(cuda, dtype, hq, kvh, hd):
    ps, qp = 16, 64
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=ps,
                     num_kv_heads=kvh, head_dim=hd, quant_bit=8,
                     quant_group=8, dtype=dtype)
    cache, scale = make_int8_cache(spec, cuda, 7)
    start = torch.tensor([0, 2 * ps, 2 * ps - 1, 0], dtype=torch.int32,
                         device=cuda)
    new_len = torch.tensor([50, 64, 1, 0], dtype=torch.int32, device=cuda)
    bp = start.numel()
    pt = (torch.arange(bp * 8, dtype=torch.int32, device=cuda)
          .reshape(bp, 8) % 40)
    g = torch.Generator(device=cuda).manual_seed(8)
    q = torch.randn((bp, qp, hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((bp, qp, kvh, hd), generator=g, device=cuda)
    v = torch.randn((bp, qp, kvh, hd), generator=g, device=cuda)
    qk, sk = kv_ops.quantize_kv(k, 8)
    qv, sv = kv_ops.quantize_kv(v, 8)
    fresh = kv_ops.pack_kv_rows(qk, qv, spec).permute(0, 2, 1, 3).contiguous()
    fscale = kv_ops.pack_scale_rows(sk, sv, spec).contiguous()
    out = pk.paged_prefill_attention(q, cache, scale, pt, start, new_len,
                                     spec, layer=1, fresh_kv=fresh,
                                     fresh_scale=fscale)
    torch.cuda.synchronize()
    ref = attn_ops.prefill_attention_ref(
        q, cache, scale, pt, start, new_len, spec, layer=1,
        fresh_k=kv_ops.dequantize_kv(qk, sk, 8, dtype),
        fresh_v=kv_ops.dequantize_kv(qv, sv, 8, dtype))
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])


def make_tail(spec, b, jt, dev, seed):
    """A random block side buffer [L, B, KVH, J, 2*hd] (int8 with its
    scale rows [L, B, J, lanes] when the spec is quantized)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    n = spec.num_layers * b * jt
    k = torch.randn((n, spec.num_kv_heads, spec.head_dim), generator=g,
                    device=dev)
    v = torch.randn((n, spec.num_kv_heads, spec.head_dim), generator=g,
                    device=dev)
    tscale = None
    if spec.quantized:
        qk, sk = kv_ops.quantize_kv(k, 8)
        qv, sv = kv_ops.quantize_kv(v, 8)
        rows = kv_ops.pack_kv_rows(qk, qv, spec)
        tscale = kv_ops.pack_scale_rows(sk, sv, spec).reshape(
            spec.num_layers, b, jt, spec.scale_lanes).contiguous()
    else:
        rows = kv_ops.pack_kv_rows(k, v, spec).to(spec.dtype)
    tkv = rows.reshape(spec.num_layers, b, jt, spec.num_kv_heads,
                       spec.row_lanes).permute(0, 1, 3, 2, 4).contiguous()
    return tkv, tscale


@pytest.mark.parametrize("tail_len", [0, 1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("quant", [False, True])
def test_tail_decode_kernel_matches_plain(cuda, tail_len, dtype, quant):
    """K1 in block-tail mode (J = 8 side-buffer rows): LLaMA-2-7B geometry
    with int8 KV, TinyLlama geometry with a float cache."""
    hq, kvh, hd = (32, 32, 128) if quant else (32, 4, 64)
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=16,
                     num_kv_heads=kvh, head_dim=hd,
                     quant_bit=8 if quant else 0,
                     quant_group=8 if quant else 1, dtype=dtype)
    if quant:
        cache, scale = make_int8_cache(spec, cuda, 10)
    else:
        cache, scale = make_cache(spec, cuda, 10), None
    # a padding row (0), a row whose whole context is tail + self (2),
    # and rows with cached pages
    ctx = torch.tensor([0, 2, 17, 160, 300, 8], dtype=torch.int32,
                       device=cuda)
    b, jt = ctx.numel(), 8
    tkv, tscale = make_tail(spec, b, jt, cuda, 11)
    tlen = torch.full((1,), tail_len, dtype=torch.int32, device=cuda)
    rng = np.random.default_rng(12)
    pt = torch.from_numpy(rng.integers(0, 40, (b, 20)).astype(
        np.int32)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(13)
    q = torch.randn((b, hq, hd), generator=g, device=cuda).to(dtype)
    fk = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    fv = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv, tail_kv=tkv,
              tail_scale=tscale, tail_len=tlen)
    before = pk.paged_decode_attention.tail_launches
    out = pk.paged_decode_attention(q, cache, scale, pt, ctx, spec, **kw)
    torch.cuda.synchronize()
    assert pk.paged_decode_attention.tail_launches == before + 1
    ref = attn_ops.decode_attention_ref(q, cache, scale, pt, ctx, spec, **kw)
    torch.testing.assert_close(out.float(), ref.float(), **TOLS[dtype])
    assert bool((out[0] == 0).all())


def test_tail_decode_kernel_checks_its_arguments(cuda):
    spec = CacheSpec(num_layers=2, num_pages=8, page_size=16, num_kv_heads=2,
                     head_dim=16, dtype=torch.float32)
    cache = make_cache(spec, cuda, 14)
    b = 2
    q = torch.zeros((b, 4, 16), device=cuda)
    fk = torch.zeros((b, 2, 16), device=cuda)
    pt = torch.zeros((b, 2), dtype=torch.int32, device=cuda)
    ctx = torch.ones(b, dtype=torch.int32, device=cuda)
    tlen = torch.ones(1, dtype=torch.int32, device=cuda)
    kw = dict(layer=0, fresh_k=fk, fresh_v=fk, tail_len=tlen)
    with pytest.raises(ValueError, match="tail rows"):
        pk.paged_decode_attention(
            q, cache, None, pt, ctx, spec,
            tail_kv=torch.zeros((2, b, 2, 65, 32), device=cuda), **kw)
    with pytest.raises(ValueError, match="tail_kv shape"):
        pk.paged_decode_attention(
            q, cache, None, pt, ctx, spec,
            tail_kv=torch.zeros((2, b + 1, 2, 8, 32), device=cuda), **kw)
    with pytest.raises(TypeError, match="tail_kv dtype"):
        pk.paged_decode_attention(
            q, cache, None, pt, ctx, spec,
            tail_kv=torch.zeros((2, b, 2, 8, 32), device=cuda,
                                dtype=torch.bfloat16), **kw)


def _w4_operands(dev, d, n, fused, seed, group=64):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(((d, 2, n) if fused else (d, n)), generator=g,
                    device=dev) * d ** -0.5
    wp, ws = quant_ops.quantize_weight_int4(w, group=group)
    assert ws.shape[0] == d // group
    if fused:
        wp = wp.permute(1, 0, 2).contiguous()
        ws = ws.permute(1, 0, 2).contiguous()
    return wp, ws, g


def _w4_check(out, ref, bf16):
    """f32: 1e-5 of max|ref|; bf16: 2^-8 |ref| + 1e-5 max|ref| each."""
    scale = float(ref.abs().max())
    lim = 1e-5 * scale + (2.0 ** -8 * ref.abs() if bf16 else 0.0)
    diff = (out.float() - ref).abs()
    assert bool((diff <= lim).all()), float(diff.max())


# K4 at T on either side of the decode tile's 8 and 16 rows and at
# prefill sizes, groups 16-128, at 512 x 192 and at the edges the tiles
# mask: N = 196 (not a multiple of 16: 4-byte weight copies, a partial
# column tile) with D/2 = 352 (not a multiple of the 64-row stage) at
# groups 16 and 32, D/2 = 384 at 64 and 128
@pytest.mark.parametrize("group", [16, 32, 64, 128])
@pytest.mark.parametrize("t", [1, 8, 16, 17, 100, 1024])
@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("shape", ["512x192", "odd"])
def test_w4a8_kernel_matches_plain(cuda, group, t, fused, shape):
    d, n = (512, 192) if shape == "512x192" else (
        (704, 196) if group <= 32 else (768, 196))
    wp, ws, g = _w4_operands(cuda, d, n, fused, 9, group)
    x = torch.randn((t, d), generator=g, device=cuda)
    before = qk.w4a8_matmul.launches
    out = qk.w4a8_matmul(x, wp, ws)
    torch.cuda.synchronize()
    assert qk.w4a8_matmul.launches == before + 1
    _w4_check(out, quant_ops.w4a8_matmul(x, wp, ws), bf16=False)
    xb = x.to(torch.bfloat16)
    out_bf = qk.w4a8_matmul(xb, wp, ws, out_dtype=torch.bfloat16)
    _w4_check(out_bf, quant_ops.w4a8_matmul(xb, wp, ws), bf16=True)


# LLaMA-2-7B's K4 weights that the planner cuts most: wo, down (32
# column tiles each), and gate|up (fused)
K4_7B = [("wo", 4096, 4096, False), ("down", 11008, 4096, False),
         ("gate|up", 4096, 11008, True)]


@pytest.mark.parametrize("name,d,n,fused", K4_7B)
@pytest.mark.parametrize("t", [1, 8, 16])
def test_w4a8_kernel_split_k_is_repeatable_and_graph_safe(cuda, name, d, n,
                                                          fused, t):
    """The decode tile's pieces write f32 partials that the last piece
    of a column tile adds in piece order: within the tolerance, the same
    bits on two runs and in a CUDA graph replay, and the arrival counters
    back at zero after each."""
    wp, ws, g = _w4_operands(cuda, d, n, fused, 41)
    splits, _ = qk.plan_split_k_w4(t, d // 2, n, 2 if fused else 1,
                                   torch.cuda.get_device_properties(
                                       cuda).multi_processor_count, 64)
    assert splits > 1
    x = torch.randn((t, d), generator=g, device=cuda, dtype=torch.bfloat16)

    def run(out_dtype=torch.bfloat16):
        return qk.w4a8_matmul(x, wp, ws, out_dtype=out_dtype)

    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    ref = quant_ops.w4a8_matmul(x, wp, ws)
    _w4_check(first, ref, bf16=True)
    _w4_check(run(torch.float32), ref, bf16=False)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), replayed.view(torch.int16))
    assert int(qk._COUNTERS[x.device].abs().sum()) == 0


def test_w4a8_kernel_checks_its_arguments(cuda):
    """Groups outside 16-128 or not dividing D/2, and N % 4 != 0, are
    refused before any launch."""
    x = torch.zeros((8, 192), device=cuda)
    wp = torch.zeros((96, 64), dtype=torch.int8, device=cuda)
    with pytest.raises(ValueError, match="group"):
        qk.w4a8_matmul(x, wp, torch.zeros((2, 64), device=cuda))   # 96
    with pytest.raises(ValueError, match="group"):
        qk.w4a8_matmul(x, wp, torch.zeros((24, 64), device=cuda))  # 8
    with pytest.raises(ValueError, match="multiple of 4"):
        qk.w4a8_matmul(x, torch.zeros((96, 62), dtype=torch.int8,
                                      device=cuda),
                       torch.zeros((6, 62), device=cuda))


ALIBI_TOLS = {torch.float32: dict(atol=2e-4, rtol=2e-5),
              torch.bfloat16: TOLS[torch.bfloat16]}
# Baichuan-13B (40 heads, MHA, int8 KV), TinyLlama (G = 8, float cache)
ALIBI_GEOMS = [(40, 40, 128, True), (32, 4, 64, False)]


@pytest.mark.parametrize("tail_len", [None, 1, 7])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kvh,hd,quant", ALIBI_GEOMS)
def test_alibi_decode_kernel_matches_plain(cuda, hq, kvh, hd, quant, dtype,
                                           tail_len):
    """K1's ALiBi branch in its page, tail and self-term phases (plain
    deferred mode when ``tail_len`` is None)."""
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=16,
                     num_kv_heads=kvh, head_dim=hd,
                     quant_bit=8 if quant else 0,
                     quant_group=8 if quant else 1, dtype=dtype)
    if quant:
        cache, scale = make_int8_cache(spec, cuda, 20)
    else:
        cache, scale = make_cache(spec, cuda, 20), None
    ctx = torch.tensor([0, 2, 17, 160, 300, 8], dtype=torch.int32,
                       device=cuda)
    b = ctx.numel()
    rng = np.random.default_rng(21)
    pt = torch.from_numpy(rng.integers(0, 40, (b, 20)).astype(
        np.int32)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(22)
    q = torch.randn((b, hq, hd), generator=g, device=cuda).to(dtype)
    fk = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    fv = torch.randn((b, kvh, hd), generator=g, device=cuda).to(dtype)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv,
              alibi=attn_ops.alibi_slopes(hq).to(cuda))
    if tail_len is not None:
        tkv, tscale = make_tail(spec, b, 8, cuda, 23)
        kw.update(tail_kv=tkv, tail_scale=tscale, tail_len=torch.full(
            (1,), tail_len, dtype=torch.int32, device=cuda))
    before = pk.paged_decode_attention.alibi_launches
    out = pk.paged_decode_attention(q, cache, scale, pt, ctx, spec, **kw)
    torch.cuda.synchronize()
    assert pk.paged_decode_attention.alibi_launches == before + 1
    ref = attn_ops.decode_attention_ref(q, cache, scale, pt, ctx, spec, **kw)
    ref = torch.where((ctx > 0)[:, None, None], ref, torch.zeros(
        (), dtype=ref.dtype, device=cuda))
    torch.testing.assert_close(out.float(), ref.float(), **ALIBI_TOLS[dtype])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq,kvh,hd,quant", ALIBI_GEOMS)
def test_alibi_prefill_kernel_matches_plain(cuda, hq, kvh, hd, quant, dtype):
    """K2's ALiBi branch: start 0, a 2-page prefix hit, the replay row
    and a padding row."""
    ps, qp = 16, 64
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=ps,
                     num_kv_heads=kvh, head_dim=hd,
                     quant_bit=8 if quant else 0,
                     quant_group=8 if quant else 1, dtype=dtype)
    if quant:
        cache, scale = make_int8_cache(spec, cuda, 24)
    else:
        cache, scale = make_cache(spec, cuda, 24), None
    start = torch.tensor([0, 2 * ps, 2 * ps - 1, 0], dtype=torch.int32,
                         device=cuda)
    new_len = torch.tensor([50, 64, 1, 0], dtype=torch.int32, device=cuda)
    bp = start.numel()
    pt = (torch.arange(bp * 8, dtype=torch.int32, device=cuda)
          .reshape(bp, 8) % 40)
    g = torch.Generator(device=cuda).manual_seed(25)
    q = torch.randn((bp, qp, hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((bp, qp, kvh, hd), generator=g, device=cuda)
    v = torch.randn((bp, qp, kvh, hd), generator=g, device=cuda)
    if quant:
        qk8, sk = kv_ops.quantize_kv(k, 8)
        qv8, sv = kv_ops.quantize_kv(v, 8)
        fresh = kv_ops.pack_kv_rows(qk8, qv8, spec)
        fscale = kv_ops.pack_scale_rows(sk, sv, spec).contiguous()
        fk = kv_ops.dequantize_kv(qk8, sk, 8, dtype)
        fv = kv_ops.dequantize_kv(qv8, sv, 8, dtype)
    else:
        fresh = kv_ops.pack_kv_rows(k, v, spec).to(dtype)
        fscale, fk, fv = None, k.to(dtype), v.to(dtype)
    fresh = fresh.permute(0, 2, 1, 3).contiguous()
    slopes = attn_ops.alibi_slopes(hq).to(cuda)
    before = pk.paged_prefill_attention.alibi_launches
    out = pk.paged_prefill_attention(q, cache, scale, pt, start, new_len,
                                     spec, layer=1, fresh_kv=fresh,
                                     fresh_scale=fscale, alibi=slopes)
    torch.cuda.synchronize()
    assert pk.paged_prefill_attention.alibi_launches == before + 1
    ref = attn_ops.prefill_attention_ref(q, cache, scale, pt, start, new_len,
                                         spec, layer=1, fresh_k=fk,
                                         fresh_v=fv, alibi=slopes)
    torch.testing.assert_close(out.float(), ref.float(), **ALIBI_TOLS[dtype])


def test_alibi_slopes_are_checked(cuda):
    spec = CacheSpec(num_layers=1, num_pages=4, page_size=16, num_kv_heads=2,
                     head_dim=16, dtype=torch.float32)
    cache = make_cache(spec, cuda, 26)
    q = torch.zeros((1, 4, 16), device=cuda)
    fk = torch.zeros((1, 2, 16), device=cuda)
    pt = torch.zeros((1, 2), dtype=torch.int32, device=cuda)
    ctx = torch.ones(1, dtype=torch.int32, device=cuda)
    for bad in (torch.ones(3, device=cuda),
                torch.ones(4, device=cuda, dtype=torch.bfloat16)):
        with pytest.raises(ValueError, match="alibi"):
            pk.paged_decode_attention(q, cache, None, pt, ctx, spec, layer=0,
                                      fresh_k=fk, fresh_v=fk, alibi=bad)
    with pytest.raises(ValueError, match="alibi"):
        pk.paged_decode_attention(q, cache, None, pt, ctx, spec, layer=0,
                                  fresh_k=fk, fresh_v=fk,
                                  alibi=torch.ones(4))


@pytest.mark.parametrize("kvh,ps,r,rows", [
    (4, 128, 256, 8), (4, 16, 32, 1), (4, 256, 256, 8),
    (32, 128, 256, 8),            # the microbench: 32 chunks of 4 rows
    (32, 128, 256, 128),          # rows = PS: every chunk converts
    (40, 128, 256, 8),            # 26 chunks of 5 rows, the last of 3
    (40, 128, 256, 128),          # ... and every one of them converts
    (1100, 16, 32, 8),            # 8 heads a SM or more: one chunk a head
    (1056, 128, 256, 128),        # one 32 kB chunk a head, all converted
    (1056, 256, 256, 256)])       # a 64 kB chunk: past the default 48 kB
def test_page_read_kernel_matches_plain(cuda, kvh, ps, r, rows):
    """K5 exact at its chunk plans: one chunk a head, many, a last chunk
    shorter than the others, and a chunk above the default 48 kB of
    shared memory."""
    g = torch.Generator(device=cuda).manual_seed(27)
    cache = torch.randint(-128, 128, (kvh, 3 * ps, r), generator=g,
                          device=cuda, dtype=torch.int8)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    _, n_chunks = cache_read.plan_page_read(kvh, ps, r, sms)
    assert (n_chunks == 1) == (kvh >= cache_read.CTAS_PER_SM * sms)
    before = cache_read.page_read.launches
    out = cache_read.page_read(cache, rows=rows, page_size=ps)
    torch.cuda.synchronize()
    assert cache_read.page_read.launches == before + 1
    assert torch.equal(out, cache_read.page_read_ref(cache, rows))


def test_page_read_kernel_checks_its_arguments(cuda):
    with pytest.raises(TypeError, match="int8"):
        cache_read.page_read(torch.zeros((2, 128, 256), device=cuda))
    with pytest.raises(ValueError, match="rows"):
        cache_read.page_read(torch.zeros((2, 64, 256), dtype=torch.int8,
                                         device=cuda))
    # a row wider than one block's shared memory
    with pytest.raises(ValueError, match="shared memory"):
        cache_read.page_read(torch.zeros((1, 1, 227 * 1024), dtype=torch.int8,
                                         device=cuda), rows=1, page_size=1)


def _i8i8_operands(dev, d, n, fused, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn(((2, d, n) if fused else (d, n)), generator=g,
                    device=dev) * d ** -0.5
    if fused:
        qs = [quant_ops.quantize_weight(w[c]) for c in range(2)]
        return (torch.stack([q for q, _ in qs]).contiguous(),
                torch.stack([s for _, s in qs]).contiguous(), g)
    wq, ws = quant_ops.quantize_weight(w)
    return wq, ws, g


# Baichuan-13B's K3 weights: wqkv, wo, gate|up (fused), down
K3_13B = [("wqkv", 5120, 15360, False), ("wo", 5120, 5120, False),
          ("gate|up", 5120, 13696, True), ("down", 13696, 5120, False)]


@pytest.mark.parametrize("name,d,n,fused", K3_13B)
@pytest.mark.parametrize("t", [8, 16, 17, 32, 64])
def test_i8i8_kernel_split_k_is_exact_and_repeatable(cuda, name, d, n,
                                                     fused, t):
    """At the 13B widths the decode tile cuts K into pieces, a thread
    block cluster, whose int32 sums meet in the cluster's shared memory:
    equal to the plain version bit for bit in f32 and in bf16, and two
    runs and two replays of one captured CUDA graph give the same bits."""
    wq, ws, g = _i8i8_operands(cuda, d, n, fused, 40)
    splits, _ = qk.plan_split_k(t, d, n, 2 if fused else 1,
                                torch.cuda.get_device_properties(
                                    cuda).multi_processor_count)
    assert splits > 1
    x = torch.randn((t, d), generator=g, device=cuda)
    first = qk.i8i8_matmul(x, wq, ws)
    second = qk.i8i8_matmul(x, wq, ws)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int32), second.view(torch.int32))
    assert torch.equal(first, quant_ops.i8i8_matmul(x, wq, ws))
    xb = x.to(torch.bfloat16)
    ref_bf = quant_ops.i8i8_matmul(xb, wq, ws).to(torch.bfloat16)
    a = qk.i8i8_matmul(xb, wq, ws, out_dtype=torch.bfloat16)
    b = qk.i8i8_matmul(xb, wq, ws, out_dtype=torch.bfloat16)
    torch.cuda.synchronize()
    assert torch.equal(a.view(torch.int16), b.view(torch.int16))
    assert torch.equal(a.view(torch.int16), ref_bf.view(torch.int16))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        c = qk.i8i8_matmul(xb, wq, ws, out_dtype=torch.bfloat16)
    graph.replay()
    torch.cuda.synchronize()
    replayed = c.clone()
    c.zero_()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(replayed.view(torch.int16), ref_bf.view(torch.int16))
    assert torch.equal(c.view(torch.int16), ref_bf.view(torch.int16))


# K2's tensor-core body: MHA at hd 128 (G = 1) and TinyLlama's G = 8 at
# hd 64; Qp = 100 (not a multiple of 64); row 1's start (31) puts the
# cache/fresh boundary inside key chunk 0 and row 2's (70) inside chunk
# 1; row 3 has new_len 0
TC_GEOMS = [(8, 8, 128), (32, 4, 64)]


@pytest.mark.parametrize("alibi", [False, True])
@pytest.mark.parametrize("quant", [False, True])
@pytest.mark.parametrize("hq,kvh,hd", TC_GEOMS)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_prefill_tc_kernel_matches_plain(cuda, dtype, hq, kvh, hd, quant,
                                         alibi):
    ps, qp = 16, 100
    spec = CacheSpec(num_layers=2, num_pages=48, page_size=ps,
                     num_kv_heads=kvh, head_dim=hd,
                     quant_bit=8 if quant else 0,
                     quant_group=8 if quant else 1, dtype=dtype)
    if quant:
        cache, scale = make_int8_cache(spec, cuda, 50)
    else:
        cache, scale = make_cache(spec, cuda, 50), None
    start = torch.tensor([0, 2 * ps - 1, 70, 16], dtype=torch.int32,
                         device=cuda)
    new_len = torch.tensor([100, 64, 30, 0], dtype=torch.int32, device=cuda)
    bp = start.numel()
    rng = np.random.default_rng(51)
    pt = torch.from_numpy(np.stack([rng.choice(48, 12, replace=False)
                                    for _ in range(bp)]).astype(
                                        np.int32)).to(cuda)
    g = torch.Generator(device=cuda).manual_seed(52)
    q = torch.randn((bp, qp, hq, hd), generator=g, device=cuda).to(dtype)
    k = torch.randn((bp, qp, kvh, hd), generator=g, device=cuda)
    v = torch.randn((bp, qp, kvh, hd), generator=g, device=cuda)
    if quant:
        qk8, sk = kv_ops.quantize_kv(k, 8)
        qv8, sv = kv_ops.quantize_kv(v, 8)
        fresh = kv_ops.pack_kv_rows(qk8, qv8, spec)
        fscale = kv_ops.pack_scale_rows(sk, sv, spec).contiguous()
        fk = kv_ops.dequantize_kv(qk8, sk, 8, dtype)
        fv = kv_ops.dequantize_kv(qv8, sv, 8, dtype)
    else:
        fresh = kv_ops.pack_kv_rows(k, v, spec).to(dtype)
        fscale, fk, fv = None, k.to(dtype), v.to(dtype)
    fresh = fresh.permute(0, 2, 1, 3).contiguous()
    slopes = attn_ops.alibi_slopes(hq).to(cuda) if alibi else None
    before = pk.paged_prefill_attention.launches
    out = pk.paged_prefill_attention(q, cache, scale, pt, start, new_len,
                                     spec, layer=1, fresh_kv=fresh,
                                     fresh_scale=fscale, alibi=slopes)
    torch.cuda.synchronize()
    assert pk.paged_prefill_attention.launches == before + 1
    ref = attn_ops.prefill_attention_ref(q, cache, scale, pt, start, new_len,
                                         spec, layer=1, fresh_k=fk,
                                         fresh_v=fv, alibi=slopes)
    tols = ALIBI_TOLS if alibi else TOLS
    torch.testing.assert_close(out.float(), ref.float(), **tols[dtype])
    assert bool((out[3] == 0).all()) and bool((out[1, 64:] == 0).all())


# K1's tensor-core body (bf16 q): (Hq, KVH) for G = 1 and G = 8, at the
# head dims of the GPU tests and of serving
DEC_TC_GROUPS = {1: (4, 4), 8: (16, 2)}
# cached tokens (ctx - 1) 0, 16, 32, 64 (whole pages of 16: split
# boundaries at S = 2), 1 page only (split 1 past it at S = 2), longer
# rows ending mid-page, and a padding row
DEC_TC_CTX = [0, 1, 17, 33, 65, 160, 300, 129]
BF16_TOL = 3e-2          # chip_smoke's bf16 limit; ALiBi adds 2^-7 |ref|


def _decode_tc_case(dev, hd, g, quant, mode, seed=30):
    """Inputs of one K1 call, as keyword arguments for the kernel and the
    plain version: ``mode`` is "deferred", "alibi", "tail" (5 of J = 8
    side-buffer rows live) or "alibi_tail" (7 live)."""
    hq, kvh = DEC_TC_GROUPS[g]
    spec = CacheSpec(num_layers=2, num_pages=40, page_size=16,
                     num_kv_heads=kvh, head_dim=hd,
                     quant_bit=8 if quant else 0,
                     quant_group=8 if quant else 1, dtype=torch.bfloat16)
    if quant:
        cache, scale = make_int8_cache(spec, dev, seed)
    else:
        cache, scale = make_cache(spec, dev, seed), None
    ctx = torch.tensor(DEC_TC_CTX, dtype=torch.int32, device=dev)
    b = ctx.numel()
    rng = np.random.default_rng(seed)
    pt = torch.from_numpy(rng.integers(0, 40, (b, 20)).astype(
        np.int32)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    q = torch.randn((b, hq, hd), generator=gen, device=dev).to(torch.bfloat16)
    fk = torch.randn((b, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    fv = torch.randn((b, kvh, hd), generator=gen, device=dev).to(
        torch.bfloat16)
    kw = dict(layer=1, fresh_k=fk, fresh_v=fv)
    if "alibi" in mode:
        kw["alibi"] = attn_ops.alibi_slopes(hq).to(dev)
    if "tail" in mode:
        tkv, tscale = make_tail(spec, b, 8, dev, seed + 2)
        kw.update(tail_kv=tkv, tail_scale=tscale, tail_len=torch.full(
            (1,), 7 if "alibi" in mode else 5, dtype=torch.int32,
            device=dev))
    return (q, cache, scale, pt, ctx, spec), kw


@pytest.mark.parametrize("splits", [1, 2, None], ids=["S1", "S2", "planned"])
@pytest.mark.parametrize("mode", ["deferred", "alibi", "tail", "alibi_tail"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])
@pytest.mark.parametrize("g", [1, 8])
@pytest.mark.parametrize("hd", [16, 64, 128])
def test_decode_tc_kernel_matches_plain(cuda, hd, g, quant, mode, splits):
    """K1's tensor-core body against the plain version at forced S = 1, 2
    and the planned S, over rows with 0, 1, a split boundary's worth and
    a page's worth of cached tokens; within chip_smoke's bf16 limits."""
    args, kw = _decode_tc_case(cuda, hd, g, quant, mode)
    before = pk.paged_decode_attention.launches
    out = pk.paged_decode_attention(*args, splits=splits, **kw)
    torch.cuda.synchronize()
    assert pk.paged_decode_attention.launches == before + 1
    ctx = args[4]
    ref = attn_ops.decode_attention_ref(*args, **kw)
    ref = torch.where((ctx > 0)[:, None, None], ref, torch.zeros(
        (), dtype=ref.dtype, device=cuda)).float()
    lim = BF16_TOL + (2.0 ** -7 * ref.abs() if "alibi" in mode else 0.0)
    diff = (out.float() - ref).abs()
    assert bool((diff <= lim).all()), float(diff.max())
    assert bool((out[ctx == 0] == 0).all())


@pytest.mark.parametrize("quant", [False, True], ids=["bf16_kv", "int8_kv"])
def test_decode_tc_kernel_is_repeatable_and_graph_safe(cuda, quant):
    """With the context split (S > 1, the last CTA of a row merging the
    partials in split order), two runs give the same bits, and so does a
    CUDA graph replay of the same call."""
    args, kw = _decode_tc_case(cuda, 64, 8, quant, "alibi_tail", seed=40)
    b, kvh = args[0].shape[0], args[5].num_kv_heads
    splits = pk.plan_decode_splits(b, kvh, args[3].shape[1], 132)
    assert splits > 1

    def run():
        return pk.paged_decode_attention(*args, splits=splits, **kw)

    first, second = run(), run()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        replayed = run()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), replayed.view(torch.int16))


def test_decode_tc_kernel_checks_its_group(cuda):
    """The tensor-core body takes at most 16 query heads a kv head and the
    head dims it is built for."""
    spec = CacheSpec(num_layers=1, num_pages=4, page_size=16, num_kv_heads=1,
                     head_dim=16, dtype=torch.bfloat16)
    cache = make_cache(spec, cuda, 0)
    pt = torch.zeros((1, 4), dtype=torch.int32, device=cuda)
    ctx = torch.ones(1, dtype=torch.int32, device=cuda)
    q = torch.zeros((1, 32, 16), dtype=torch.bfloat16, device=cuda)
    f = torch.zeros((1, 1, 16), dtype=torch.bfloat16, device=cuda)
    with pytest.raises(ValueError, match="group 32"):
        pk.paged_decode_attention(q, cache, None, pt, ctx, spec, layer=0,
                                  fresh_k=f, fresh_v=f)
    with pytest.raises(ValueError, match="splits"):
        pk.paged_decode_attention(q[:, :16], cache, None, pt, ctx, spec,
                                  layer=0, fresh_k=f, fresh_v=f, splits=0)


def _split_counts(planned):
    """The microbench's sweep: the planner's piece count, 1, twice it."""
    return sorted({planned, 1, 2 * planned})


@pytest.mark.parametrize("t", [1, 8, 16])
@pytest.mark.parametrize("name,d,n,fused", K3_13B)
def test_i8i8_split_override_agrees_bit_for_bit(cuda, name, d, n, fused, t):
    """K3 at 1, the planner's and twice the planner's pieces of K (the
    ``splits=`` override the microbench sweeps): exact int32 sums, so
    every count gives the plain version's bits."""
    wq, ws, g = _i8i8_operands(cuda, d, n, fused, 42)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    planned, _ = qk.plan_split_k(t, d, n, 2 if fused else 1, sms)
    x = torch.randn((t, d), generator=g, device=cuda)
    ref = quant_ops.i8i8_matmul(x, wq, ws)
    for splits in _split_counts(planned):
        out = qk.i8i8_matmul(x, wq, ws, splits=splits)
        torch.cuda.synchronize()
        assert torch.equal(out, ref), (splits, float((out - ref).abs().max()))


@pytest.mark.parametrize("t", [1, 8, 16])
@pytest.mark.parametrize("name,d,n,fused", K4_7B)
def test_w4a8_split_override_agrees(cuda, name, d, n, fused, t):
    """K4 at 1, the planner's and twice the planner's pieces: each within
    1e-5 of max|ref| of the plain version, and the counts within 3.8e-6
    of each other in f32 (only the order of the pieces' f32 partial sums
    differs)."""
    wp, ws, g = _w4_operands(cuda, d, n, fused, 43)
    sms = torch.cuda.get_device_properties(cuda).multi_processor_count
    planned, _ = qk.plan_split_k_w4(t, d // 2, n, 2 if fused else 1, sms, 64)
    x = torch.randn((t, d), generator=g, device=cuda)
    ref = quant_ops.w4a8_matmul(x, wp, ws)
    outs = [qk.w4a8_matmul(x, wp, ws, splits=s)
            for s in _split_counts(planned)]
    torch.cuda.synchronize()
    for out in outs:
        _w4_check(out, ref, bf16=False)
        assert float((out - outs[0]).abs().max()) <= 3.8e-6
    assert int(qk._COUNTERS[x.device].abs().sum()) == 0
