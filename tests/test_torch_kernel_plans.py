"""Host-side pieces of the port's kernels that run without a card: K3's
and K4's split-K planners, K4's x16 nibble unpack and rescale identity
(in numpy), K1's context-split plan, K5's chunk plan, the build's cache
key (sources and shared headers) and the SASS instruction counter that
``chip_smoke.py`` reads."""

import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
from ppl.llm.serving_tpu_torch.ops.kernels import _build
from ppl.llm.serving_tpu_torch.ops.kernels import cache_read
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as pk
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as qk

# (D, N, C) of the i8i8 weights the serving paths run: Baichuan-13B,
# LLaMA-2-7B / InternLM-7B and TinyLlama wqkv / wo / gate|up / down, an
# odd small shape and a weight thinner than one column tile
SHAPES = [(5120, 15360, 1), (5120, 5120, 1), (5120, 13696, 2),
          (13696, 5120, 1), (4096, 12288, 1), (4096, 4096, 1),
          (4096, 11008, 2), (11008, 4096, 1), (2048, 2560, 1),
          (2048, 2048, 1), (2048, 5632, 2), (5632, 2048, 1),
          (260, 196, 1), (260, 196, 2), (128, 64, 1)]


@pytest.mark.parametrize("d,n,c", SHAPES)
@pytest.mark.parametrize("t", [1, 8, 16, 17, 32, 64])
@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_split_k_pieces_cover_k(d, n, c, t, num_sms):
    """Up to 64 tokens the decode tile (256-column CTAs) cuts K into whole
    stages, none empty, at most one cluster of MAX_PIECES (the portable
    cluster size); its CTAs reach DECODE_CTAS_PER_SM a SM unless K's
    stages or the cluster cap them, with the fewest pieces that do. A
    weight without whole 16-byte rows (N % 16 > 0) runs whole on the
    prefill tile."""
    splits, kchunk = qk.plan_split_k(t, d, n, c, num_sms)
    if n % 16:
        assert qk.k3_tile(t, n) == "prefill"
        assert (splits, kchunk) == (1, -(-d // qk.K_STAGE) * qk.K_STAGE)
        return
    assert qk.k3_tile(t, n) == "decode"
    assert 1 <= splits <= qk.MAX_PIECES <= 8
    assert kchunk > 0 and kchunk % qk.K_STAGE == 0
    pieces = [(i * kchunk, min(d, (i + 1) * kchunk)) for i in range(splits)]
    assert pieces[0][0] == 0 and pieces[-1][1] == d
    assert all(lo < hi for lo, hi in pieces)               # none empty
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    tiles = c * -(-n // qk.DECODE_TILE_N)
    stages = -(-d // qk.K_STAGE)
    target = qk.DECODE_CTAS_PER_SM * num_sms
    assert tiles * splits >= min(target, tiles * min(stages, qk.MAX_PIECES))
    if splits > 1:                  # one piece fewer would miss the aim
        assert tiles * (splits - 1) < target
    # an explicit count is held to the cluster
    assert qk.plan_split_k(t, d, n, c, num_sms, splits=64)[0] <= 8


@pytest.mark.parametrize("t", [65, 100, 1024, 4096])
def test_prefill_sizes_run_whole(t):
    assert qk.plan_split_k(t, 5120, 13696, 2, 132) == (1, 5120)
    assert qk.plan_split_k(t, 260, 196, 1, 132) == (1, 320)


@pytest.mark.parametrize("t,tile", [(1, "decode"), (16, "decode"),
                                    (17, "decode"), (64, "decode"),
                                    (65, "prefill"), (4096, "prefill")])
def test_k3_tile_by_tokens(t, tile):
    assert qk.k3_tile(t, 5120) == tile
    assert qk.k3_tile(t, 196) == "prefill"       # no whole 16-byte rows


def test_split_k_at_13b_widths():
    """The 13B down matmul (70 MB of weight, 20 column tiles of 256) is
    cut into 7 pieces, enough for a CTA on each of an H100's 132 SMs;
    gate|up (2 x 54 column tiles) into 2."""
    assert qk.plan_split_k(8, 13696, 5120, 1, 132) == (7, 1984)
    assert qk.plan_split_k(8, 5120, 13696, 2, 132) == (2, 2560)


def test_split_k_at_13b_widths_t64():
    """The 64-row decode bucket at 13B widths (132 SMs): wqkv (60 column
    tiles of 256) in 3 pieces, wo and down (20 each) in 7, gate|up (2 x
    54) in 2: the fewest that give each SM a CTA, each cut as evenly as
    whole stages of 64 rows allow; the plan reads T only for the tile."""
    plans = [qk.plan_split_k(64, d, n, c, 132) for d, n, c in SHAPES[:4]]
    assert plans == [(3, 1728), (7, 768), (2, 2560), (7, 1984)]
    assert [qk.plan_split_k(t, d, n, c, 132) for t in (1, 17, 32)
            for d, n, c in SHAPES[:4]] == plans * 3


def test_k16_order_matches_the_transposed_fragments():
    """The decode tile's k order: the transposed ldmatrix of two 8-row
    matrices and one byte_perm give lane tig the k-word (2*tig, 2*tig+1,
    8+2*tig, 9+2*tig) of a column; the quantize pass stores value k of a
    16-byte group at byte dc_k16_offset(k), so word tig of the group (the
    lane's B fragment) holds the same k in the same byte order, and the
    order is a permutation of the group."""
    def k16_offset(k):          # dc_k16_offset in csrc/quant_matmul.cu
        return 4 * (k >> 1) + (k & 1) if k < 8 else \
            4 * ((k - 8) >> 1) + 2 + (k & 1)
    assert sorted(k16_offset(k) for k in range(16)) == list(range(16))
    stored = [None] * 16
    for k in range(16):
        stored[k16_offset(k)] = k
    for tig in range(4):
        # ldmatrix.trans: matrix rows 2*tig, 2*tig+1 (k) of the block's
        # first (rows 0..7) and second (rows 8..15) matrix, b16 elements
        # (byte pairs of one row); byte_perm selectors 0x6420 / 0x7531
        m0 = [(2 * tig, 0), (2 * tig, 1), (2 * tig + 1, 0), (2 * tig + 1, 1)]
        m1 = [(8 + k, col) for k, col in m0]
        for sel, col in ((0x6420, 0), (0x7531, 1)):
            both = m0 + m1
            word = [both[(sel >> (4 * i)) & 0xF] for i in range(4)]
            assert all(c == col for _, c in word)
            assert [k for k, _ in word] == stored[4 * tig:4 * tig + 4]


# (D, N, C) of K4's LLaMA-2-7B weights: wqkv, wo, gate|up, down, lm_head;
# a small odd shape and one thinner than a column tile
W4_SHAPES = [(4096, 12288, 1), (4096, 4096, 1), (4096, 11008, 2),
             (11008, 4096, 1), (4096, 32000, 1), (704, 196, 1), (256, 64, 2)]


@pytest.mark.parametrize("d,n,c,group", [
    (d, n, c, group) for d, n, c in W4_SHAPES for group in (16, 32, 64, 128)
    if (d // 2) % group == 0])
@pytest.mark.parametrize("t", [1, 8, 16])
@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_split_k_w4_pieces_are_whole_groups(d, n, c, group, t, num_sms):
    d2 = d // 2
    splits, kchunk = qk.plan_split_k_w4(t, d2, n, c, num_sms, group)
    ksp = max(group, qk.W4_STAGE)
    assert splits >= 1 and kchunk > 0 and kchunk % ksp == 0
    assert kchunk % group == 0                             # whole groups
    pieces = [(i * kchunk, min(d2, (i + 1) * kchunk)) for i in range(splits)]
    assert pieces[0][0] == 0 and pieces[-1][1] == d2
    assert all(lo < hi for lo, hi in pieces)               # none empty
    assert all(hi % group == 0 for _, hi in pieces)
    assert all(a[1] == b[0] for a, b in zip(pieces, pieces[1:]))
    tiles = c * -(-n // qk.TILE_N)
    stages = -(-d2 // ksp)
    assert tiles * splits >= min(qk.CTAS_PER_SM * num_sms, tiles * stages)


@pytest.mark.parametrize("t", [17, 100, 1024, 4096])
def test_split_k_w4_prefill_sizes_run_whole(t):
    assert qk.plan_split_k_w4(t, 2048, 11008, 2, 132, 64) == (1, 2048)
    assert qk.plan_split_k_w4(t, 352, 196, 1, 132, 32) == (1, 384)


def test_split_k_w4_at_7b_widths():
    """The 7B pieces at 132 SMs (group 64, stages of 64 packed rows): wo
    and down (32 column tiles each) are cut most."""
    plans = [qk.plan_split_k_w4(8, d // 2, n, c, 132, 64)
             for d, n, c in W4_SHAPES[:5]]
    assert plans == [(4, 640), (11, 192), (2, 1024), (10, 576), (2, 1024)]


def _sign_nibble(v):
    return v - ((v & 8) << 1)


def test_w4_nibbles_times_16_are_exact():
    """K4's unpack: for every packed byte, ``(b << 4) & 0xF0`` and ``b &
    0xF0`` read as int8 are exactly 16x the low and the high nibble's
    signed value, the plain version's ``unpack_int4`` pairing."""
    b = np.arange(256, dtype=np.int32)
    word = (b * 0x01010101).astype(np.uint32)                # four lanes
    lo16 = (word << 4) & 0xF0F0F0F0
    hi16 = word & 0xF0F0F0F0
    for lane in range(4):
        lo = ((lo16 >> (8 * lane)) & 0xFF).astype(np.uint8).view(np.int8)
        hi = ((hi16 >> (8 * lane)) & 0xFF).astype(np.uint8).view(np.int8)
        np.testing.assert_array_equal(lo, 16 * _sign_nibble(b & 0xF))
        np.testing.assert_array_equal(hi, 16 * _sign_nibble(b >> 4))
    packed = torch.from_numpy(b.astype(np.uint8).view(np.int8).copy())
    un = quant_ops.unpack_int4(packed[:, None])[:, 0].numpy().astype(np.int32)
    np.testing.assert_array_equal(16 * un[:256], lo.astype(np.int32))
    np.testing.assert_array_equal(16 * un[256:], hi.astype(np.int32))


def test_w4_rescale_by_16_is_exact():
    """K4 sums 16·p per group (|16 p| < 2^21, so its f32 conversion is
    exact) and keeps a running sum 16x the true one: the scaled group sum
    and the running sum are 16x the plain ones bit for bit (as they are
    through the kernel's fused multiply-add: scaling by 16 commutes with
    one rounding as with two), and the end's multiply by 1/16 gives the
    plain value back."""
    rng = np.random.default_rng(0)
    f32 = np.float32
    p = rng.integers(-128 * 7 * 127, 128 * 7 * 127 + 1, 200_000)
    p = np.concatenate([p, [0, 1, -1, 128 * 8 * 127, -128 * 8 * 127]])
    p16 = (16 * p).astype(np.int32)
    assert int(np.abs(p16).max()) < 2 ** 21
    np.testing.assert_array_equal(p16.astype(f32).astype(np.int64), 16 * p)
    s = (rng.random(p.size) * 1e-2).astype(f32)
    acc = (rng.standard_normal(p.size) * 1e3).astype(f32)
    part = p.astype(f32) * s
    part16 = p16.astype(f32) * s
    np.testing.assert_array_equal(part16, f32(16) * part)
    np.testing.assert_array_equal(f32(16) * acc + part16,
                                  f32(16) * (acc + part))
    np.testing.assert_array_equal((f32(16) * (acc + part)) * f32(0.0625),
                                  acc + part)


# (B, KVH) of K1's served grids: TinyLlama (4 kv heads) at B=8 and 64,
# LLaMA-2-7B / InternLM-7B (32) and Baichuan-13B (40) at B=8 and 16, the
# GPU tests' small grids
DECODE_GRIDS = [(8, 4), (64, 4), (8, 32), (16, 32), (8, 40), (16, 40),
                (1, 1), (3, 2), (2, 1)]


@pytest.mark.parametrize("b,kvh", DECODE_GRIDS)
@pytest.mark.parametrize("p", [1, 4, 64])        # page-table width, pages
@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_decode_splits_cover_the_table_in_whole_pages(b, kvh, p, num_sms):
    s = pk.plan_decode_splits(b, kvh, p, num_sms)
    assert 1 <= s <= p
    if b * kvh >= num_sms:
        assert s == 1                                 # the grid fills the card
    else:
        assert b * kvh * s >= min(pk.CTAS_PER_SM * num_sms, b * kvh * p)
    for n_pages in sorted({p, p // 2, 1, 0}):
        ranges = [pk.split_pages(n_pages, s, z) for z in range(s)]
        assert ranges[0][0] == 0 and ranges[-1][1] == n_pages
        assert all(lo <= hi for lo, hi in ranges)
        assert all(a[1] == b_[0] for a, b_ in zip(ranges, ranges[1:]))
        # every non-empty split the same whole number of pages, but the last
        sizes = [hi - lo for lo, hi in ranges if hi > lo]
        assert len(set(sizes[:-1])) <= 1 and sizes[-1:] <= sizes[:1]


def test_decode_splits_at_served_sizes():
    """TinyLlama's B=8 grid (32 CTAs) is split for about two CTAs a SM of
    an H100; the 7B and 13B grids at B=8 fill the card unsplit."""
    assert pk.plan_decode_splits(8, 4, 64, 132) == 9
    assert pk.plan_decode_splits(8, 32, 64, 132) == 1
    assert pk.plan_decode_splits(8, 40, 64, 132) == 1
    assert pk.plan_decode_splits(64, 4, 64, 132) == 1
    # a 433-token row in 128-token pages: 4 pages, one a split, 5 empty
    assert [pk.split_pages(4, 9, z) for z in range(9)] == (
        [(0, 1), (1, 2), (2, 3), (3, 4)] + [(4, 4)] * 5)


@pytest.mark.parametrize("kvh,ps,r", [(32, 128, 256), (4, 128, 256),
                                      (40, 128, 256), (1100, 16, 32),
                                      (1, 16, 32), (2, 1024, 256),
                                      (1, 128, 4096), (2000, 1024, 256)])
@pytest.mark.parametrize("num_sms", [132, 114, 8])
def test_page_read_chunks_cover_the_page(kvh, ps, r, num_sms):
    """K5's chunks: whole rows covering the page in order, none empty,
    each within one block's shared memory (less the barrier); the
    smallest chunks whose CTAs stay within CTAS_PER_SM a SM, unless one
    chunk a head or the shared memory needs more."""
    chunk_rows, n = cache_read.plan_page_read(kvh, ps, r, num_sms)
    chunks = [(i * chunk_rows, min(ps, (i + 1) * chunk_rows))
              for i in range(n)]
    assert chunks[0][0] == 0 and chunks[-1][1] == ps
    assert all(lo < hi for lo, hi in chunks)
    assert all(a[1] == b[0] for a, b in zip(chunks, chunks[1:]))
    assert chunk_rows * r <= cache_read._SMEM_MAX
    assert cache_read._SMEM_MAX + 16 == 227 * 1024
    # the chunks memory forces, and the most that the SMs hold at
    # CTAS_PER_SM each
    fits = -(-ps // (cache_read._SMEM_MAX // r))
    target = min(ps, max(1, cache_read.CTAS_PER_SM * num_sms // kvh, fits))
    assert n <= target and chunk_rows == -(-ps // target)


def test_page_read_plan_at_the_microbench_geometry():
    """The 7B microbench page (32 heads, 128 rows of 256 bytes) on an
    H100 goes as 32 chunks of 4 rows (1 kB) a head: 1,024 CTAs, 8 a SM,
    not 32; Baichuan-13B's 40 heads give a page that is no whole number
    of chunks (25 of 5 rows, a last of 3); with 8 heads a SM or more,
    one chunk a head."""
    assert cache_read.CTAS_PER_SM == 8
    assert cache_read.plan_page_read(32, 128, 256, 132) == (4, 32)
    assert cache_read.plan_page_read(40, 128, 256, 132) == (5, 26)
    assert 26 * 5 - 128 == 2                    # the last chunk: 3 rows
    assert cache_read.plan_page_read(1056, 128, 256, 132) == (128, 1)
    assert cache_read.plan_page_read(1100, 16, 32, 132) == (16, 1)
    # a 256 kB page needs two chunks whatever the SMs
    assert cache_read.plan_page_read(2000, 1024, 256, 132) == (512, 2)


def _src_tree(tmp_path, monkeypatch):
    src = tmp_path / "csrc"
    src.mkdir()
    monkeypatch.setattr(_build, "SRC_DIR", src)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (src / "k.cu").write_text('#include "ptx.cuh"\n__global__ void f() {}\n')
    (src / "ptx.cuh").write_text("#pragma once\n")
    return src


def test_library_path_hashes_shared_headers(tmp_path, monkeypatch):
    """An edited, added or renamed header changes the library's name, so
    a stale build is never loaded."""
    src = _src_tree(tmp_path, monkeypatch)
    seen = [_build.library_path("k")]
    assert _build.library_path("k") == seen[0]           # stable
    (src / "ptx.cuh").write_text("#pragma once\n// edited\n")
    seen.append(_build.library_path("k"))
    (src / "more.cuh").write_text("#pragma once\n")
    seen.append(_build.library_path("k"))
    (src / "more.cuh").rename(src / "other.cuh")
    seen.append(_build.library_path("k"))
    (src / "k.cu").write_text("__global__ void g() {}\n")
    seen.append(_build.library_path("k"))
    assert len(set(seen)) == len(seen)
    assert all(p.parent == tmp_path / "build" and p.name.startswith("libk_")
               for p in seen)


def test_library_path_ignores_other_sources(tmp_path, monkeypatch):
    src = _src_tree(tmp_path, monkeypatch)
    before = _build.library_path("k")
    (src / "other.cu").write_text("__global__ void h() {}\n")
    assert _build.library_path("k") == before


SASS = """
\tcode for sm_90a
\t\tFunction : _ZN12_GLOBAL__N_119i8i8_decode_kernelILi1ELi16EfEEvPKaiPKf
\t.headerflags\t@"EF_CUDA_SM90 EF_CUDA_VIRTUAL_SM(EF_CUDA_SM90)"
        /*0000*/                   LDC R1, c[0x0][0x28] ;                     /* 0x00000a00ff017b82 */
        /*0010*/                   IMMA.16832.S8.S8 R24, R12.ROW, R28.COL, R24 ;  /* 0x0000001c0c18723c */
        /*0020*/              @!P0 IMMA.16832.S8.S8 R20, R8.ROW, R28.COL, R20 ;  /* 0x0000001c0814723c */
        /*0030*/                   PRMT R3, R4, 0x5140, R5 ;                  /* 0x0000514004037816 */
\t\t..........
\t\tFunction : _ZN12_GLOBAL__N_123paged_prefill_tc_kernelIaLi128EEEvPK13__nv_bfloat16
        /*0000*/                   HMMA.16816.F32.BF16 R4, R8, R12, R4 ;      /* 0x0000000c0804723c */
        /*0010*/               @P1 HMMA.16816.F32.BF16 R16, R8, R14, R16 ;    /* 0x0000000e0810723c */
        /*0020*/                   IMMAX R0, R1 ;                             /* 0x0000000001007210 */
        /*0030*/                   EXIT ;                                     /* 0x000000000000794d */
		..........
		Function : _ZN12_GLOBAL__N_116page_read_kernelEPKaPfxiiiii
        /*0000*/                   UBLKCP.S.G [UR8], [UR4], UR6 ;             /* 0x00000008040073ba */
        /*0010*/              @!UP0 UBLKCP.S.G [UR8], [UR4], UR6 ;            /* 0x00000008040073ba */
        /*0020*/                   SYNCS.PHASECHK.TRANS64.TRYWAIT P0, [UR8], R3 ;  /* 0x00000003ff0075a7 */
"""


def test_parse_sass_counts():
    counts = _build.parse_sass_counts(SASS, ("IMMA", "HMMA", "UBLKCP"))
    k5, dec, tc = sorted(counts)
    assert "i8i8_decode_kernel" in dec and "paged_prefill_tc_kernel" in tc
    assert "page_read_kernel" in k5
    assert counts[dec] == {"IMMA": 2, "HMMA": 0, "UBLKCP": 0}
    assert counts[tc] == {"IMMA": 0, "HMMA": 2, "UBLKCP": 0}
    assert counts[k5] == {"IMMA": 0, "HMMA": 0, "UBLKCP": 2}


def test_mma_ceiling_needs_a_card():
    from ppl.llm.serving_tpu_torch.tools import mma_ceiling
    with pytest.raises(ValueError, match="CUDA device"):
        mma_ceiling.run(device="cpu")
    assert {name for name, _, _ in mma_ceiling.SHAPES} == {
        "IMMA m16n8k32 s8", "HMMA m16n8k16 bf16"}
