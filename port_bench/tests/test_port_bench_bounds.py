"""The work and least-time counts on hand-worked shapes."""

import pytest

from port_bench import bounds

W = bounds.Widths(hidden=8, intermediate=16, layers=2, heads=2,
                  kv_heads=2, vocab=10, alibi=False, kv_int8=True)


def test_widths():
    assert W.head_dim == 4
    assert W.matmuls() == [(8, 24), (8, 8), (8, 32), (16, 8)]
    kv8 = bounds.Widths(16, 16, 2, 2, 2, 10, False, True)
    # k|v int8 rows: 2 heads x 2 x 8 bytes; bf16 group-8 scales: 2 heads
    # x 2 x 1 x 2 bytes
    assert kv8.kv_bytes_per_token() == 32 + 8
    assert W.attn_ops_per_key() == 4 * 4 * 2
    alibi = bounds.Widths(8, 16, 2, 2, 2, 10, True, False)
    assert alibi.attn_ops_per_key() == (4 * 4 + 2) * 2
    assert alibi.kv_bytes_per_token() == 2 * 2 * 4 * 2


def test_tri():
    assert bounds.tri(0, 3) == 1 + 2 + 3
    assert bounds.tri(2, 4) == 3 + 4
    assert bounds.tri(5, 5) == 0


def req(n_in, first, chunks, hit=0):
    return dict(n_in=n_in, first=first, chunks=[list(c) for c in chunks],
                hit_est=hit)


def test_count_prefill_and_decode_in_the_sub_window():
    # a request whose prefill and two decode tokens fall inside [1, 2)
    a = req(5, 1.0, [(1.0, 1), (1.5, 2)])
    # one decoding across the edge: 2 tokens before, 3 inside
    b = req(3, 0.2, [(0.2, 1), (0.5, 1), (1.2, 3), (2.5, 1)])
    work = bounds.count([a, b], 1.0, 2.0, hits=0, w=W)
    assert work.prompt_tokens == 5
    assert work.decode_tokens == 2 + 3
    assert work.logit_rows == 1 + 2 + 3
    # a's decode outputs 1, 2 sit at positions 5, 6; b's outputs 2..4 at
    # positions 4..6
    assert work.decode_keys == (6 + 7) + (5 + 6 + 7)
    assert work.prompt_keys == 1 + 2 + 3 + 4 + 5
    # each request received three tokens inside: three steps at least
    assert work.passes == 3


def test_count_takes_the_programs_hits_off_the_prompt_tokens():
    a = req(64, 1.0, [(1.0, 1)], hit=48)
    work = bounds.count([a], 0.0, 2.0, hits=48, w=W)
    assert work.prompt_tokens == 16
    assert work.prompt_keys == bounds.tri(48, 64)


def test_model_ops_and_k3_least_time():
    work = bounds.Work(prompt_tokens=3, decode_tokens=1, logit_rows=2,
                       passes=2, prompt_keys=6, decode_keys=4)
    per_token = 2 * (8 * 24 + 8 * 8 + 8 * 32 + 16 * 8) * 2
    assert bounds.model_ops(work, W) == (
        per_token * 4 + 32 * 2 * 10 + 2 * 8 * 10 * 2)
    weights = (8 * 24 + 4 * 24 + 8 * 8 + 4 * 8 + 8 * 32 + 4 * 32
               + 16 * 8 + 4 * 8) * 2
    act = (2 * 8 + 2 * 24 + 2 * 8 + 2 * 8 + 2 * 8 + 2 * 32 + 2 * 16
           + 2 * 8) * 2
    assert bounds.k3_least_s(work, W) == pytest.approx(max(
        (2 * weights + 4 * act) / bounds.HBM_BYTES_PER_S,
        per_token * 4 / bounds.PEAK_INT8))


def test_least_time_is_the_longer_of_bytes_and_operations():
    assert bounds.bound_s(3.35e12, 0, bounds.PEAK_INT8) == pytest.approx(1.0)
    assert bounds.bound_s(0, 1979e12, bounds.PEAK_INT8) == pytest.approx(1.0)
    assert bounds.bound_s(3.35e12, 2 * 989e12, bounds.PEAK_BF16) == \
        pytest.approx(2.0)
