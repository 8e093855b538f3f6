"""The client-side arithmetic: due-time timing, misses, rates."""

import math

import pytest

from port_bench import stats


def rec(due, send, first, finish, n_out, phase="window", failed=False,
        chunks=()):
    return dict(due=due, send=send, first=first, finish=finish,
                n_out=n_out, phase=phase, failed=failed,
                chunks=[list(c) for c in chunks])


def test_ttft_is_timed_from_due_not_from_send():
    r = rec(due=10.0, send=10.5, first=10.7, finish=11.7, n_out=11)
    assert stats.ttft_ms(r) == pytest.approx(700.0)
    assert stats.tpot_ms(r) == pytest.approx(100.0)


def test_failed_and_unfinished_requests_are_misses():
    ok = rec(0.0, 0.0, 0.1, 1.0, 10)
    failed = rec(0.0, 0.0, 0.1, 0.5, 3, failed=True)
    unfinished = rec(0.0, 0.0, 0.1, None, 4)
    for r in (failed, unfinished):
        assert math.isinf(stats.ttft_ms(r))
        assert math.isinf(stats.tpot_ms(r))
    assert stats.ttft_ms(ok) == pytest.approx(100.0)


def test_a_miss_sits_above_every_value_in_a_percentile():
    values = [float(i) for i in range(1, 20)] + [math.inf]
    assert stats.percentile(values, 50) == 10.0
    assert stats.percentile(values, 95) == 19.0
    assert stats.tail_ms(values, 96) == stats.MISS_MS
    # two misses of twenty: the 95th percentile is a miss
    assert stats.tail_ms(values[:-2] + [math.inf, math.inf], 95) == \
        stats.MISS_MS


def test_nearest_rank_percentile():
    assert stats.percentile([3.0, 1.0, 2.0, 4.0], 50) == 2.0
    assert stats.percentile([3.0, 1.0, 2.0, 4.0], 75) == 3.0
    assert stats.percentile([5.0], 95) == 5.0
    with pytest.raises(ValueError):
        stats.percentile([], 50)


def test_rate_counts_the_tokens_streamed_inside_the_window():
    rs = [rec(0, 0, 1.0, 3.0, 6, chunks=[(1.0, 2), (2.0, 2), (3.0, 2)]),
          rec(0, 0, 0.5, 2.5, 4, phase="drain",
              chunks=[(0.5, 1), (2.5, 3)])]
    assert stats.tokens_between(rs, 1.0, 3.0) == 2 + 2 + 3


def test_lateness_and_window_selection():
    rs = [rec(1.0, 1.002, 1.1, 2.0, 5), rec(1.0, 1.5, 1.6, 2.0, 5,
                                             phase="warmup")]
    assert [r["phase"] for r in stats.in_window(rs)] == ["window"]
    assert stats.lateness_ms(rs) == pytest.approx(2.0)
