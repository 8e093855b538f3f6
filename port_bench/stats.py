"""The client-side arithmetic of the end-to-end metrics: a corrected copy
of the port's ``tools/client_qps_measure.py`` (``summarize``, ``pct``).

Corrected: each request is timed from when it was due, not from its
actual send (so a late sender's wait counts); a request that failed or
had not finished by the drain limit is a miss, which sits above every
finite value in a percentile (it reads ``MISS_MS``) and is counted in
``failed``; percentiles are nearest-rank over all requests due in the
window, never over the finished ones alone.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

# a miss in a percentile: larger than any time a run can measure
MISS_MS = 1e9


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile: the smallest value with at least q % of
    ``values`` at or below it (misses are ``math.inf``)."""
    vals = sorted(values)
    if not vals:
        raise ValueError("percentile of no values")
    k = max(1, math.ceil(q / 100.0 * len(vals)))
    return vals[k - 1]


def finished(r: Dict) -> bool:
    return not r["failed"] and r["finish"] is not None and r["n_out"] > 0


def ttft_ms(r: Dict) -> float:
    """Due time to first streamed token, ms; a miss is inf."""
    if not finished(r) or r["first"] is None:
        return math.inf
    return (r["first"] - r["due"]) * 1e3


def tpot_ms(r: Dict) -> float:
    """(last token - first token) / (output tokens - 1), ms; a miss is
    inf."""
    if not finished(r) or r["n_out"] < 2:
        return math.inf
    return (r["finish"] - r["first"]) / (r["n_out"] - 1) * 1e3


def in_window(records: List[Dict]) -> List[Dict]:
    return [r for r in records if r["phase"] == "window"]


def tail_ms(values: Sequence[float], q: float) -> float:
    """The percentile, a miss reading ``MISS_MS``."""
    v = percentile(values, q)
    return MISS_MS if math.isinf(v) else v


def tokens_between(records: List[Dict], t0: float, t1: float) -> int:
    """Output tokens streamed to clients in [t0, t1) (every request,
    whatever its phase)."""
    return sum(n for r in records for t, n in r["chunks"] if t0 <= t < t1)


def lateness_ms(records: List[Dict]) -> Optional[float]:
    """How late the sender ran: the largest send - due of the window's
    requests, ms."""
    late = [(r["send"] - r["due"]) * 1e3 for r in in_window(records)
            if r["send"] is not None]
    return max(late) if late else None
