"""The one traffic generator: turns a traffic file's parameters and a seed
into the requests a run sends.

A traffic file (``port_bench/traffic/<name>.json``) is data only:

- ``loop``: ``"open"`` (arrivals on a schedule, Poisson gaps at
  ``rate_per_s`` requests or sessions a second) or ``"closed"``
  (``clients`` callers, each sending its next request when the last one
  finished);
- ``prompt`` / ``output``: length distributions, ``{"dist": "lognormal",
  "median", "sigma", "min", "max"}`` or ``{"dist": "uniform", "min",
  "max"}`` in tokens;
- ``sessions`` (open loop only): multi-turn chats over shared system
  prompts: ``system_prompts``, ``system_tokens``, ``zipf_s``,
  ``turns_min`` / ``turns_max``, ``think_mean_s``; each turn resends the
  system prompt and the whole history with the streamed answers, and a
  session ends when its next turn would pass ``context``;
- ``warmup_s``, ``drain_s``, ``trace_offset_s``, ``trace_seconds``,
  ``sample_min_served``, ``sample_max_requests``.

Every seed gets the same work: the lengths, gaps, think times and turn
counts are quantiles of their distributions (stratified, so a window
always holds its tail), paired and grouped the same for every seed, and
the seed only shuffles their order and draws the token ids. The phases
(warm-up, window, drain) draw from pools of their own, so the window's
multiset of sizes depends on its length alone.
"""

from __future__ import annotations

import dataclasses
import math
import random
import statistics
from typing import Dict, List, Optional

_NORMAL = statistics.NormalDist()
PHASES = ("warmup", "window", "drain")


def quantiles(n: int) -> List[float]:
    """The n mid-point probabilities (i + 0.5) / n."""
    return [(i + 0.5) / n for i in range(n)]


def length_at(spec: Dict, u: float) -> int:
    """The length at probability ``u`` of a length distribution."""
    lo, hi = int(spec["min"]), int(spec["max"])
    if spec["dist"] == "lognormal":
        x = float(spec["median"]) * math.exp(float(spec["sigma"])
                                              * _NORMAL.inv_cdf(u))
    elif spec["dist"] == "uniform":
        x = lo + u * (hi - lo)
    else:
        raise ValueError(f"unknown length distribution {spec['dist']!r}")
    return min(hi, max(lo, int(round(x))))


def lengths(spec: Dict, n: int, rng: random.Random) -> List[int]:
    """n stratified lengths in an order drawn from ``rng``."""
    out = [length_at(spec, u) for u in quantiles(n)]
    rng.shuffle(out)
    return out


def gaps(n: int, seconds: float, rng: random.Random) -> List[float]:
    """n exponential inter-arrival gaps (stratified quantiles), scaled so
    that they sum to ``seconds``, in an order drawn from ``rng``."""
    if n == 0:
        return []
    g = [-math.log(1.0 - u) for u in quantiles(n)]
    total = sum(g)
    g = [x * seconds / total for x in g]
    rng.shuffle(g)
    return g


def zipf_counts(n: int, k: int, s: float) -> List[int]:
    """n items dealt over k ranks in proportion to 1 / rank^s (largest
    remainder)."""
    w = [1.0 / (r + 1) ** s for r in range(k)]
    exact = [n * x / sum(w) for x in w]
    counts = [int(e) for e in exact]
    for i in sorted(range(k), key=lambda i: counts[i] - exact[i])[
            :n - sum(counts)]:
        counts[i] += 1
    return counts


@dataclasses.dataclass
class Job:
    """One request (or, for sessions, one session) of a phase: due at
    ``offset`` seconds after its phase starts (open loop)."""

    phase: str
    offset: float
    prompt: List[int] = dataclasses.field(default_factory=list)
    max_new: int = 0
    # sessions: the system prompt's index and each turn's (user ids,
    # answer length, think time after it in seconds)
    system: int = -1
    turns: List = dataclasses.field(default_factory=list)


class Plan:
    """What a run sends, phase by phase, from ``traffic`` and ``seed``;
    ``seconds`` is the window's length and ``vocab`` bounds the ids."""

    def __init__(self, traffic: Dict, seed: int, seconds: float,
                 vocab: int, warmup_s: Optional[float] = None,
                 rate_per_s: Optional[float] = None):
        self.traffic = traffic
        self.seed = seed
        self.vocab = vocab
        self.loop = traffic["loop"]
        self.rate = float(rate_per_s if rate_per_s is not None
                          else traffic.get("rate_per_s", 0.0))
        self.durations = {
            "warmup": float(traffic["warmup_s"] if warmup_s is None
                            else warmup_s),
            "window": float(seconds),
            "drain": float(traffic["drain_s"])}
        self._ids = random.Random(f"{seed}/ids")
        sess = traffic.get("sessions")
        self.system_prompts = ([self.ids(sess["system_tokens"])
                                for _ in range(sess["system_prompts"])]
                               if sess else [])
        self.jobs = {p: self._phase(p) for p in PHASES}

    def ids(self, n: int) -> List[int]:
        return [self._ids.randrange(1, self.vocab) for _ in range(n)]

    def _phase(self, phase: str) -> List[Job]:
        t = self.traffic
        # the sizes and their pairing come from a generator of the phase
        # alone; the seed shuffles their order and the arrival gaps
        base = random.Random(f"sizes/{phase}")
        rng = random.Random(f"{self.seed}/{phase}")
        if self.loop == "closed":
            # a pool the clients draw from in turn, cycled if exhausted
            n = int(t["pool"])
            sizes = list(zip(lengths(t["prompt"], n, base),
                             lengths(t["output"], n, base)))
            rng.shuffle(sizes)
            return [Job(phase, 0.0, self.ids(p), o) for p, o in sizes]
        seconds = self.durations[phase]
        n = int(round(self.rate * seconds))
        due = 0.0
        offsets = []
        for g in gaps(n, seconds, rng):
            offsets.append(due)
            due += g
        sess = t.get("sessions")
        if not sess:
            sizes = list(zip(lengths(t["prompt"], n, base),
                             lengths(t["output"], n, base)))
            rng.shuffle(sizes)
            return [Job(phase, off, self.ids(p), o)
                    for off, (p, o) in zip(offsets, sizes)]
        systems = [i for i, c in enumerate(zipf_counts(
            n, sess["system_prompts"], sess["zipf_s"])) for _ in range(c)]
        base.shuffle(systems)
        lo, hi = sess["turns_min"], sess["turns_max"]
        n_turns = [lo + min(hi - lo, int(u * (hi - lo + 1)))
                   for u in quantiles(n)]
        base.shuffle(n_turns)
        total = sum(n_turns)
        users = lengths(t["prompt"], total, base)
        answers = lengths(t["output"], total, base)
        thinks = [-math.log(1.0 - u) * float(sess["think_mean_s"])
                  for u in quantiles(total)]
        base.shuffle(thinks)
        sessions, k = [], 0
        for system, nt in zip(systems, n_turns):
            sessions.append((system, [(users[k + i], answers[k + i],
                                       thinks[k + i]) for i in range(nt)]))
            k += nt
        rng.shuffle(sessions)
        return [Job(phase, off, system=system,
                    turns=[(self.ids(u), a, th) for u, a, th in turns])
                for off, (system, turns) in zip(offsets, sessions)]
