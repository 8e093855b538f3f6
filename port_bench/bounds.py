"""The work a traced sub-window needed, and the least time the card could
do it in: the operations and bytes that the data needs at the data
sheet's peaks, as ``chip_smoke.py``'s kernel table bounds them
(``bound``, ``kv_bytes_per_token``, the i8i8 and prefill-attention
byte and operation counts), copied here so that the program cannot move
them.

The work is counted from the traffic, the program's token counters and
the model's published widths, never from the program's plans or padding:

- prompt tokens computed in the sub-window are the prompt tokens of the
  requests whose first token came in it, less the prefix-cache hits the
  program counted in it; each computed prompt token sits at its
  position, the cached prefix (as the traffic implies it) before it;
- decode tokens are the output tokens streamed in it past each
  request's first; a decode token at position p attends to p + 1 keys;
- a decode step reads every matmul weight once: the sub-window needed at
  least as many weight passes as the most tokens one request received
  in it (each needs the one before it);
- each input byte is read once and each output byte written once.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List

HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
PEAK_BF16 = 989e12            # dense tensor-core bf16 FLOP/s
PEAK_INT8 = 1979e12           # dense tensor-core int8 OP/s


def bound_s(bytes_moved: float, ops: float, peak_ops: float) -> float:
    """The least seconds: bytes at the HBM bandwidth or operations at the
    peak, whichever is longer."""
    return max(bytes_moved / HBM_BYTES_PER_S, ops / peak_ops)


@dataclasses.dataclass
class Widths:
    hidden: int
    intermediate: int
    layers: int
    heads: int
    kv_heads: int
    vocab: int
    alibi: bool
    kv_int8: bool

    @classmethod
    def of(cls, cfg: Dict) -> "Widths":
        return cls(cfg["hidden_dim"], cfg["intermediate_dim"],
                   cfg["num_layers"], cfg["num_heads"],
                   cfg.get("num_kv_heads", cfg["num_heads"]),
                   cfg["vocab_size"],
                   cfg.get("position_encoding") == "alibi",
                   cfg["cache_quant_bit"] == 8)

    @property
    def head_dim(self) -> int:
        return self.hidden // self.heads

    def matmuls(self) -> List:
        """(D, N) of each quantized matmul of a layer: wqkv, wo, gate|up,
        down."""
        d, i, hd = self.hidden, self.intermediate, self.head_dim
        return [(d, (self.heads + 2 * self.kv_heads) * hd),
                (self.heads * hd, d), (d, 2 * i), (i, d)]

    def kv_bytes_per_token(self) -> int:
        """One cached token of one layer: its k|v rows and, under int8
        KV, their bf16 group-8 scales."""
        b = self.kv_heads * 2 * self.head_dim * (1 if self.kv_int8 else 2)
        if self.kv_int8:
            b += self.kv_heads * 2 * (self.head_dim // 8) * 2
        return b

    def attn_ops_per_key(self) -> int:
        return (4 * self.head_dim + (2 if self.alibi else 0)) * self.heads


def tri(a: int, b: int) -> int:
    """Sum of (p + 1) for p in [a, b): the keys of positions a..b-1."""
    return (b * (b + 1) - a * (a + 1)) // 2


@dataclasses.dataclass
class Work:
    prompt_tokens: int = 0       # computed prompt tokens
    decode_tokens: int = 0
    logit_rows: int = 0          # tokens the lm_head produced
    passes: int = 0              # least weight passes
    prompt_keys: int = 0         # sum over computed prompt tokens of keys
    decode_keys: int = 0
    k2_least_s: float = 0.0      # prefill attention, request by request

    def tokens(self) -> int:
        return self.prompt_tokens + self.decode_tokens


def count(requests: List[Dict], t0: float, t1: float, hits: int,
          w: Widths) -> Work:
    """The work of the sub-window [t0, t1) (see the module docstring);
    ``hits`` is the program's prefix-cache hit count over it."""
    work = Work()
    raw_prompt = 0
    for r in requests:
        inside = [(t, n) for t, n in r["chunks"] if t0 <= t < t1]
        got = sum(n for _, n in inside)
        if not got:
            continue
        work.passes = max(work.passes, got)
        first_here = r["first"] is not None and t0 <= r["first"] < t1
        n_in = r["n_in"]
        if first_here:
            raw_prompt += n_in
            work.logit_rows += 1
            h = min(r["hit_est"], n_in - 1)
            work.prompt_keys += tri(h, n_in)
            work.k2_least_s += w.layers * bound_s(
                2 * (n_in - h) * w.heads * w.head_dim * 2
                + n_in * w.kv_bytes_per_token(),
                w.attn_ops_per_key() * tri(h, n_in), PEAK_BF16)
        # decode tokens: this request's outputs in the window after its
        # first; output j (0-based) is produced at position n_in + j - 1
        before = sum(n for t, n in r["chunks"] if t < t0)
        j0 = max(before, 1)
        j1 = before + got
        if j1 > j0:
            work.decode_tokens += j1 - j0
            work.logit_rows += j1 - j0
            work.decode_keys += tri(n_in + j0 - 1, n_in + j1 - 1)
    work.prompt_tokens = max(0, raw_prompt - hits)
    return work


def model_ops(work: Work, w: Widths) -> float:
    """The useful operations of the work: the matmuls, attention and the
    lm_head."""
    per_token = 2 * sum(d * n for d, n in w.matmuls()) * w.layers
    attn = w.attn_ops_per_key() * w.layers * (work.prompt_keys
                                              + work.decode_keys)
    return (per_token * work.tokens() + attn
            + 2 * w.hidden * w.vocab * work.logit_rows)


def k3_least_s(work: Work, w: Widths) -> float:
    """K3 (the four quantized matmuls, their per-token quantize pass
    included): int8 weights and f32 scales once a pass, bf16 activations
    in and out once a token, at the int8 peak."""
    weights = sum(d * n + 4 * n for d, n in w.matmuls()) * w.layers
    act = sum(2 * d + 2 * n for d, n in w.matmuls()) * w.layers
    ops = 2 * sum(d * n for d, n in w.matmuls()) * w.layers * work.tokens()
    return bound_s(work.passes * weights + act * work.tokens(), ops,
                   PEAK_INT8)
