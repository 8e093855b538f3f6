"""On-device sampling and penalties (PyTorch).

Mirrors ``serving_tpu/ops/sampling.py``: per-row temperature, top-k and
top-p with logprob output, repetition/presence/frequency penalties backed
by a persistent token-count map, and the greedy fast path.

Two differences of mechanism, none of semantics:

- the exact top-``cap`` candidates come from ``torch.topk`` (sorted
  descending) where the JAX package uses ``approx_max_k`` at recall 1.0;
- the Gumbel noise is an INPUT (:func:`gumbel_noise` draws it from a
  ``torch.Generator``), so tests can hand the sampler JAX's own draws.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

_NEG_INF = -1e30


class SamplingParams(NamedTuple):
    """Per-row sampling parameters, all shaped [B]."""

    temperature: torch.Tensor        # f32; <=0 treated as 1.0
    top_k: torch.Tensor              # i32; 0 = disabled (full vocab)
    top_p: torch.Tensor              # f32; 0 = disabled
    do_sample: torch.Tensor          # bool; False = greedy argmax
    repetition_penalty: torch.Tensor  # f32; 1.0 = off
    presence_penalty: torch.Tensor   # f32; 0.0 = off
    frequency_penalty: torch.Tensor  # f32; 0.0 = off


def init_count_map(num_slots: int, vocab_size: int, device) -> torch.Tensor:
    """Persistent token-count map [num_slots + 1, vocab]; the extra row
    is the trash slot for padding rows."""
    return torch.zeros((num_slots + 1, vocab_size), dtype=torch.int32,
                       device=device)


def update_count_map(count_map: torch.Tensor, tokens: torch.Tensor,
                     slots: torch.Tensor) -> torch.Tensor:
    """Scatter-add token occurrences in place: tokens i32[T], slots
    i32[T] (padding tokens carry the trash slot). One ``index_add_`` on
    the flat map: no host synchronisation, so it records into a CUDA
    graph."""
    flat = slots.long() * count_map.shape[1] + tokens.long()
    count_map.view(-1).index_add_(
        0, flat, torch.ones_like(tokens, dtype=count_map.dtype))
    return count_map


def clear_count_slots(count_map: torch.Tensor,
                      slots: torch.Tensor) -> torch.Tensor:
    """Zero freed batch slots in place (slot reuse across requests)."""
    count_map[slots.long()] = 0
    return count_map


def apply_penalties(logits: torch.Tensor, count_map: torch.Tensor,
                    batch_slots: torch.Tensor,
                    params: SamplingParams) -> torch.Tensor:
    """repetition: logit /= p if logit > 0 else logit *= p, for seen
    tokens; presence: logit -= p for seen tokens; frequency: logit -=
    p * count."""
    counts = count_map[batch_slots.long()].to(torch.float32)   # [B, V]
    seen = counts > 0
    rep = params.repetition_penalty[:, None]
    logits = torch.where(seen, torch.where(logits > 0, logits / rep,
                                           logits * rep), logits)
    logits = torch.where(seen, logits - params.presence_penalty[:, None],
                         logits)
    return logits - params.frequency_penalty[:, None] * counts


def gumbel_noise(shape, generator: torch.Generator, device) -> torch.Tensor:
    """Standard Gumbel draws -log(-log(u)), u uniform in [tiny, 1), as
    ``jax.random.gumbel`` forms them."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=device,
                   dtype=torch.float32)
    u = u * (1.0 - tiny) + tiny
    return -torch.log(-torch.log(u))


def sample_top_k_top_p(
    logits: torch.Tensor,            # f32[B, V]
    params: SamplingParams,
    gumbel: Optional[torch.Tensor],  # f32[B, C] noise, C = cap or V
    top_k_cap: int = 0,
    greedy_only: bool = False,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Temperature -> top-k -> top-p -> categorical sample (or greedy).

    Returns (tokens i32[B], logprobs f32[B]); logprob is the
    post-temperature log-softmax at the chosen token over the full vocab.
    ``greedy_only`` is the fast path for steps where no row samples
    (``gumbel`` may then be None): argmax + logsumexp only.
    """
    b, v = logits.shape
    temp = torch.where(params.temperature > 0, params.temperature,
                       torch.ones((), device=logits.device))
    scaled = logits.to(torch.float32) / temp[:, None]

    if greedy_only:
        tokens = torch.argmax(scaled, dim=-1)
        arg_val = torch.gather(scaled, 1, tokens[:, None])[:, 0]
        lse = torch.logsumexp(scaled, dim=-1)
        return tokens.to(torch.int32), arg_val - lse

    lse = torch.logsumexp(scaled, dim=-1, keepdim=True)
    if top_k_cap and top_k_cap < v:
        cand_logits, cand_idx = torch.topk(scaled, top_k_cap, dim=-1,
                                           largest=True, sorted=True)
        c = top_k_cap
    else:
        cand_logits, cand_idx = torch.sort(scaled, dim=-1, descending=True,
                                           stable=True)
        c = v
    cand_logprobs = cand_logits - lse

    rank = torch.arange(c, device=logits.device)[None, :]
    k_eff = torch.where(params.top_k > 0, params.top_k,
                        torch.full((), v, device=logits.device))[:, None]
    k_mask = rank < k_eff

    cand_probs = torch.exp(cand_logprobs)
    # exclusive cumsum: keep tokens while the mass before them < top_p,
    # which always keeps the top token
    cum_before = torch.cumsum(cand_probs, dim=-1) - cand_probs
    p_eff = torch.where(params.top_p > 0, params.top_p,
                        torch.ones((), device=logits.device))[:, None]
    p_mask = cum_before < p_eff

    allowed = k_mask & p_mask
    masked = torch.where(allowed, cand_logits,
                         torch.full((), _NEG_INF, device=logits.device))
    noise = torch.where(params.do_sample[:, None], gumbel,
                        torch.zeros((), device=logits.device))
    masked_logprobs = torch.log_softmax(masked, dim=-1)
    choice = torch.argmax(masked_logprobs + noise, dim=-1)
    tokens = torch.gather(cand_idx, 1, choice[:, None])[:, 0]
    logprob = torch.gather(cand_logprobs, 1, choice[:, None])[:, 0]
    return tokens.to(torch.int32), logprob
