"""The weights of a configuration worked out again from the run's seed: a
frozen copy of the port's random draw (``models/llama.init_params``:
the embedding, then each layer's matmul weights and biases, then the
lm_head, each ``torch.randn`` in float32 on the device from one
``torch.Generator`` seeded with the seed, scaled and rounded to the
model's dtype) and of its int8 weight quantization
(``ops/quant.quantize_weight``: symmetric per-output-channel absmax).
The copies take nothing from the program; the reference holds every
weight dequantized to float32.
"""

from __future__ import annotations

from typing import Dict, Iterator, Tuple

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _scale_and_inverse(absmax: torch.Tensor
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    scale = torch.div(absmax, torch.full_like(absmax, 127.0))
    inv = torch.div(torch.ones_like(scale), torch.clamp(scale, min=1e-10))
    return scale, torch.where(scale > 0, inv, torch.zeros_like(inv))


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """``w`` [D, ...out] quantized per output channel along D, returned
    dequantized in float32."""
    w32 = w.to(torch.float32)
    scale, inv = _scale_and_inverse(w32.abs().amax(dim=0))
    q = torch.clamp(torch.round(w32 * inv.unsqueeze(0)), -127, 127)
    return q * scale.unsqueeze(0)


def int8_rows(x: torch.Tensor) -> torch.Tensor:
    """Per-token (last-axis) symmetric int8 activation quantization,
    returned dequantized in float32."""
    x32 = x.to(torch.float32)
    scale, inv = _scale_and_inverse(x32.abs().amax(dim=-1))
    q = torch.clamp(torch.round(x32 * inv[:, None]), -127, 127)
    return q * scale[:, None]


def int8_kv(x: torch.Tensor, group: int) -> torch.Tensor:
    """Symmetric per-group int8 KV quantization along the last axis (the
    f32 scale rounds the values, its bf16 rounding is stored and
    dequantizes them), returned dequantized in float32."""
    shape = x.shape
    g = x.reshape(*shape[:-1], shape[-1] // group, group).to(torch.float32)
    absmax = g.abs().amax(dim=-1)
    scale = torch.div(absmax, torch.full_like(absmax, 127.0))
    inv = torch.div(torch.ones_like(scale), torch.clamp(scale, min=1e-8))
    inv = torch.where(scale > 0, inv, torch.zeros_like(inv))
    q = torch.clamp(torch.round(g * inv[..., None]), -127, 127)
    stored = scale.to(torch.bfloat16).to(torch.float32)
    return (q * stored[..., None]).reshape(shape)


class Draw:
    """The seed's weights in the program's order: :meth:`embedding`, then
    :meth:`layers` (each layer's float weights, as the model's dtype
    holds them), then :meth:`lm_head`."""

    def __init__(self, cfg: Dict, seed: int, device):
        self.cfg = cfg
        self.device = torch.device(device)
        self.dtype = DTYPES[cfg["dtype"]]
        self.gen = torch.Generator(device=self.device)
        self.gen.manual_seed(int(seed))

    def w(self, shape, scale: float) -> torch.Tensor:
        x = torch.randn(shape, generator=self.gen, device=self.device,
                        dtype=torch.float32)
        return (x * scale).to(self.dtype)

    def embedding(self) -> torch.Tensor:
        c = self.cfg
        return self.w((c["vocab_size"], c["hidden_dim"]), 1.0)

    def layers(self) -> Iterator[Dict[str, torch.Tensor]]:
        c = self.cfg
        d, n_q = c["hidden_dim"], c["num_heads"]
        n_kv = c.get("num_kv_heads", n_q)
        hd, inter = d // n_q, c["intermediate_dim"]
        g = n_q // n_kv
        s = d ** -0.5
        for _ in range(c["num_layers"]):
            lp = {"wqkv": self.w((d, n_kv, g + 2, hd), s),
                  "wo": self.w((n_q * hd, d), (n_q * hd) ** -0.5),
                  "w_gate_up": self.w((d, 2, inter), s),
                  "w_down": self.w((inter, d), inter ** -0.5)}
            if c.get("attn_bias"):
                lp["bqkv"] = self.w((n_kv, g + 2, hd), 0.02)
                lp["bo"] = self.w((d,), 0.02)
            yield lp

    def lm_head(self) -> torch.Tensor:
        c = self.cfg
        return self.w((c["hidden_dim"], c["vocab_size"]),
                      c["hidden_dim"] ** -0.5)
