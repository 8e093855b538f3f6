"""Weight loading for the port.

``random`` weights only so far: the repository holds no checkpoint, so
the HF safetensors path of the JAX package's loader waits until weights
are in the repository (ROADMAP.md).
"""

from __future__ import annotations

from typing import Any, Dict

import torch

from ..config import ModelConfig, not_ported
from . import llama


def load_params(cfg: ModelConfig, model_format: str, model_dir: str,
                seed: int = 0, device="cuda", quant_method: str = "none",
                quantize_lm_head: bool = False) -> Dict[str, Any]:
    """Dispatch on ``model_format``; "random" draws the weights on
    ``device`` from a ``torch.Generator`` seeded with ``seed``, each
    layer quantized with ``quant_method`` as soon as it is drawn (and the
    lm_head when ``quantize_lm_head``)."""
    if model_format == "random":
        gen = torch.Generator(device=device)
        gen.manual_seed(seed)
        return llama.init_params(cfg, gen, dtype=llama.torch_dtype(cfg.dtype),
                                 device=device, quantize=quant_method,
                                 quantize_lm_head=quantize_lm_head)
    raise not_ported(f"model_format={model_format!r}")
