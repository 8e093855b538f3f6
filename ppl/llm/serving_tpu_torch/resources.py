"""Resource wiring: weights -> device, KV pool sizing, engine creation.

Same order as the JAX package's ``resources.py`` (and the reference's
``resource_manager.cc:329-362``): make the weights, measure free device
memory, size the KV pool from what is left.
"""

from __future__ import annotations

import logging
from typing import Tuple

import torch

from .config import GeneratorConfig, ModelConfig, ResourceConfig
from .engine import LLMEngine, compute_kv_cache_max_tokens
from .models import llama, loader
from .ops.kv_cache import CacheSpec

logger = logging.getLogger("ppl.llm.serving_tpu_torch.resources")


def create_engine(model_cfg: ModelConfig, resource_cfg: ResourceConfig,
                  gen_cfg: GeneratorConfig,
                  rng_seed: int = 0) -> Tuple[LLMEngine, int]:
    """Build the engine on ``resource_cfg.device``; returns (engine,
    kv_cache_max_tokens). Raises when the device is "cuda" and PyTorch
    sees no GPU: the engine never carries on on the CPU unasked."""
    model_cfg.validate()
    resource_cfg.validate()
    device = torch.device(resource_cfg.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' (--device cpu) to run on the CPU")

    params = loader.load_params(model_cfg, resource_cfg.model_format,
                                resource_cfg.model_dir, seed=rng_seed,
                                device=device)
    if resource_cfg.quant_method != "none":
        params = llama.quantize_model_params(
            params, resource_cfg.quant_method, resource_cfg.quantize_lm_head)

    free = 0
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(device)
    kv_cache_max_tokens = compute_kv_cache_max_tokens(
        model_cfg, resource_cfg, free)
    page = model_cfg.page_size if model_cfg.cache_mode == 1 else 1
    kv_cache_max_tokens = max(page, kv_cache_max_tokens // page * page)
    logger.info("kv_cache_max_tokens = %d (free bytes %d)",
                kv_cache_max_tokens, free)

    spec = CacheSpec(
        num_layers=model_cfg.num_layers,
        num_pages=kv_cache_max_tokens // page if model_cfg.cache_mode == 1
        else -(-kv_cache_max_tokens // model_cfg.page_size),
        page_size=model_cfg.page_size,
        num_kv_heads=model_cfg.num_kv_heads,
        head_dim=model_cfg.head_dim,
        quant_bit=model_cfg.cache_quant_bit,
        quant_group=model_cfg.cache_quant_group,
        dtype=llama.torch_dtype(model_cfg.dtype),
    )
    engine = LLMEngine(
        model_cfg, resource_cfg, params, spec,
        enable_penalty=resource_cfg.enable_penalty,
        max_batch_slots=gen_cfg.max_running_batch,
        device=device, rng_seed=rng_seed,
    )
    return engine, kv_cache_max_tokens
