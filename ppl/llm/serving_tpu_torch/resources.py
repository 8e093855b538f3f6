"""Resource wiring: weights -> device, KV pool sizing, engine creation.

Same order as the JAX package's ``resources.py`` (and the reference's
``resource_manager.cc:329-362``): make the weights (each layer quantized
as it is drawn), measure free device memory, size the KV pool from what
is left. An auto-sized pool on cuda is sized after the CUDA graphs: a
provisional engine with one request's pages validates the bucket grid
first, and what its graphs and their warm-up took is held back from the
pool.

Under tensor parallelism each rank's process calls :func:`create_engine`
with its group: it draws (or reads) the weights and keeps its shard, and
the ranks agree on the KV pool's size (the least any rank can hold) and,
through the engine, on the bucket grid.
"""

from __future__ import annotations

import gc
import logging
from typing import Optional, Tuple

import torch

from .config import ConfigError, GeneratorConfig, ModelConfig, ResourceConfig
from .engine import LLMEngine, compute_kv_cache_max_tokens
from .models import llama, loader
from .ops.kv_cache import CacheSpec
from .parallel import shardings

logger = logging.getLogger("ppl.llm.serving_tpu_torch.resources")


def require_device(name: str) -> torch.device:
    """``name`` as a device; raises when it is cuda and PyTorch sees no
    such GPU: nothing of the port carries on on the CPU unasked."""
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' asked for but torch.cuda.is_available() is "
            "false; pass device='cpu' (--device cpu) to run on the CPU")
    if device.type == "cuda" and (device.index or 0) >= \
            torch.cuda.device_count():
        raise RuntimeError(f"device {device} asked for but PyTorch sees "
                           f"{torch.cuda.device_count()} GPU(s)")
    return device


def kv_pool_tokens(model_cfg: ModelConfig, resource_cfg: ResourceConfig,
                   free_bytes: int, reserved_bytes: int = 0) -> int:
    """The KV pool's tokens as :func:`create_engine` serves them:
    :func:`compute_kv_cache_max_tokens` rounded down to whole pages (at
    least one)."""
    tokens = compute_kv_cache_max_tokens(model_cfg, resource_cfg, free_bytes,
                                         reserved_bytes)
    page = model_cfg.page_size if model_cfg.cache_mode == 1 else 1
    return max(page, tokens // page * page)


def create_engine(model_cfg: ModelConfig, resource_cfg: ResourceConfig,
                  gen_cfg: GeneratorConfig, rng_seed: int = 0,
                  validate_grid=None,
                  tp: Optional[shardings.TPGroup] = None
                  ) -> Tuple[LLMEngine, int, int]:
    """Build the engine on ``resource_cfg.device``; returns (engine,
    kv_cache_max_tokens, max_running_batch). Raises when the device is
    "cuda" and PyTorch sees no GPU: the engine never carries on on the
    CPU unasked.

    ``validate_grid`` (default: when the pool is auto-sized on cuda) runs
    :meth:`LLMEngine.validate_bucket_grid` with ``gen_cfg``'s limits
    before serving; ``max_running_batch`` is then its clamp, for the
    caller to put into ``gen_cfg``, else ``gen_cfg.max_running_batch``.
    An auto-sized pool on cuda is validated twice: on a provisional
    engine with one request's pages, whose peak memory above the weights
    (the shared graph pool and the largest eager warm-up) is held back
    from the pool and becomes the real engine's graph budget, then on the
    real engine, so that no capture runs after the pool is sized except
    those that validation makes.

    ``tp``: this rank's group when ``resource_cfg.tensor_parallel_size``
    > 1 (required then: one process a rank, see ``tools/llm_server``).
    The rank keeps its shard of each layer as it is made and quantized,
    and the pool is the least that every rank can hold."""
    model_cfg.validate()
    resource_cfg.validate()
    tp_size = resource_cfg.tensor_parallel_size
    if (tp.size if tp is not None else 1) != tp_size:
        raise ConfigError(
            f"tensor parallelism (tensor_parallel_size {tp_size}) needs one "
            f"process a rank in a group of {tp_size} (llm_server "
            f"--tensor-parallel-size {tp_size} starts them); this process "
            f"has {'no group' if tp is None else f'a group of {tp.size}'}")
    if tp is not None:
        shardings.validate_tp(model_cfg, tp.size)
    device = require_device(resource_cfg.device)
    auto = not resource_cfg.kv_cache_max_tokens
    cuda = device.type == "cuda"
    if validate_grid is None:
        validate_grid = auto and cuda

    # each layer quantized as it is drawn: one float layer alive at a time
    free_before = build_peak = None
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        free_before, _ = torch.cuda.mem_get_info(device)
        allocated0 = torch.cuda.memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    params = loader.load_params(model_cfg, resource_cfg.model_format,
                                resource_cfg.model_dir, seed=rng_seed,
                                device=device,
                                quant_method=resource_cfg.quant_method,
                                quantize_lm_head=resource_cfg.quantize_lm_head,
                                shard=None if tp is None else (tp.rank,
                                                               tp.size))
    if cuda:
        build_peak = torch.cuda.max_memory_allocated(device) - allocated0

    def build(kv_tokens: int, graph_budget_bytes: int = 0) -> LLMEngine:
        page = model_cfg.page_size
        spec = CacheSpec(
            num_layers=model_cfg.num_layers,
            num_pages=kv_tokens // page if model_cfg.cache_mode == 1
            else -(-kv_tokens // page),
            page_size=page,
            num_kv_heads=model_cfg.num_kv_heads,
            head_dim=model_cfg.head_dim,
            quant_bit=model_cfg.cache_quant_bit,
            quant_group=model_cfg.cache_quant_group,
            dtype=llama.torch_dtype(model_cfg.dtype),
        )
        return LLMEngine(
            model_cfg, resource_cfg, params, spec,
            enable_penalty=resource_cfg.enable_penalty,
            max_batch_slots=gen_cfg.max_running_batch,
            device=device, rng_seed=rng_seed,
            graph_budget_bytes=graph_budget_bytes, tp=tp)

    def validate(engine: LLMEngine, max_running_batch: int) -> int:
        return engine.validate_bucket_grid(
            gen_cfg.max_total_tokens_per_request, max_running_batch,
            gen_cfg.max_tokens_per_step, gen_cfg)

    free = reserved = 0
    if cuda:
        torch.cuda.synchronize(device)
        torch.cuda.empty_cache()
        free, _ = torch.cuda.mem_get_info(device)
    max_running_batch = gen_cfg.max_running_batch
    buckets = None
    if validate_grid and auto and cuda:
        page = model_cfg.page_size
        probe = build(-(-gen_cfg.max_total_tokens_per_request // page)
                      * page)
        max_running_batch = validate(probe, max_running_batch)
        reserved = probe.validation_peak_bytes
        graph_bytes = probe.graph_stats()["pool_bytes"]
        buckets = probe.batch_buckets
        del probe
        gc.collect()
        torch.cuda.empty_cache()
        logger.info("bucket grid on a provisional engine: buckets %s, "
                    "max_running_batch %d, CUDA graphs %d MiB, peak %d "
                    "MiB above the weights with their warm-up",
                    buckets, max_running_batch, graph_bytes >> 20,
                    reserved >> 20)
    kv_cache_max_tokens = kv_pool_tokens(model_cfg, resource_cfg, free,
                                         reserved)
    if tp is not None:
        kv_cache_max_tokens = tp.agree_min(kv_cache_max_tokens)
    logger.info("kv_cache_max_tokens = %d (free bytes %d after the weights, "
                "%d of them held back for the CUDA graphs and their "
                "warm-up)", kv_cache_max_tokens, free, reserved)
    engine = build(kv_cache_max_tokens, reserved)
    # the weight build's own peak allocation and the free device memory
    # around it (cuda only; None on the CPU)
    engine.weight_build_peak_bytes = build_peak
    engine.free_before_weights_bytes = free_before
    engine.free_after_weights_bytes = free if cuda else None
    if buckets is not None:
        engine.batch_buckets = buckets
    if validate_grid:
        max_running_batch = validate(engine, max_running_batch)
        graphs = engine.graph_stats()
        logger.info("bucket grid validated before serving: batch buckets "
                    "%s, max_running_batch %d, max_prefill_rows %s, %d "
                    "CUDA graphs (%d MiB pool), KV pool %d tokens",
                    engine.batch_buckets, max_running_batch,
                    engine.max_prefill_rows, graphs["graphs"],
                    graphs["pool_bytes"] >> 20, kv_cache_max_tokens)
    return engine, kv_cache_max_tokens, max_running_batch
