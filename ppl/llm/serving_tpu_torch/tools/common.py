"""Shared CLI wiring for the port's tools (the flag surface of the JAX
package's ``tools/common.py`` minus its JAX and TPU knobs, plus
``--device``), and what the measuring tools read of the card: its name
and power limit (``nvidia-smi``) and its HBM bandwidth by that name."""

from __future__ import annotations

import argparse
import logging
import os
import subprocess
from typing import Tuple

from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)


def parse_tokens_list(text: str):
    """Comma-separated token-id list."""
    if not text:
        return frozenset()
    return frozenset(int(t) for t in text.split(",") if t.strip())


def add_model_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the engine runs: cuda launches the CUDA "
                        "kernels, cpu runs their plain PyTorch versions")
    p.add_argument("--model-dir", default="",
                   help="HF checkpoint dir: config.json, *.safetensors "
                        "and tokenizer.model or tokenizer.json")
    p.add_argument("--model-param-path", default="",
                   help="exporter params.json (reference-compatible); "
                        "defaults to <model-dir>/config.json as HF config")
    p.add_argument("--model-format", default="hf", choices=["hf", "random"],
                   help="hf: load the safetensors of --model-dir; random: "
                        "weights drawn from a seed")
    p.add_argument("--model-type", default="llama")
    p.add_argument("--tokenizer-path", default="")
    p.add_argument("--tokenizer-type", default=None,
                   choices=[None, "hf", "sentencepiece", "dummy"])
    p.add_argument("--dtype", default="bfloat16",
                   choices=["bfloat16", "float32"])
    p.add_argument("--quant-method", default="none",
                   choices=["none", "online_i8i8", "online_w4a8"],
                   help="online_i8i8: int8 weights and per-token int8 "
                        "activations; online_w4a8: group-64 int4 weights "
                        "and per-token int8 activations")
    p.add_argument("--quantize-lm-head", action="store_true",
                   help="also quantize the lm_head matmul")
    p.add_argument("--cache-quant-bit", type=int, default=None,
                   choices=[0, 8],
                   help="override the KV cache format: 8 = int8 with "
                        "group-8 scales, 0 = the model dtype")
    p.add_argument("--page-size", type=int, default=128)
    p.add_argument("--cache-mode", type=int, default=1, choices=[0, 1])
    p.add_argument("--tensor-parallel-size", type=int, default=1,
                   help="ranks of one tensor-parallel group, one process "
                        "and one card each (llm_server starts them)")
    p.add_argument("--max-tokens-scale", type=float, default=0.94)
    p.add_argument("--kv-cache-max-tokens", type=int, default=0,
                   help="override auto KV pool sizing")
    p.add_argument("--multi-step", type=int, default=8,
                   help="decode-block size: N decode steps per host round "
                        "trip, one CUDA graph per block on the card (1 = "
                        "per-step loop)")
    p.add_argument("--tokenizer-config-path", default="",
                   help="tokenizer_config.json for bos/eos overrides")
    p.add_argument("--sampling-top-k-cap", type=int, default=256,
                   help="candidate cap for top-k/top-p sampling (0 = "
                        "full vocab sort)")
    p.add_argument("--token-buckets", default="",
                   help="comma-separated prefill token-count buckets")
    p.add_argument("--batch-buckets", default="",
                   help="comma-separated decode batch buckets")
    p.add_argument("--block-tail", default="auto",
                   choices=["auto", "on", "off"],
                   help="on: one KV-cache write per multi-step block, the "
                        "block's own K/V read by the decode kernel's tail "
                        "phase; auto/off: a write after every step")


def add_generator_args(p: argparse.ArgumentParser) -> None:
    p.add_argument("--top-p", type=float, default=0.0)
    p.add_argument("--top-k", type=int, default=1)
    p.add_argument("--max-running-batch", type=int, default=1024)
    p.add_argument("--max-prefill-batch", type=int, default=64)
    p.add_argument("--max-tokens-per-step", type=int, default=8192)
    p.add_argument("--max-input-tokens-per-request", type=int, default=4096)
    p.add_argument("--max-output-tokens-per-request", type=int, default=4096)
    p.add_argument("--max-total-tokens-per-request", type=int, default=8192)
    p.add_argument("--max-cooldown-request", type=int, default=2)
    p.add_argument("--stop-tokens", default="",
                   help="comma-separated global stop token ids")
    p.add_argument("--special-tokens", default="",
                   help="comma-separated special token ids")
    p.add_argument("--enable-prefix-cache", action="store_true")
    p.add_argument("--enable-penalty", action="store_true")
    p.add_argument("--enable-profiling", action="store_true")
    p.add_argument("--prefill-chunk-tokens", type=int, default=0,
                   help="feed long prompts in chunks of at most N tokens "
                        "per step (0 = whole prompt in one step)")
    p.add_argument("--profile-step-interval", type=int, default=100)
    p.add_argument("--prefill-admission-cadence", type=int, default=1,
                   help="N (default 1): after a prefill-carrying step, run "
                        "N pure-decode blocks before admitting more "
                        "prefills; 0: admit every step")
    p.add_argument("--speculative-blocks", type=int, default=1,
                   help="decode-block pipeline depth (0 disables "
                        "speculative block dispatch)")
    p.add_argument("--trace-dir", default="",
                   help="capture a torch.profiler trace of generator "
                        "steps 10..20 (run must reach step 20)")
    p.add_argument("--disable-log-req", action="store_true",
                   help="no log line a request (the data-parallel "
                        "replicas of tensor-parallel groups log each task "
                        "they take and each cancel)")


def build_configs(args):
    """flags -> (ModelConfig, ResourceConfig, GeneratorConfig), with the
    reference's cross-flag rule (prefix cache => max_prefill_batch=1)."""
    if args.model_param_path:
        model_cfg = ModelConfig.from_params_json(args.model_param_path)
        model_cfg.dtype = args.dtype
    else:
        cfg_json = os.path.join(args.model_dir, "config.json")
        if not os.path.exists(cfg_json):
            raise SystemExit("need --model-param-path or a --model-dir "
                             "with config.json")
        model_cfg = ModelConfig.from_hf_config(
            cfg_json, dtype=args.dtype, cache_mode=args.cache_mode,
            page_size=args.page_size)
    if args.cache_quant_bit is not None:
        model_cfg.cache_quant_bit = args.cache_quant_bit
        model_cfg.cache_quant_group = 8 if args.cache_quant_bit == 8 else 1

    resource_cfg = ResourceConfig(
        model_format=args.model_format,
        model_dir=args.model_dir,
        tokenizer_path=args.tokenizer_path or args.model_dir,
        device=args.device,
        tensor_parallel_size=args.tensor_parallel_size,
        max_tokens_scale=args.max_tokens_scale,
        kv_cache_max_tokens=args.kv_cache_max_tokens,
        enable_penalty=args.enable_penalty,
        quant_method=args.quant_method,
        quantize_lm_head=args.quantize_lm_head,
        multi_step=args.multi_step,
        block_tail=args.block_tail,
        sampling_top_k_cap=args.sampling_top_k_cap,
    )
    if args.token_buckets:
        resource_cfg.token_buckets = tuple(
            int(t) for t in args.token_buckets.split(",") if t.strip())
    if args.batch_buckets:
        resource_cfg.batch_buckets = tuple(
            int(t) for t in args.batch_buckets.split(",") if t.strip())
    max_prefill = 1 if args.enable_prefix_cache else args.max_prefill_batch
    gen_cfg = GeneratorConfig(
        top_p=args.top_p,
        profile_step_interval=args.profile_step_interval,
        top_k=args.top_k,
        enable_penalty=args.enable_penalty,
        max_running_batch=args.max_running_batch,
        max_prefill_batch=max_prefill,
        max_tokens_per_step=args.max_tokens_per_step,
        max_input_tokens_per_request=args.max_input_tokens_per_request,
        max_output_tokens_per_request=args.max_output_tokens_per_request,
        max_total_tokens_per_request=args.max_total_tokens_per_request,
        max_cooldown_request=args.max_cooldown_request,
        stop_tokens=parse_tokens_list(args.stop_tokens),
        special_tokens=parse_tokens_list(args.special_tokens),
        enable_prefix_cache=args.enable_prefix_cache,
        enable_profiling=args.enable_profiling,
        prefill_chunk_tokens=args.prefill_chunk_tokens,
        speculative_blocks=args.speculative_blocks,
        prefill_admission_cadence=args.prefill_admission_cadence,
        trace_dir=args.trace_dir,
    )
    return model_cfg, resource_cfg, gen_cfg


def setup_logging(verbose: bool = True) -> None:
    logging.basicConfig(
        level=logging.INFO if verbose else logging.WARNING,
        format="%(asctime)s %(name)s %(levelname)s %(message)s")


# HBM bandwidth by the card's name as nvidia-smi and
# torch.cuda.get_device_name give it (NVIDIA's data sheet: H100 SXM)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}


def hbm_bytes_per_s(card: str) -> float:
    """The HBM bandwidth of ``card``; raises for a card not on record
    (no guessed default)."""
    if card not in HBM_BYTES_PER_S:
        raise ValueError(f"no HBM bandwidth on record for the card {card!r} "
                         f"(known: {sorted(HBM_BYTES_PER_S)})")
    return HBM_BYTES_PER_S[card]


def card_name_and_limit(index: int = 0) -> Tuple[str, str]:
    """``(name, power limit)`` of GPU ``index`` as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` prints them
    (``"NVIDIA H100 80GB HBM3", "700.00 W"``)."""
    out = subprocess.run(
        ["nvidia-smi", "-i", str(index), "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    name, _, limit = out.stdout.strip().splitlines()[0].rpartition(",")
    return name.strip(), limit.strip()
