"""Configuration objects for the PyTorch/CUDA port.

Same three-layer design as the JAX package's ``config.py`` (and the
reference's ``src/common/config.h:27-85``):

- :class:`ModelConfig` is parsed from the exporter's ``params.json`` with
  the reference's mandatory/optional key behaviour, or converted from a
  HuggingFace ``config.json``.
- :class:`GeneratorConfig` carries scheduler budgets and sampling defaults.
- :class:`ResourceConfig` carries model paths and device knobs, plus the
  ``device`` the engine runs on (``"cuda"`` unless the caller asks for the
  CPU).

The port serves one slice of what the JAX package serves. ``validate``
refuses every option the port has not taken over yet with a
:class:`ConfigError` that says so; no such option silently switches to
another path. TPU-only knobs (AOT store, program-size guard, attention
seq block, the xla/pallas impl names) have no counterpart here: the
kernel wrappers dispatch on the tensor's device.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Sequence


class ConfigError(ValueError):
    pass


def not_ported(what: str) -> ConfigError:
    return ConfigError(f"{what} is not yet ported to serving_tpu_torch")


@dataclasses.dataclass
class ModelConfig:
    """Model architecture + KV cache format (field names follow the
    reference ``ModelConfig`` so the exporter's ``params.json``
    round-trips)."""

    hidden_dim: int = 0
    intermediate_dim: int = 0
    num_layers: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    vocab_size: int = 0

    norm_eps: float = 1e-5
    rope_theta: float = 10000.0
    max_position_embeddings: int = 4096

    # (8, 8) = int8 with one bf16 scale per group of 8 along head_dim;
    # (0, 1) = unquantized (the model dtype)
    cache_quant_bit: int = 0
    cache_quant_group: int = 1

    cache_layout: int = 0  # accepted for params.json compatibility
    cache_mode: int = 1  # 0 = linear slots, 1 = paged
    page_size: int = 128

    dynamic_batching: bool = True
    auto_causal: bool = True

    model_type: str = "llama"
    dtype: str = "bfloat16"
    tie_word_embeddings: bool = False
    # qkv/o projection biases (InternLM-7B)
    attn_bias: bool = False
    # "rope" | "alibi" (Baichuan-13B)
    position_encoding: str = "rope"

    @property
    def head_dim(self) -> int:
        return self.hidden_dim // self.num_heads

    def validate(self) -> None:
        if not self.auto_causal:
            raise ConfigError("only auto_causal=True is supported")
        if self.cache_mode not in (0, 1):
            raise ConfigError(f"invalid cache_mode {self.cache_mode}")
        if (self.cache_quant_bit, self.cache_quant_group) not in ((8, 8), (0, 1)):
            raise ConfigError(
                "(cache_quant_bit, cache_quant_group) must be (8, 8) or (0, 1), "
                f"got ({self.cache_quant_bit}, {self.cache_quant_group})"
            )
        if not self.dynamic_batching:
            raise ConfigError("only dynamic_batching=True is supported")
        if self.num_heads % max(self.num_kv_heads, 1) != 0:
            raise ConfigError("num_heads must be a multiple of num_kv_heads")
        if self.hidden_dim % max(self.num_heads, 1) != 0:
            raise ConfigError("hidden_dim must be divisible by num_heads")
        if self.position_encoding not in ("rope", "alibi"):
            raise ConfigError(
                f"unknown position_encoding {self.position_encoding}")
        if self.dtype not in ("bfloat16", "float32"):
            raise ConfigError(f"unsupported dtype {self.dtype}")

    @classmethod
    def from_params_json(cls, path: str) -> "ModelConfig":
        """Parse an exporter ``params.json``: every key mandatory except
        ``num_kv_heads`` (defaults to ``num_heads``) and ``page_size``
        (mandatory only when ``cache_mode == 1``)."""
        with open(path) as f:
            doc = json.load(f)
        required = [
            "num_heads", "num_layers", "hidden_dim", "intermediate_dim",
            "vocab_size", "cache_quant_bit", "cache_quant_group",
            "cache_layout", "cache_mode", "dynamic_batching", "auto_causal",
        ]
        for key in required:
            if key not in doc:
                raise ConfigError(f"find key [{key}] failed")
        cfg = cls(
            num_heads=int(doc["num_heads"]),
            num_kv_heads=int(doc.get("num_kv_heads", doc["num_heads"])),
            num_layers=int(doc["num_layers"]),
            hidden_dim=int(doc["hidden_dim"]),
            intermediate_dim=int(doc["intermediate_dim"]),
            vocab_size=int(doc["vocab_size"]),
            cache_quant_bit=int(doc["cache_quant_bit"]),
            cache_quant_group=int(doc["cache_quant_group"]),
            cache_layout=int(doc["cache_layout"]),
            cache_mode=int(doc["cache_mode"]),
            dynamic_batching=bool(doc["dynamic_batching"]),
            auto_causal=bool(doc["auto_causal"]),
        )
        if cfg.cache_mode == 1:
            if "page_size" not in doc:
                raise ConfigError("find key [page_size] failed")
            cfg.page_size = int(doc["page_size"])
        for key in ("norm_eps", "rope_theta", "max_position_embeddings",
                    "model_type", "dtype", "tie_word_embeddings",
                    "attn_bias", "position_encoding"):
            if key in doc:
                setattr(cfg, key, doc[key])
        return cfg

    @classmethod
    def from_hf_config(cls, path: str, **overrides) -> "ModelConfig":
        """Build from a HuggingFace ``config.json`` (llama family)."""
        with open(path) as f:
            doc = json.load(f)
        cfg = cls(
            num_heads=int(doc["num_attention_heads"]),
            num_kv_heads=int(doc.get("num_key_value_heads",
                                     doc["num_attention_heads"])),
            num_layers=int(doc["num_hidden_layers"]),
            hidden_dim=int(doc["hidden_size"]),
            intermediate_dim=int(doc["intermediate_size"]),
            vocab_size=int(doc["vocab_size"]),
            norm_eps=float(doc.get("rms_norm_eps", 1e-5)),
            rope_theta=float(doc.get("rope_theta", 10000.0)),
            max_position_embeddings=int(doc.get("max_position_embeddings", 4096)),
            model_type=str(doc.get("model_type", "llama")),
            tie_word_embeddings=bool(doc.get("tie_word_embeddings", False)),
        )
        if cfg.model_type == "internlm":
            cfg.attn_bias = bool(doc.get("bias", False))
        if cfg.model_type == "baichuan":
            pe = str(doc.get("position_embedding", "")).lower()
            if pe in ("alibi", "rope"):
                cfg.position_encoding = pe
            elif cfg.num_layers >= 40:
                cfg.position_encoding = "alibi"
        for key, val in overrides.items():
            setattr(cfg, key, val)
        return cfg


@dataclasses.dataclass
class GeneratorConfig:
    """Scheduler budgets + sampling defaults (same fields and meaning as
    the JAX package's ``GeneratorConfig``)."""

    top_p: float = 0.0
    top_k: int = 1
    enable_penalty: bool = False
    max_running_batch: int = 1024
    max_input_tokens_per_request: int = 4096
    max_output_tokens_per_request: int = 4096
    max_total_tokens_per_request: int = 8192
    max_tokens_per_step: int = 8192
    stop_tokens: frozenset = frozenset()
    special_tokens: frozenset = frozenset()
    max_cooldown_request: int = 2
    enable_prefix_cache: bool = False
    max_prefill_batch: int = 64
    # decode-block pipeline depth: how many further decode blocks may be
    # dispatched ahead with device-fed tokens beyond the one in flight
    # (0 = none), so the host's fetch and bookkeeping of block k overlap
    # the device's block k+1; costs up to depth * multi_step steps of
    # discarded work after a finish
    speculative_blocks: int = 1
    # prefill admission cadence (active with multi-step blocks): after a
    # prefill-carrying step, run N pure-decode blocks before admitting
    # more prefills (0 = admit every step), so saturating arrivals can't
    # pin the engine in single-step mixed steps (generator._admission_gated)
    prefill_admission_cadence: int = 1
    enable_profiling: bool = False
    profile_step_interval: int = 100
    # device tracing: a torch.profiler trace of generator steps
    # [trace_start_step, trace_start_step + trace_num_steps) into trace_dir
    trace_dir: str = ""
    trace_start_step: int = 10
    trace_num_steps: int = 10
    # chunked prefill: feed long prompts in chunks of at most N tokens
    # per step (0 = off); incompatible with the prefix cache
    prefill_chunk_tokens: int = 0

    def validate(self) -> None:
        if self.max_running_batch <= 0:
            raise ConfigError("max_running_batch must be > 0")
        if self.prefill_chunk_tokens < 0:
            raise ConfigError("prefill_chunk_tokens must be >= 0")
        if self.prefill_chunk_tokens == 1:
            raise ConfigError("prefill_chunk_tokens must be 0 or >= 2")
        if (self.prefill_chunk_tokens
                and self.prefill_chunk_tokens > self.max_tokens_per_step):
            raise ConfigError(
                "prefill_chunk_tokens must be <= max_tokens_per_step")
        if self.prefill_chunk_tokens and self.enable_prefix_cache:
            raise ConfigError(
                "prefill_chunk_tokens is incompatible with the prefix "
                "cache (chunked KV fills over several steps)")
        if (self.max_tokens_per_step < self.max_input_tokens_per_request
                and not self.prefill_chunk_tokens):
            raise ConfigError(
                "max_tokens_per_step must be >= max_input_tokens_per_request"
            )


@dataclasses.dataclass
class ResourceConfig:
    """Model location + device resources."""

    # "hf": a HuggingFace safetensors checkpoint in model_dir; "random":
    # weights drawn from a seed (tests and benchmarks)
    model_format: str = "hf"
    model_dir: str = ""
    tokenizer_path: str = ""

    # "cuda" (default), "cuda:N" or "cpu". On cuda every kernel wrapper
    # launches its CUDA kernel; on "cpu" the wrappers run their plain
    # PyTorch versions. create_engine raises when cuda is asked for and
    # that GPU is not present; it never carries on on the CPU.
    device: str = "cuda"

    tensor_parallel_size: int = 1

    # fraction of post-weights device memory given to the KV pool
    max_tokens_scale: float = 0.94
    # explicit total KV tokens; 0 = auto-size from free device memory
    kv_cache_max_tokens: int = 0

    enable_penalty: bool = False

    # "none" | "online_i8i8" (int8 weights) | "online_w4a8" (group-64
    # int4 weights); both quantize activations per token to int8
    quant_method: str = "none"
    quantize_lm_head: bool = False

    # step-shape buckets: token counts and batch sizes are padded up to
    # these boundaries (the host plan logic is shared with the JAX
    # package; eager PyTorch needs no compile per bucket)
    token_buckets: Sequence[int] = (256, 512, 1024, 2048, 4096, 8192)
    batch_buckets: Sequence[int] = (8, 16, 32, 64, 128, 256)

    # top-k/top-p sample from the exact top-cap logits (torch.topk)
    # instead of a full-vocab sort; 0 = full sort
    sampling_top_k_cap: int = 256

    # decode-block size: N decode steps per dispatch and per host round
    # trip, each block one CUDA graph on the card (1 = per-step loop)
    multi_step: int = 8
    # "auto"/"off": blocks write the cache after every step; "on": once
    # per block, the block's own K/V read by K1's tail phase meanwhile
    block_tail: str = "auto"

    def validate(self) -> None:
        kind, colon, index = self.device.partition(":")
        if kind not in ("cuda", "cpu") or (
                colon and (kind != "cuda" or not index.isdigit())):
            raise ConfigError(f"unknown device {self.device}")
        if self.tensor_parallel_size < 1 or (
            self.tensor_parallel_size & (self.tensor_parallel_size - 1)
        ):
            raise ConfigError("tensor_parallel_size must be a power of 2")
        if self.quant_method not in ("none", "online_i8i8",
                                     "online_w4a8"):
            raise ConfigError(f"unknown quant_method {self.quant_method}")
        if (self.quant_method == "online_w4a8"
                and self.tensor_parallel_size > 1):
            # the int4 nibble pairing strides D/2 across the whole
            # contraction axis, so row-parallel shards would unpack to
            # non-contiguous rows (the JAX package's rule)
            raise ConfigError("online_w4a8 currently requires "
                              "tensor_parallel_size == 1")
        if self.tensor_parallel_size > 1:
            raise not_ported("tensor parallelism (tensor_parallel_size>1)")
        if self.block_tail not in ("auto", "on", "off"):
            raise ConfigError(f"unknown block_tail {self.block_tail}")
        if self.block_tail == "on" and self.multi_step > 64:
            # K1's tail phase reads the block's rows as one 64-row chunk
            raise ConfigError("block_tail='on' takes multi_step <= 64")
        if self.model_format not in ("hf", "random"):
            raise ConfigError(f"unknown model_format {self.model_format}")
        if self.quantize_lm_head and self.quant_method == "none":
            raise ConfigError("quantize_lm_head requires quant_method "
                              "online_i8i8 or online_w4a8")
