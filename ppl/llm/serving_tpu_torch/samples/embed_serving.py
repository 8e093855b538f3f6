"""Library-embedding example: drive the port's serving engine from
Python, no gRPC involved (the counterpart of the repository's
``samples/embed_serving.py``).

    python -m ppl.llm.serving_tpu_torch.samples.embed_serving \\
        [model_dir] [--device cpu]

``model_dir`` is an HF checkpoint directory (``config.json``, the
safetensors, the tokenizer); without one, a tiny random demo model with
a byte tokenizer. The engine runs on ``cuda`` unless ``--device cpu``.
One request of 16 greedy tokens is served through ``create_engine``,
``LLMGenerator`` and ``LocalConnection``, and its text printed.
"""

from __future__ import annotations

import argparse
import os
from typing import Optional, Sequence

from ..config import GeneratorConfig, ModelConfig, ResourceConfig
from ..connection import LocalConnection
from ..generator import LLMGenerator
from ..request import Request
from ..resources import create_engine
from ..tokenizer import create_tokenizer
from ..tokenizer.factory import ByteTokenizer

PROMPT = "Hello, GPU serving!"
GENERATION_LEN = 16
# the tiny random demo model and its pool
DEMO_MODEL = dict(hidden_dim=64, intermediate_dim=128, num_layers=2,
                  num_heads=4, num_kv_heads=2, vocab_size=256, cache_mode=1,
                  page_size=16, dtype="float32")
DEMO_KV_TOKENS = 4096
GEN = dict(max_running_batch=32)


def configs(model_dir: Optional[str], device: str):
    """``(model_cfg, resource_cfg, gen_cfg, tokenizer)`` of a checkpoint
    directory, or of the demo model when there is none."""
    if model_dir:
        model_cfg = ModelConfig.from_hf_config(
            os.path.join(model_dir, "config.json"))
        resource_cfg = ResourceConfig(model_dir=model_dir,
                                      tokenizer_path=model_dir, device=device)
        tokenizer = create_tokenizer("llama", model_dir)
    else:
        model_cfg = ModelConfig(**DEMO_MODEL)
        resource_cfg = ResourceConfig(model_format="random",
                                      kv_cache_max_tokens=DEMO_KV_TOKENS,
                                      device=device)
        tokenizer = ByteTokenizer()
    return model_cfg, resource_cfg, GeneratorConfig(**GEN), tokenizer


def generate(model_cfg, gen_cfg, engine, kv_max, tokenizer,
             prompt: str = PROMPT) -> LocalConnection:
    """Serve request 1 (``prompt``, 16 greedy tokens) on ``engine``; the
    connection holds its tokens and text."""
    conn = LocalConnection()
    generator = LLMGenerator(model_cfg, gen_cfg, engine, tokenizer, conn,
                             kv_max)
    try:
        conn.set_wanted(1)
        generator.process(Request(id=1, prompt=prompt,
                                  generation_length=GENERATION_LEN, top_k=1))
        if not conn.wait(timeout=600):
            raise TimeoutError("request 1 did not finish in 600 s")
    finally:
        generator.shutdown()
    return conn


def main(argv: Optional[Sequence[str]] = None) -> LocalConnection:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("model_dir", nargs="?", default=None,
                   help="HF checkpoint directory (default: the demo model)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    model_cfg, resource_cfg, gen_cfg, tokenizer = configs(args.model_dir,
                                                          args.device)
    engine, kv_max, max_running_batch = create_engine(model_cfg,
                                                      resource_cfg, gen_cfg)
    gen_cfg.max_running_batch = min(gen_cfg.max_running_batch,
                                    max_running_batch)
    conn = generate(model_cfg, gen_cfg, engine, kv_max, tokenizer)
    print("generated:", conn.text(1) or conn.tokens.get(1), flush=True)
    print(f"{len(conn.tokens.get(1, []))} tokens on {resource_cfg.device}",
          flush=True)
    return conn


if __name__ == "__main__":
    main()
