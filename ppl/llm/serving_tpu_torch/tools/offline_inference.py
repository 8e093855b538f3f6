#!/usr/bin/env python3
"""Offline inference without a server: run prompts through the port's
full generator stack with a LocalConnection, print answers + total time.

    python -m ppl.llm.serving_tpu_torch.tools.offline_inference \\
        --model-dir <HF checkpoint dir> [--device cpu]

serves a checkpoint (config.json, *.safetensors and the tokenizer found
beside them); random weights at a params.json's widths:

    python -m ppl.llm.serving_tpu_torch.tools.offline_inference \\
        --model-format random --model-param-path params.json \\
        --tokenizer-type dummy [--device cpu]
"""

import argparse
import sys
import time

from ppl.llm.serving_tpu_torch.connection import LocalConnection
from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.request import Request
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer
from ppl.llm.serving_tpu_torch.tools.common import (add_generator_args,
                                                    add_model_args,
                                                    build_configs,
                                                    setup_logging)

DEFAULT_PROMPTS = [
    "Building a website can be done in 10 simple steps:",
    "I believe the meaning of life is",
    "Simply put, the theory of relativity states that",
    "A brief message congratulating the team on the launch:",
]


def main():
    parser = argparse.ArgumentParser(description=__doc__)
    add_model_args(parser)
    add_generator_args(parser)
    parser.add_argument("--prompt", action="append", default=None,
                        help="prompt (repeatable); defaults to 4 canned")
    parser.add_argument("--generation-len", type=int, default=64)
    args = parser.parse_args()
    setup_logging()

    model_cfg, resource_cfg, gen_cfg = build_configs(args)
    tokenizer = create_tokenizer(args.model_type, resource_cfg.tokenizer_path,
                                 args.tokenizer_type,
                                 args.tokenizer_config_path or None)
    engine, kv_max, max_running_batch = create_engine(
        model_cfg, resource_cfg, gen_cfg)
    if max_running_batch < gen_cfg.max_running_batch:
        print(f"[WARN] bucket grid clamped: max_running_batch "
              f"{gen_cfg.max_running_batch} -> {max_running_batch} (largest "
              f"decode bucket that fits device memory)", flush=True)
        gen_cfg.max_running_batch = max_running_batch
    conn = LocalConnection()
    generator = LLMGenerator(model_cfg, gen_cfg, engine, tokenizer, conn,
                             kv_max)

    prompts = args.prompt or DEFAULT_PROMPTS
    requests = [
        Request(id=i, prompt=p, generation_length=args.generation_len,
                top_k=args.top_k, top_p=args.top_p, early_stopping=True)
        for i, p in enumerate(prompts)
    ]
    conn.set_wanted(len(requests))
    start = time.perf_counter()
    for r in requests:
        generator.process(r)
    if not conn.wait(timeout=3600):
        print("TIMEOUT", file=sys.stderr)
        sys.exit(1)
    elapsed_ms = (time.perf_counter() - start) * 1e3

    n_tokens = 0
    for i, p in enumerate(prompts):
        print(f"\n=== prompt {i} ===")
        print(p)
        print("---")
        print(conn.text(i))
        n_tokens += len(conn.tokens.get(i, []))
    print(f"\ngenerated {n_tokens} tokens in {elapsed_ms:.1f} ms "
          f"({n_tokens / (elapsed_ms / 1e3):.1f} tok/s) on "
          f"{resource_cfg.device}")
    generator.shutdown()


if __name__ == "__main__":
    main()
