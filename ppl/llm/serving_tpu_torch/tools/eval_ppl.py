#!/usr/bin/env python3
"""Perplexity evaluation through the serving forward path.

The port of the JAX package's ``tools/eval_ppl.py``: teacher-forced NLL
over a text corpus using the same paged-cache forward, kernels and
quantization paths the server runs (:func:`llama.make_nll_fn`: K3 or K4
for the matmuls, K2 over one prefill row of ``--seq-len`` tokens).
Compare runs with --quant-method none vs online_i8i8 (and
--cache-quant-bit 0 vs 8) on the same checkpoint.

    python -m ppl.llm.serving_tpu_torch.tools.eval_ppl \\
        --model-dir <HF checkpoint dir> --text-file corpus.txt \\
        [--quant-method online_i8i8 --cache-quant-bit 8] [--device cpu]
"""

import argparse
import math
import sys
import time
from typing import Optional, Sequence

import torch

from ppl.llm.serving_tpu_torch.models import llama, loader
from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.ops.kv_cache import CacheSpec
from ppl.llm.serving_tpu_torch.resources import require_device
from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer
from ppl.llm.serving_tpu_torch.tools.common import (add_generator_args,
                                                    add_model_args,
                                                    build_configs,
                                                    setup_logging)


def main(argv: Optional[Sequence[str]] = None) -> dict:
    """Score ``--text-file`` and print the ``[RESULT]`` line; returns
    the tokens scored, the mean NLL, the perplexity, the chunks and the
    milliseconds a chunk took (the device synchronised after each)."""
    parser = argparse.ArgumentParser(description=__doc__)
    add_model_args(parser)
    add_generator_args(parser)
    parser.add_argument("--text-file", required=True,
                        help="plain-text corpus to score")
    parser.add_argument("--seq-len", type=int, default=1024)
    parser.add_argument("--max-chunks", type=int, default=64)
    args = parser.parse_args(argv)
    setup_logging(verbose=False)

    model_cfg, resource_cfg, _ = build_configs(args)
    model_cfg.validate()
    resource_cfg.validate()
    device = require_device(resource_cfg.device)
    tokenizer = create_tokenizer(args.model_type, resource_cfg.tokenizer_path,
                                 args.tokenizer_type,
                                 args.tokenizer_config_path or None)
    params = loader.load_params(model_cfg, resource_cfg.model_format,
                                resource_cfg.model_dir, device=device,
                                quant_method=resource_cfg.quant_method,
                                quantize_lm_head=resource_cfg.quantize_lm_head)

    L = args.seq_len
    pages_per_chunk = -(-L // model_cfg.page_size)
    spec = CacheSpec(
        num_layers=model_cfg.num_layers, num_pages=pages_per_chunk,
        page_size=model_cfg.page_size, num_kv_heads=model_cfg.num_kv_heads,
        head_dim=model_cfg.head_dim, quant_bit=model_cfg.cache_quant_bit,
        quant_group=model_cfg.cache_quant_group,
        dtype=llama.torch_dtype(model_cfg.dtype))
    nll_fn = llama.make_nll_fn(model_cfg, spec,
                               quant_method=resource_cfg.quant_method)

    with open(args.text_file) as f:
        text = f.read()
    ids = tokenizer.encode(text)
    print(f"[INFO] {len(ids)} tokens from {args.text_file}", file=sys.stderr)

    # the cache is scratch: every chunk starts at 0 and K2 reads the
    # chunk's own rows, so one cache serves every chunk
    cache, scale = kv_ops.init_cache(spec, device)
    page_table = torch.arange(pages_per_chunk, dtype=torch.int32,
                              device=device)[None, :]
    total_nll, total_tok, chunk_ms = 0.0, 0, []
    for start in range(0, max(len(ids) - 1, 1), L):
        if start // L >= args.max_chunks:
            break
        chunk = ids[start:start + L]
        if len(chunk) < 2:
            break
        padded = torch.zeros(L, dtype=torch.int32)
        padded[:len(chunk)] = torch.tensor(chunk, dtype=torch.int32)
        t0 = time.perf_counter()
        with torch.no_grad():
            nll, mask = nll_fn(params, cache, scale, padded.to(device),
                               len(chunk), page_table)
        total_nll += float(nll[mask].sum())
        total_tok += int(mask.sum())
        chunk_ms.append((time.perf_counter() - t0) * 1e3)

    mean = total_nll / max(total_tok, 1)
    ppl = math.exp(mean)
    print(f"[RESULT] tokens: {total_tok}  mean NLL: {mean:.4f}  "
          f"perplexity: {ppl:.4f}")
    ms = sum(chunk_ms) / max(len(chunk_ms), 1)
    print(f"[INFO] {len(chunk_ms)} chunks of {L} tokens, {ms:.2f} ms a chunk "
          f"on {device}", file=sys.stderr)
    return dict(tokens=total_tok, mean_nll=mean, perplexity=ppl,
                chunks=len(chunk_ms), ms_per_chunk=ms, chunk_ms=chunk_ms)


if __name__ == "__main__":
    main()
