"""Port generator end to end vs the JAX generator (after
tests/test_generator_e2e.py): the same weights, the same requests, the
per-step loop (multi_step=1) on both; greedy tokens must be identical,
with float, i8i8, and w4a8 weights over an int8 KV cache.
"""

import jax
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.config import GeneratorConfig as JGeneratorConfig
from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
from ppl.llm.serving_tpu.connection import LocalConnection as JConnection
from ppl.llm.serving_tpu.generator import LLMGenerator as JGenerator
from ppl.llm.serving_tpu.request import Request as JRequest
from ppl.llm.serving_tpu.resources import create_engine as j_create_engine
from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)
from ppl.llm.serving_tpu_torch.connection import LocalConnection
from ppl.llm.serving_tpu_torch.engine import LLMEngine
from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.models import llama as tllama
from ppl.llm.serving_tpu_torch.ops.kv_cache import CacheSpec
from ppl.llm.serving_tpu_torch.request import FinishFlag, Request

MODEL = dict(hidden_dim=64, intermediate_dim=128, num_layers=2, num_heads=4,
             num_kv_heads=2, vocab_size=256, cache_mode=1, page_size=16,
             dtype="float32")
GEN = dict(max_running_batch=8, max_prefill_batch=4, max_tokens_per_step=256,
           max_input_tokens_per_request=128,
           max_output_tokens_per_request=64,
           max_total_tokens_per_request=192, stop_tokens=frozenset({2}))
RESOURCE = dict(model_format="random", kv_cache_max_tokens=2048,
                token_buckets=(32, 64, 128, 256), batch_buckets=(4, 8, 16),
                multi_step=1)
PROMPTS = [[1, 72, 101, 108, 108, 111], list(range(3, 40)),
           [1, 200, 17, 99, 5, 6, 7, 8, 9, 10, 11]]


class ByteTokenizer:
    bos_id, eos_id, vocab_size = 1, 2, 256

    def encode(self, text):
        return [1] + list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


def serve(gen, conn, req_cls, gen_len):
    reqs = [req_cls(id=i, token_ids=list(p), generation_length=gen_len,
                    top_k=1, early_stopping=False)
            for i, p in enumerate(PROMPTS)]
    conn.set_wanted(len(reqs))
    for r in reqs:
        gen.process(r)
    assert conn.wait(timeout=120), "generation timed out"
    return {i: list(conn.tokens[i]) for i in range(len(reqs))}


@pytest.mark.parametrize("quant_method,kv8", [
    pytest.param("none", False, id="none"),
    pytest.param("online_i8i8", False, id="online_i8i8"),
    pytest.param("online_w4a8", True, id="online_w4a8-int8_kv"),
])
def test_greedy_tokens_match_jax_generator(quant_method, kv8):
    gen_len = 10
    kv = dict(cache_quant_bit=8, cache_quant_group=8) if kv8 else {}
    jcfg = JModelConfig(**MODEL, **kv)
    jgen_cfg = JGeneratorConfig(**GEN)
    jengine, kv_max = j_create_engine(
        jcfg, JResourceConfig(quant_method=quant_method, **RESOURCE),
        jgen_cfg)
    jconn = JConnection()
    jgen = JGenerator(jcfg, jgen_cfg, jengine, ByteTokenizer(), jconn,
                      kv_max)
    try:
        want = serve(jgen, jconn, JRequest, gen_len)
    finally:
        jgen.shutdown()

    cfg = ModelConfig(**MODEL, **kv)
    gen_cfg = GeneratorConfig(**GEN)
    rcfg = ResourceConfig(device="cpu", quant_method=quant_method,
                          **RESOURCE)
    params = tllama.params_from_jax(
        jax.tree.map(np.asarray, jengine._params), "cpu", torch.float32)
    spec = CacheSpec(num_layers=cfg.num_layers,
                     num_pages=kv_max // cfg.page_size,
                     page_size=cfg.page_size, num_kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.head_dim, quant_bit=cfg.cache_quant_bit,
                     quant_group=cfg.cache_quant_group, dtype=torch.float32)
    engine = LLMEngine(cfg, rcfg, params, spec, device="cpu")
    conn = LocalConnection()
    gen = LLMGenerator(cfg, gen_cfg, engine, ByteTokenizer(), conn, kv_max)
    try:
        got = serve(gen, conn, Request, gen_len)
    finally:
        gen.shutdown()

    assert got == want
    assert all(len(t) == gen_len for t in got.values())
    assert all(conn.finish_flags[i] == FinishFlag.LENGTH for i in got)
