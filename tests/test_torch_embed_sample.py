"""The port's library-embedding sample (``ppl.llm.serving_tpu_torch.
samples.embed_serving``) on the CPU: its ``main`` serves request 1 of
the demo model to 16 tokens, and with the JAX engine's weights carried
across (``models.llama.params_from_jax``) its ``generate`` gives the
greedy tokens that the JAX package's sample flow (``create_engine``,
``LLMGenerator``, ``LocalConnection`` of the same demo model and
request) gives."""

import jax
import numpy as np
import torch

from ppl.llm.serving_tpu.config import GeneratorConfig as JGeneratorConfig
from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
from ppl.llm.serving_tpu.connection import LocalConnection as JConnection
from ppl.llm.serving_tpu.generator import LLMGenerator as JGenerator
from ppl.llm.serving_tpu.request import Request as JRequest
from ppl.llm.serving_tpu.resources import create_engine as j_create_engine
from ppl.llm.serving_tpu.tokenizer.factory import (ByteTokenizer as
                                                   JByteTokenizer)
from ppl.llm.serving_tpu_torch.engine import LLMEngine
from ppl.llm.serving_tpu_torch.models import llama as tllama
from ppl.llm.serving_tpu_torch.ops.kv_cache import CacheSpec
from ppl.llm.serving_tpu_torch.request import FinishFlag
from ppl.llm.serving_tpu_torch.samples import embed_serving as sample


def test_main_serves_the_demo_model_on_the_cpu(capsys):
    conn = sample.main(["--device", "cpu"])
    assert len(conn.tokens[1]) == sample.GENERATION_LEN == 16
    assert conn.finish_flags[1] == FinishFlag.LENGTH
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("generated: ") and out[-1] == "16 tokens on cpu"


def test_greedy_tokens_match_the_jax_sample_flow():
    jcfg = JModelConfig(**sample.DEMO_MODEL)
    jgen_cfg = JGeneratorConfig(**sample.GEN)
    jengine, kv_max = j_create_engine(
        jcfg, JResourceConfig(model_format="random",
                              kv_cache_max_tokens=sample.DEMO_KV_TOKENS),
        jgen_cfg)
    jconn = JConnection()
    jgen = JGenerator(jcfg, jgen_cfg, jengine, JByteTokenizer(), jconn,
                      kv_max)
    try:
        jconn.set_wanted(1)
        jgen.process(JRequest(id=1, prompt=sample.PROMPT,
                              generation_length=sample.GENERATION_LEN,
                              top_k=1))
        assert jconn.wait(timeout=600)
    finally:
        jgen.shutdown()
    want = list(jconn.tokens[1])

    model_cfg, resource_cfg, gen_cfg, tokenizer = sample.configs(None, "cpu")
    params = tllama.params_from_jax(
        jax.tree.map(np.asarray, jengine._params), "cpu", torch.float32)
    spec = CacheSpec(num_layers=model_cfg.num_layers,
                     num_pages=kv_max // model_cfg.page_size,
                     page_size=model_cfg.page_size,
                     num_kv_heads=model_cfg.num_kv_heads,
                     head_dim=model_cfg.head_dim, dtype=torch.float32)
    engine = LLMEngine(model_cfg, resource_cfg, params, spec, device="cpu")
    conn = sample.generate(model_cfg, gen_cfg, engine, kv_max, tokenizer)
    assert list(conn.tokens[1]) == want
    assert len(want) == 16 and conn.text(1) == jconn.text(1)
