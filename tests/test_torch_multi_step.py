"""Multi-step decode blocks of the port vs the JAX package's generator
(the port counterparts of tests/test_multi_step.py).

Both generators serve the same requests from the same weights (the JAX
engine's random parameters, converted with ``params_from_jax``) at the
same ``multi_step``; greedy tokens must be identical. The JAX generators
run at their default speculation depth (1), which the JAX package holds
token-identical to every other depth; the port runs at the depth each
test names. Float weights throughout, plus i8i8 weights and w4a8 weights
over an int8 KV cache where the test is parametrised so.
"""

import time

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
from ppl.llm.serving_tpu_torch.engine import LLMEngine, TaskState
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
                token_buckets=(32, 64, 128, 256), batch_buckets=(4, 8, 16))
QUANTS = {"none": ("none", False), "online_i8i8": ("online_i8i8", False),
          "online_w4a8-int8_kv": ("online_w4a8", True)}
# float weights over an int8 KV cache (the block-tail tests)
WEIGHTS_KV = dict(QUANTS, **{"none-int8_kv": ("none", True)})


class ByteTokenizer:
    bos_id, eos_id, vocab_size = 1, 2, 256

    def encode(self, text):
        return [1] + list(text.encode("utf-8"))

    def decode(self, ids):
        return bytes(i for i in ids if 0 <= i < 256).decode(
            "utf-8", errors="replace")


def reqs(prompts, gen_len, **kw):
    """Request specs: prompt text (byte-tokenized), generation length and
    any Request field (early_stopping, stop_tokens, repetition_penalty)."""
    return [dict(tokens=ByteTokenizer().encode(p), gen_len=gen_len, **kw)
            for p in prompts]


class _JaxPool:
    """JAX generators shared by the tests of a module (one per
    configuration: compiling their programs is most of their cost)."""

    def __init__(self):
        self.gens = {}
        self.next_id = 0

    def get(self, multi_step, quant_method, kv8, penalty, resource_kw):
        key = (multi_step, quant_method, kv8, penalty,
               tuple(sorted(resource_kw.items())))
        if key not in self.gens:
            kv = dict(cache_quant_bit=8, cache_quant_group=8) if kv8 else {}
            cfg = JModelConfig(**MODEL, **kv)
            gen_cfg = JGeneratorConfig(**GEN, enable_penalty=penalty)
            rcfg = JResourceConfig(quant_method=quant_method,
                                   multi_step=multi_step,
                                   enable_penalty=penalty,
                                   **dict(RESOURCE, **resource_kw))
            engine, kv_max = j_create_engine(cfg, rcfg, gen_cfg)
            conn = JConnection()
            gen = JGenerator(cfg, gen_cfg, engine, ByteTokenizer(), conn,
                             kv_max)
            self.gens[key] = (gen, conn, engine, kv_max)
        return self.gens[key]

    def close(self):
        for gen, *_ in self.gens.values():
            gen.shutdown()
        self.gens.clear()


POOL = _JaxPool()


@pytest.fixture(scope="module", autouse=True)
def _jax_generators():
    yield
    POOL.close()


def serve(gen, conn, req_cls, specs):
    """Serve ``specs`` under fresh request ids; returns (tokens, finish
    flags), one entry per spec."""
    objs = []
    for s in specs:
        r = req_cls(id=POOL.next_id, token_ids=list(s["tokens"]),
                    generation_length=s["gen_len"], top_k=1,
                    early_stopping=s.get("early_stopping", False))
        POOL.next_id += 1
        for field in ("stop_tokens", "repetition_penalty"):
            if field in s:
                setattr(r, field, s[field])
        objs.append(r)
    conn.set_wanted(len(objs))
    for r in objs:
        gen.process(r)
    assert conn.wait(timeout=300), "generation timed out"
    return ([list(conn.tokens.get(r.id, [])) for r in objs],
            [conn.finish_flags.get(r.id) for r in objs])


def port_generator(jengine, kv_max, multi_step, quant_method="none",
                   kv8=False, penalty=False, resource_kw=None, gen_kw=None):
    """A port generator on the CPU with the JAX engine's weights."""
    kv = dict(cache_quant_bit=8, cache_quant_group=8) if kv8 else {}
    cfg = ModelConfig(**MODEL, **kv)
    gen_cfg = GeneratorConfig(**GEN, enable_penalty=penalty,
                              **(gen_kw or {}))
    rcfg = ResourceConfig(device="cpu", quant_method=quant_method,
                          multi_step=multi_step, enable_penalty=penalty,
                          **dict(RESOURCE, **(resource_kw or {})))
    params = tllama.params_from_jax(
        jax.tree.map(np.asarray, jengine._params), "cpu", torch.float32)
    spec = CacheSpec(num_layers=cfg.num_layers,
                     num_pages=kv_max // cfg.page_size,
                     page_size=cfg.page_size, num_kv_heads=cfg.num_kv_heads,
                     head_dim=cfg.head_dim, quant_bit=cfg.cache_quant_bit,
                     quant_group=cfg.cache_quant_group, dtype=torch.float32)
    engine = LLMEngine(cfg, rcfg, params, spec, enable_penalty=penalty,
                       max_batch_slots=gen_cfg.max_running_batch,
                       device="cpu")
    return LLMGenerator(cfg, gen_cfg, engine, ByteTokenizer(),
                        LocalConnection(), kv_max)


def jax_tokens(specs, multi_step, quant="none", penalty=False,
               resource_kw=None):
    quant_method, kv8 = WEIGHTS_KV[quant]
    jgen, jconn, _, _ = POOL.get(multi_step, quant_method, kv8, penalty,
                                 resource_kw or {})
    return serve(jgen, jconn, JRequest, specs)


def run_port(specs, multi_step, quant="none", penalty=False,
             resource_kw=None, jax_resource_kw=None, gen_kw=None,
             spy=None, after=None):
    """Serve ``specs`` on a fresh port generator whose weights are the
    pooled JAX generator's at this configuration. ``spy(engine)`` runs
    before serving, ``after(gen)`` after it, before shutdown."""
    quant_method, kv8 = WEIGHTS_KV[quant]
    _, _, jengine, kv_max = POOL.get(
        multi_step, quant_method, kv8, penalty,
        dict(resource_kw or {}, **(jax_resource_kw or {})))
    gen = port_generator(jengine, kv_max, multi_step, quant_method, kv8,
                         penalty, resource_kw, gen_kw)
    try:
        if spy is not None:
            spy(gen.engine)
        out = serve(gen, gen.conn, Request, specs)
        if after is not None:
            after(gen)
        return out
    finally:
        gen.shutdown()


def run_both(specs, multi_step, quant="none", penalty=False,
             resource_kw=None, jax_resource_kw=None, **port_kw):
    """(JAX tokens and flags, port tokens and flags) for ``specs``."""
    want = jax_tokens(specs, multi_step, quant, penalty,
                      dict(resource_kw or {}, **(jax_resource_kw or {})))
    got = run_port(specs, multi_step, quant, penalty, resource_kw,
                   jax_resource_kw, **port_kw)
    return want, got


def count_calls(engine, name, pred=None):
    """Wrap ``engine.<name>``; returns the list its calls append to."""
    calls = []
    orig = getattr(engine, name)

    def wrapped(*a, **k):
        if pred is None or pred(*a, **k):
            calls.append(a)
        return orig(*a, **k)

    setattr(engine, name, wrapped)
    return calls


def pages_reclaimed(gen):
    for _ in range(100):
        if gen.page_mgr.get_avail() == gen.page_mgr.num_pages:
            return True
        time.sleep(0.02)
    return False


@pytest.mark.parametrize("quant", list(QUANTS))
def test_multi_matches_single_greedy(quant):
    specs = reqs(["block equivalence"], 20)
    want, got8 = run_both(specs, 8, quant)
    got1 = run_port(specs, 1, quant)
    assert got8[0] == want[0]
    assert got1[0] == got8[0]
    assert len(got8[0][0]) == 20


def test_batch_greedy_equivalence():
    specs = reqs([f"prompt number {i}" for i in range(3)], 16)
    want, got8 = run_both(specs, 8)
    assert got8[0] == want[0]
    assert run_port(specs, 1)[0] == got8[0]


def test_exact_length():
    """gen_len not a multiple of the block size still yields exactly
    gen_len tokens."""
    want, got = run_both(reqs(["hello world"], 13), 8)
    assert got == want
    assert len(got[0][0]) == 13 and got[1][0] == FinishFlag.LENGTH


def test_stop_token_truncates_block():
    """A stop token inside a block finishes the request; later block
    tokens are discarded and the pages come back."""
    specs = reqs(["hello world"], 64, early_stopping=True,
                 stop_tokens=set(range(256)))
    reclaimed = []
    want, got = run_both(specs, 8,
                         after=lambda g: reclaimed.append(pages_reclaimed(g)))
    assert got == want
    assert len(got[0][0]) == 1 and got[1][0] == FinishFlag.EOS_TOKEN
    assert reclaimed == [True]


def test_resources_exact():
    """12 prompt tokens + 20 generated cross a 16-token page mid-block:
    the pages cover the whole block's growth."""
    want, got = run_both(reqs(["abcdefghijk"], 20), 8)
    assert got == want and len(got[0][0]) == 20


@pytest.mark.parametrize("quant", list(QUANTS))
def test_speculative_pipeline_equivalence(quant):
    """No early stopping, long generations: speculation (device-fed and
    continuation blocks) runs, and the tokens equal the JAX generator's
    and the per-step loop's."""
    specs = reqs([f"pipeline {i}" for i in range(3)], 40)
    kinds = {}

    def spy(engine):
        kinds["counts"] = engine.dispatch_counts

    want, got = run_both(specs, 8, quant, spy=spy)
    assert got[0] == want[0]
    assert kinds["counts"]["fed"] + kinds["counts"]["continuation"] > 0
    assert run_port(specs, 1, quant)[0] == got[0]


def test_speculation_depth_equivalence():
    specs = reqs([f"depth {i}" for i in range(2)], 32)
    want = jax_tokens(specs, 8)
    for depth in (0, 2):
        got = run_port(specs, 8, gen_kw=dict(speculative_blocks=depth))
        assert got[0] == want[0], depth


def test_continuation_fast_path_fires():
    """Deep speculation uses the device-resident continuation dispatch
    whenever the page-table bucket does not grow."""
    specs = reqs([f"cont {i}" for i in range(2)], 32)
    calls = {}

    def spy(engine):
        calls["cont"] = count_calls(engine, "dispatch_continuation")

    want, got = run_both(specs, 4, gen_kw=dict(speculative_blocks=2),
                         spy=spy)
    assert got[0] == want[0]
    assert len(calls["cont"]) > 0
    assert all(len(t) == 32 for t in got[0])


def test_speculation_with_early_stopping():
    """A stop token hit mid-block while further speculative blocks are in
    flight: the stream stops exactly where the unpipelined one does, and
    every page comes back."""
    base = jax_tokens(reqs(["eos spec probe"], 40), 4)[0][0]
    stop_tok = base[13]
    expect = base[:base.index(stop_tok) + 1]
    specs = reqs(["eos spec probe"], 40, early_stopping=True,
                 stop_tokens={stop_tok})
    assert jax_tokens(specs, 4)[0][0] == expect
    for depth in (0, 2):
        fed, reclaimed = {}, []

        def spy(engine, fed=fed):
            fed["plans"] = count_calls(
                engine, "dispatch_plan",
                lambda plan, profiler=None: plan.get("feed_device_tokens"))

        toks, flags = run_port(
            specs, 4, gen_kw=dict(speculative_blocks=depth), spy=spy,
            after=lambda g: reclaimed.append(pages_reclaimed(g)))
        assert toks[0] == expect, depth
        assert flags[0] == FinishFlag.EOS_TOKEN
        assert reclaimed == [True]
        if depth:
            assert fed["plans"], "speculation never fired under EOS traffic"


def test_prefill_seeded_speculation():
    """The first decode block after a prefill runs on the prefill's
    sampled tokens, reordered on the device (feed_perm)."""
    specs = reqs([f"seed {i} padding words" for i in range(3)], 24)
    want = jax_tokens(specs, 4)
    for depth in (0, 2):
        perms = {}

        def spy(engine, perms=perms):
            perms["plans"] = count_calls(
                engine, "dispatch_plan",
                lambda plan, profiler=None: plan.get("feed_perm")
                is not None)

        got = run_port(specs, 4, gen_kw=dict(speculative_blocks=depth),
                       spy=spy)
        assert got[0] == want[0], depth
        if depth:
            assert perms["plans"], "prefill-seeded speculation never fired"


def test_penalties_in_blocks_match_jax():
    """Repetition penalties over 4-step blocks: the count map's per-step
    scatter-add inside the block, as the JAX block does it."""
    specs = reqs([f"penalty {i}" for i in range(3)], 24,
                 repetition_penalty=1.3)
    want, got = run_both(specs, 4, penalty=True)
    assert got[0] == want[0]


def test_engine_defaults_to_blocks():
    """ResourceConfig's defaults are the JAX package's: blocks of 8 with
    per-step cache writes."""
    rc = ResourceConfig(device="cpu")
    assert (rc.multi_step, rc.block_tail) == (8, "auto")
    assert GeneratorConfig().speculative_blocks == 1
    _, _, jengine, kv_max = POOL.get(8, "none", False, False, {})
    gen = port_generator(jengine, kv_max, rc.multi_step)
    try:
        assert gen.engine.multi_step_block == 8
        assert gen.engine.graph_stats() == {"graphs": 0, "replays": 0,
                                            "pool_bytes": 0}
        plan = gen.engine.build_plan([TaskState(
            tid=0, page_list=[0], rest_iters=10, next_tokens=[5],
            start_pos=3)])
        assert plan["n_steps"] == 8
    finally:
        gen.shutdown()
