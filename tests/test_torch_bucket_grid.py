"""Bucket-grid validation of the port (``LLMEngine.validate_bucket_grid``
over ``prewarm``), held against the JAX package's on the CPU.

Both engines get the same configuration and the same simulated failures:
the JAX engine's ``prewarm`` is faked (it accepts ``unload=`` as the JAX
engine calls it, and compiles nothing), the port's warm-up of a key
(``_warm``) raises ``torch.cuda.OutOfMemoryError`` for the chosen keys
and otherwise runs the real eager warm-up on an all-padding plan. The
decisions must agree: the keys visited in order, the surviving batch
buckets, the return value and the prefill row caps. The port's
validation must leave the KV cache, its scale rows and the penalty
count map byte-equal. (The intent of ``tests/test_prewarm.py``'s two
grid tests, which stay as they are.)
"""

import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.config import GeneratorConfig as JGeneratorConfig
from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
from ppl.llm.serving_tpu.engine import (
    compute_kv_cache_max_tokens as j_compute_kv)
from ppl.llm.serving_tpu.resources import create_engine as j_create_engine
from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)
from ppl.llm.serving_tpu_torch.resources import create_engine, kv_pool_tokens

MODEL = dict(hidden_dim=64, intermediate_dim=128, num_layers=2, num_heads=4,
             num_kv_heads=2, vocab_size=256, cache_mode=1, page_size=16,
             dtype="float32")
GEN = dict(max_running_batch=16, max_prefill_batch=4, max_tokens_per_step=256,
           max_total_tokens_per_request=64)
RESOURCE = dict(model_format="random", kv_cache_max_tokens=2048,
                token_buckets=(32, 64), batch_buckets=(4, 8, 16),
                enable_penalty=True)


def fails_at_batch(n):
    return lambda key: key[2] >= n


def wide_64_fails(key):
    return key[4] == 64 and key[3] > 1


def bucket_64_fails(key):
    return key[4] == 64


# (id, batch buckets, validate_bucket_grid args, failing keys, expected
# return, expected buckets, expected row caps)
CASES = [
    ("clamps_on_failure", (4, 8, 16), (64, 16), fails_at_batch(16), 8,
     (4, 8), {}),
    ("all_fit", (4, 8, 16), (64, 16), lambda key: False, 16, (4, 8, 16), {}),
    ("drops_unreachable", (4, 8, 16), (64, 8), lambda key: False, 8, (4, 8),
     {}),
    ("keeps_covering", (4, 8, 16), (64, 12), lambda key: False, 12,
     (4, 8, 16), {}),
    ("caps_mixed_rows", (4, 8), (64, 8, 128), wide_64_fails, 8, (4, 8),
     {64: 1}),
    ("caps_bucket_at_zero", (4, 8), (64, 8, 128), bucket_64_fails, 8, (4, 8),
     {64: 0}),
    ("clamps_and_caps", (4, 8, 16), (64, 16, 256), fails_at_batch(16), 8,
     (4, 8), {}),
]


_J_ENGINES = {}


def j_validate(buckets, args, fails, multi_step):
    """The JAX engine's decisions, with a fake prewarm (one engine per
    configuration, its grid reset before each validation)."""
    if (buckets, multi_step) not in _J_ENGINES:
        _J_ENGINES[buckets, multi_step] = j_create_engine(
            JModelConfig(**MODEL),
            JResourceConfig(**dict(RESOURCE, batch_buckets=buckets,
                                   multi_step=multi_step)),
            JGeneratorConfig(**GEN))[0]
    engine = _J_ENGINES[buckets, multi_step]
    engine.batch_buckets = tuple(buckets)
    engine.max_prefill_rows = {}
    visited = []

    def fake_prewarm(keys, unload=False):
        (key,) = keys
        key = tuple(int(x) for x in key)
        visited.append(key)
        return 0 if fails(key) else 1

    engine.prewarm = fake_prewarm
    got = engine.validate_bucket_grid(*args)
    return got, engine, visited


def port_validate(buckets, args, fails, multi_step, kv8, monkeypatch):
    """The port's decisions with its real CPU warm-up, failing the chosen
    keys; the device state snapshotted before and returned after."""
    model = dict(MODEL, **(dict(cache_quant_bit=8, cache_quant_group=8)
                           if kv8 else {}))
    engine, _, _ = create_engine(
        ModelConfig(**model),
        ResourceConfig(**dict(RESOURCE, batch_buckets=buckets,
                              multi_step=multi_step, device="cpu")),
        GeneratorConfig(**GEN))
    # random contents, so that a stray write would show
    g = torch.Generator().manual_seed(0)
    if kv8:
        engine.kv_cache.copy_(torch.randint(-127, 128, engine.kv_cache.shape,
                                            generator=g, dtype=torch.int8))
        engine.kv_scale.copy_(torch.rand(engine.kv_scale.shape, generator=g))
    else:
        engine.kv_cache.copy_(torch.randn(engine.kv_cache.shape, generator=g))
    engine.count_map.copy_(torch.randint(0, 5, engine.count_map.shape,
                                         generator=g, dtype=torch.int32))
    before = [None if t is None else t.clone()
              for t in (engine.kv_cache, engine.kv_scale, engine.count_map)]
    visited = []
    real_warm = engine._warm

    def fake_warm(key):
        visited.append(tuple(int(x) for x in key))
        if fails(key):
            raise torch.cuda.OutOfMemoryError("simulated: out of memory")
        real_warm(key)

    monkeypatch.setattr(engine, "_warm", fake_warm)
    got = engine.validate_bucket_grid(*args)
    return got, engine, visited, before


@pytest.mark.parametrize("multi_step", [1, 8], ids=["per_step", "blocks"])
@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_validate_bucket_grid_matches_jax(case, multi_step, monkeypatch):
    _, buckets, args, fails, want, want_buckets, want_caps = case
    kv8 = multi_step == 8      # int8 KV on one of the two, for kv_scale
    j_got, j_engine, j_visited = j_validate(buckets, args, fails, multi_step)
    got, engine, visited, before = port_validate(buckets, args, fails,
                                                 multi_step, kv8, monkeypatch)
    assert visited == j_visited
    assert got == j_got == want
    assert engine.batch_buckets == tuple(j_engine.batch_buckets) == want_buckets
    assert engine.max_prefill_rows == dict(j_engine.max_prefill_rows)
    assert engine.max_prefill_rows == want_caps
    assert engine.max_kv_pages == j_engine.max_kv_pages == 4
    # the warm-up runs every key that did not fail; the failed ones are
    # dropped with their runners
    ran = {k for k in visited if not fails(k)}
    assert set(engine._runners) == ran
    assert all(r.visits == 1 for r in engine._runners.values())
    # no live page, scale row or count-map row changed (the padding
    # writes to the trash page and the trash slot were put back)
    for t, t0 in zip((engine.kv_cache, engine.kv_scale, engine.count_map),
                     before):
        assert (t is None) == (t0 is None)
        assert t is None or torch.equal(t, t0)


@pytest.mark.parametrize("case", ["unreachable", "covering"])
def test_unreachable_bucket_dropped_without_a_visit(case, monkeypatch):
    """A bucket past the first one covering max_running_batch is dropped
    unvisited; the covering bucket itself is visited and kept."""
    mrb = 8 if case == "unreachable" else 12
    got, engine, visited, _ = port_validate((4, 8, 16), (64, mrb),
                                            lambda key: False, 8, False,
                                            monkeypatch)
    batches = {k[2] for k in visited}
    if case == "unreachable":
        assert 16 not in batches and engine.batch_buckets == (4, 8)
    else:
        assert 16 in batches and engine.batch_buckets == (4, 8, 16)
    # every variant traffic can dispatch at a kept bucket: greedy and
    # sampled, device-fed block and continuation
    for b in engine.batch_buckets:
        assert {(k[1], k[6], k[7]) for k in visited if k[2] == b} == {
            (True, False, False), (True, True, False), (True, False, True),
            (True, True, True)}
    assert got == mrb


def test_row_caps_reach_admission(monkeypatch):
    """The caps reach admission through ``padded_prefill_tokens`` (the
    sentinel) and ``prompt_row_cap``, as in the JAX package."""
    _, engine, _, _ = port_validate((4, 8), (64, 8, 128), wide_64_fails, 1,
                                    False, monkeypatch)
    assert engine.padded_prefill_tokens(2, 40) > 10 ** 12
    assert engine.padded_prefill_tokens(1, 40) == 64
    assert engine.padded_prefill_tokens(4, 20) == 4 * 32
    assert engine.prompt_row_cap(40) == 1
    assert engine.prompt_row_cap(20) is None
    _, engine0, _, _ = port_validate((4, 8), (64, 8, 128), bucket_64_fails, 1,
                                     False, monkeypatch)
    assert engine0.prompt_row_cap(40) == 0
    assert engine0.padded_prefill_tokens(1, 40) > 10 ** 12


def serve(validate_grid):
    """Five requests through the generator; returns the engine, the keys
    validation warmed up, and the tokens."""
    from ppl.llm.serving_tpu_torch.connection import LocalConnection
    from ppl.llm.serving_tpu_torch.generator import LLMGenerator
    from ppl.llm.serving_tpu_torch.request import Request
    from ppl.llm.serving_tpu_torch.tokenizer.factory import ByteTokenizer
    cfg = ModelConfig(**MODEL)
    gen_cfg = GeneratorConfig(**dict(GEN, max_running_batch=8,
                                     max_input_tokens_per_request=48,
                                     max_output_tokens_per_request=16))
    engine, kv_max, mrb = create_engine(
        cfg, ResourceConfig(**dict(RESOURCE, device="cpu")), gen_cfg,
        validate_grid=validate_grid)
    warmed = set(engine._runners)
    conn = LocalConnection()
    gen = LLMGenerator(cfg, gen_cfg, engine, ByteTokenizer(), conn, kv_max)
    rng = np.random.default_rng(0)
    reqs = [Request(id=i, token_ids=rng.integers(3, 256, n).tolist(),
                    generation_length=12, top_k=1, early_stopping=False)
            for i, n in enumerate((20, 33, 40, 9, 27))]
    conn.set_wanted(len(reqs))
    try:
        for r in reqs:
            gen.process(r)
        assert conn.wait(timeout=120)
    finally:
        gen.shutdown()
    return engine, mrb, warmed, {r.id: list(conn.tokens[r.id]) for r in reqs}


def test_validated_grid_serves_the_same_tokens():
    """create_engine(validate_grid=True) validates before serving and
    returns the clamp; serving then runs the warmed-up keys as they were
    (captured, on the card) and any other key eagerly, never capturing
    it, and gives the tokens of an engine that was not validated."""
    engine, mrb, warmed, tokens = serve(True)
    assert mrb == 8 and engine.batch_buckets == (4, 8)
    assert warmed and all(r.lazy is False for r in engine._runners.values())
    served = set(engine._runners)
    assert served & warmed and served - warmed   # both kinds were served
    plain, mrb0, warmed0, tokens0 = serve(False)
    assert mrb0 == 8 and not warmed0 and plain.batch_buckets == (4, 8, 16)
    assert all(r.lazy for r in plain._runners.values())
    assert tokens == tokens0
    assert all(len(t) == 12 for t in tokens.values())


@pytest.mark.parametrize("kv8", [False, True], ids=["bf16_kv", "int8_kv"])
@pytest.mark.parametrize("free,reserved", [
    (70_000_000_123, 0), (70_000_000_123, 4 << 30), (64 << 30, 9 << 30),
    (3 << 30, 5 << 30)])
def test_kv_pool_sized_after_graphs(kv8, free, reserved):
    """The auto-sized pool takes max_tokens_scale of the memory free after
    the weights less what the CUDA graphs and their warm-up held on the
    provisional engine, in whole pages (at least one): the JAX package's
    sizing of the free bytes that remain."""
    widths = dict(hidden_dim=5120, intermediate_dim=13696, num_layers=40,
                  num_heads=40, num_kv_heads=40, vocab_size=64000,
                  page_size=128, dtype="bfloat16")
    if kv8:
        widths.update(cache_quant_bit=8, cache_quant_group=8)
    got = kv_pool_tokens(ModelConfig(**widths), ResourceConfig(), free,
                         reserved)
    # (the JAX sizing reads 0 free bytes as the CPU: no graph room left
    # is one page here)
    want = (j_compute_kv(JModelConfig(**widths), JResourceConfig(),
                         free - reserved) if free > reserved else 0)
    assert got == max(128, want // 128 * 128)
    assert got <= kv_pool_tokens(ModelConfig(**widths), ResourceConfig(),
                                 free)
    # an explicit pool is served as given
    assert kv_pool_tokens(ModelConfig(**widths),
                          ResourceConfig(kv_cache_max_tokens=16384), free,
                          reserved) == 16384
