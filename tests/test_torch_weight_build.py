"""The weight build quantizes each layer as it is drawn (so one float
layer is alive at a time) and gives the same bytes as drawing every
float weight first and quantizing after: ``init_params(...,
quantize=method)`` against ``quantize_model_params(init_params(...))``
on the same seed, and ``create_engine``'s weights against the same, on
the CPU at tiny widths."""

import pytest
import torch

from ppl.llm.serving_tpu_torch.config import (GeneratorConfig, ModelConfig,
                                              ResourceConfig)
from ppl.llm.serving_tpu_torch.models import llama, loader
from ppl.llm.serving_tpu_torch.resources import create_engine

MODEL = dict(hidden_dim=128, intermediate_dim=256, num_layers=3,
             num_heads=4, num_kv_heads=2, vocab_size=320, cache_mode=1,
             page_size=16, dtype="float32")

_BITS = {1: torch.uint8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def assert_same_bytes(got, want):
    assert list(got) == list(want)
    for key in want:
        if key == "layers":
            assert len(got[key]) == len(want[key])
            for lg, lw in zip(got[key], want[key]):
                assert_same_bytes(lg, lw)
            continue
        a, b = got[key], want[key]
        assert a.dtype == b.dtype and a.shape == b.shape, key
        assert a.is_contiguous() and b.is_contiguous(), key
        bits = _BITS[a.element_size()]
        assert torch.equal(a.view(bits), b.view(bits)), key


def two_step(cfg, method, lm_head, dtype, seed=7):
    gen = torch.Generator().manual_seed(seed)
    params = llama.init_params(cfg, gen, dtype=dtype)
    return llama.quantize_model_params(params, method, lm_head)


@pytest.mark.parametrize("method,lm_head", [("online_i8i8", False),
                                            ("online_i8i8", True),
                                            ("online_w4a8", True),
                                            ("online_w4a8", False)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("attn_bias", [False, True])
def test_layer_by_layer_build_is_byte_equal(method, lm_head, dtype,
                                            attn_bias):
    cfg = ModelConfig(**dict(MODEL, attn_bias=attn_bias))
    gen = torch.Generator().manual_seed(7)
    got = llama.init_params(cfg, gen, dtype=dtype, quantize=method,
                            quantize_lm_head=lm_head)
    assert_same_bytes(got, two_step(cfg, method, lm_head, dtype))
    assert ("lm_head" in got) != lm_head
    assert all("wqkv" not in lp and "wqkv_q" in lp for lp in got["layers"])


def test_unquantized_build_is_unchanged():
    cfg = ModelConfig(**MODEL)
    a = llama.init_params(cfg, torch.Generator().manual_seed(3),
                          quantize="none", quantize_lm_head=True)
    b = llama.init_params(cfg, torch.Generator().manual_seed(3))
    assert_same_bytes(a, b)
    assert "lm_head" in a and "wqkv" in a["layers"][0]


def test_loader_quantizes_as_it_draws():
    cfg = ModelConfig(**MODEL)
    got = loader.load_params(cfg, "random", "", seed=5, device="cpu",
                             quant_method="online_w4a8",
                             quantize_lm_head=True)
    assert_same_bytes(got, two_step(cfg, "online_w4a8", True,
                                    torch.float32, seed=5))


@pytest.mark.parametrize("method,lm_head", [("online_i8i8", False),
                                            ("online_w4a8", True)])
def test_create_engine_weights_equal_the_two_step_build(method, lm_head):
    cfg = ModelConfig(**MODEL)
    engine, _, _ = create_engine(
        cfg, ResourceConfig(model_format="random", quant_method=method,
                            quantize_lm_head=lm_head,
                            kv_cache_max_tokens=256, device="cpu"),
        GeneratorConfig(max_running_batch=4, max_prefill_batch=2,
                        max_tokens_per_step=64,
                        max_total_tokens_per_request=64), rng_seed=11)
    assert_same_bytes(engine._params, two_step(cfg, method, lm_head,
                                               torch.float32, seed=11))
    # device memory is measured on cuda only
    assert engine.weight_build_peak_bytes is None
    assert engine.free_after_weights_bytes is None
