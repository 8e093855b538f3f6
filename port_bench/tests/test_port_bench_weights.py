"""The reference's weights, drawn again from the seed, equal the
program's own draw and int8 quantization, byte for byte after
dequantization (here on the CPU; on the card with the ``gpu`` marker, at
Baichuan-13B's and InternLM-7B's widths, one layer)."""

import json
import os

import pytest
import torch

from port_bench.reference.weights import Draw, int8_weight
from port_bench.tests import tiny

CONFIGS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "configs")


def program_layers(cfg, seed, device):
    from ppl.llm.serving_tpu_torch.config import ModelConfig
    from ppl.llm.serving_tpu_torch.models import llama
    keys = {f.name for f in __import__("dataclasses").fields(ModelConfig)}
    mc = ModelConfig(**{k: v for k, v in cfg.items() if k in keys})
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return llama.init_params(mc, gen, dtype=torch.bfloat16, device=device,
                             quantize="online_i8i8")


def dequantized(lp, name):
    q, s = lp[name + "_q"].float(), lp[name + "_s"]
    if name == "w_gate_up":            # C-leading [2, D, I], scales [2, I]
        return (q * s[:, None, :]).permute(1, 0, 2)
    return q * s.unsqueeze(0)


def check(cfg, seed, device):
    params = program_layers(cfg, seed, device)
    draw = Draw(cfg, seed, device)
    assert torch.equal(draw.embedding(), params["embedding"])
    for lp_ref, lp in zip(draw.layers(), params["layers"]):
        for name in ("wqkv", "wo", "w_gate_up", "w_down"):
            assert torch.equal(int8_weight(lp_ref[name]),
                               dequantized(lp, name)), name
        for name in ("bqkv", "bo"):
            if name in lp:
                assert torch.equal(lp_ref[name], lp[name]), name
    assert torch.equal(draw.lm_head(), params["lm_head"])


@pytest.mark.parametrize("config", sorted(tiny.CONFIGS))
def test_the_draw_equals_the_programs_on_the_cpu(config):
    check(dict(tiny.CONFIGS[config]), 2**31 + 3, "cpu")


@pytest.mark.gpu
@pytest.mark.parametrize("config", ["baichuan-13b-i8i8-kv8",
                                    "internlm-7b-i8i8-kv8"])
def test_the_draw_equals_the_programs_on_the_card(config):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device; PyTorch sees none")
    cfg = json.load(open(os.path.join(CONFIGS, config + ".json")))
    check(dict(cfg, num_layers=1), 2**31 + 3, "cuda")
