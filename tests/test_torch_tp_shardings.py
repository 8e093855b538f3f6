"""The port's sharding rules (parallel/shardings.py) against the JAX
package's (parallel/shardings.py) on its 8-device CPU mesh, and the
rank's shards as the port builds and loads them.

- The partition specs equal JAX's ``param_partition_specs`` leaf for leaf
  (float, i8i8 and w4a8 weights, a quantized lm_head); each rank's shard
  of every parameter, of the cache and of the int8-KV scale rows equals
  the JAX device shard of the same rank byte for byte (where the JAX
  package replicates the scale rows, the port's are the rank's heads'
  lanes of them).
- The tensor-parallel weight build (``init_params(shard=)``) and the
  checkpoint loader at tp=2 keep exactly the slices of the tp=1 build and
  load.
- ``validate_tp``'s refusals carry the JAX messages; w4a8 at tp > 1, data
  parallelism with ``--coordinator-address`` (the JAX tool's message),
  tp > 1 in offline_inference, and a tp engine without a process group
  are refused.
"""

import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ppl.llm.serving_tpu.models import llama as jllama
from ppl.llm.serving_tpu.ops.kv_cache import CacheSpec as JCacheSpec
from ppl.llm.serving_tpu.parallel import shardings as jsh
from ppl.llm.serving_tpu.tools import common as jcommon
from ppl.llm.serving_tpu_torch.config import (ConfigError, GeneratorConfig,
                                              ModelConfig, ResourceConfig)
from ppl.llm.serving_tpu_torch.models import llama
from ppl.llm.serving_tpu_torch.ops import kv_cache as tkv
from ppl.llm.serving_tpu_torch.parallel import kernel_tp, shardings
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.tools import common, llm_server
from ppl.llm.serving_tpu_torch.tools import offline_inference

from test_sharding import CFG
from test_torch_loader import (assert_same_bytes, family_tensors, parse,
                               port_params, write_checkpoint)

WEIGHTS = [("none", False), ("online_i8i8", False), ("online_i8i8", True),
           ("online_w4a8", True)]


def jax_params(quant, lm_head):
    p = jllama.init_params(CFG, jax.random.PRNGKey(0), dtype=jnp.float32)
    if quant != "none":
        p = jllama.quantize_model_params(p, quant, quantize_lm_head=lm_head)
    return p


@pytest.mark.parametrize("quant,lm_head", WEIGHTS)
def test_partition_specs_match_jax(quant, lm_head):
    jp = jax_params(quant, lm_head)
    tp = llama.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    want = jsh.param_partition_specs(CFG, jp)
    got = shardings.param_partition_specs(CFG, tp)
    assert sorted(got) == sorted(want)
    for k in want:
        if k == "layers":
            for lg, lw in zip(got[k], want[k]):
                assert {n: tuple(s) for n, s in lw.items()} == lg
        else:
            assert tuple(want[k]) == got[k], k
    blank = jsh.param_partition_specs(CFG)
    got = shardings.param_partition_specs(CFG)
    assert [{n: tuple(s) for n, s in lw.items()} for lw in blank["layers"]] \
        == got["layers"]
    assert {k: tuple(v) for k, v in blank.items() if k != "layers"} == {
        k: v for k, v in got.items() if k != "layers"}


def device_shards(arr, mesh):
    """The JAX array's shard on each mesh device, in rank order."""
    by_dev = {s.device: np.asarray(s.data) for s in arr.addressable_shards}
    return [by_dev[d] for d in mesh.devices.flat]


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("quant,lm_head", WEIGHTS[:3])
def test_rank_shards_equal_jax_device_shards(quant, lm_head, tp):
    jp = jax_params(quant, lm_head)
    spec = JCacheSpec(num_layers=2, num_pages=4, page_size=16,
                      num_kv_heads=4, head_dim=8, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    cache = rng.standard_normal((4, 2 * spec.num_slots, 16)).astype(
        np.float32)
    mesh = jsh.make_mesh(tp)
    sp, scache, _, _ = jsh.shard_engine_state(
        mesh, CFG, spec, jp, jnp.asarray(cache), jnp.zeros((1,)),
        jnp.zeros((1, 1), jnp.int32))
    full = llama.params_from_jax(jax.tree.map(np.asarray, jp), "cpu")
    want = jax.tree.map(lambda a: device_shards(a, mesh), sp)
    tspec = tkv.CacheSpec(num_layers=2, num_pages=4, page_size=16,
                          num_kv_heads=4, head_dim=8)
    for r in range(tp):
        got, got_cache, _, cm = shardings.shard_engine_state(
            shardings.TPGroup(r, tp), CFG, tspec, full,
            torch.from_numpy(cache), None, torch.zeros((1, 1)))
        assert cm.shape == (1, 1)   # the count map is replicated
        for k, v in got.items():
            if k == "layers":
                for lg, lw in zip(v, want[k]):
                    for n, t in lg.items():
                        np.testing.assert_array_equal(t.numpy(), lw[n][r],
                                                      err_msg=n)
            else:
                np.testing.assert_array_equal(v.numpy(), want[k][r],
                                              err_msg=k)
        np.testing.assert_array_equal(got_cache.numpy(),
                                      device_shards(scache, mesh)[r])


@pytest.mark.parametrize("kvh,hd,tp", [(8, 128, 2), (4, 32, 2), (8, 128, 4)],
                         ids=["lanes128_tp2", "lanes16_tp2", "lanes64_tp4"])
def test_scale_rows_shard_by_head(kvh, hd, tp):
    """Scale rows: the JAX package shards them only at 128-lane shards
    (else replicates); the port's rank holds its heads' lanes either way,
    equal to JAX's shard where it has one."""
    jspec = JCacheSpec(num_layers=1, num_pages=2, page_size=16,
                       num_kv_heads=kvh, head_dim=hd, quant_bit=8,
                       quant_group=8, dtype=jnp.float32)
    tspec = tkv.CacheSpec(num_layers=1, num_pages=2, page_size=16,
                          num_kv_heads=kvh, head_dim=hd, quant_bit=8,
                          quant_group=8)
    used = kvh * tspec.scale_lane_stride
    rng = np.random.default_rng(1)
    scale = np.zeros((tspec.num_slots, jspec.scale_lanes), np.float32)
    scale[:, :used] = rng.standard_normal((tspec.num_slots, used))
    mesh = jsh.make_mesh(tp)
    jscale = jax.device_put(jnp.asarray(scale), jax.sharding.NamedSharding(
        mesh, jsh.scale_partition_spec(None, jspec, tp)))
    sharded = tuple(jsh.scale_partition_spec(None, jspec, tp)) == (None,
                                                                   "tp")
    assert shardings.scale_partition_spec(None, tspec, tp) == (None, "tp")
    per = used // tp
    for r in range(tp):
        got = tkv.shard_scale_rows(
            torch.from_numpy(scale[:, :tspec.scale_lanes]), tspec, r, tp)
        assert got.shape[1] == kernel_tp.local_cache_spec(
            tspec, tp).scale_lanes
        np.testing.assert_array_equal(got[:, :per].numpy(),
                                      scale[:, r * per:(r + 1) * per])
        assert not got[:, per:].any()
        if sharded:
            np.testing.assert_array_equal(
                got.numpy(), device_shards(jscale, mesh)[r])


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("method,lm_head,bias", [
    ("none", False, False), ("online_i8i8", False, True),
    ("online_i8i8", True, False)])
def test_tp_weight_build_keeps_the_slices(method, lm_head, bias, tp):
    """Every rank draws each whole layer, quantizes it and keeps its slice:
    the slices of the tp=1 build, byte for byte."""
    cfg = ModelConfig(hidden_dim=64, intermediate_dim=128, num_layers=2,
                      num_heads=8, num_kv_heads=4, vocab_size=256,
                      attn_bias=bias, dtype="float32")
    build = dict(dtype=torch.bfloat16, quantize=method,
                 quantize_lm_head=lm_head)
    full = llama.init_params(cfg, torch.Generator().manual_seed(5), **build)
    for r in range(tp):
        got = llama.init_params(cfg, torch.Generator().manual_seed(5),
                                shard=(r, tp), **build)
        assert_same_bytes(got, shardings.shard_params(full, r, tp))


@pytest.mark.parametrize("method,lm_head", [("none", False),
                                            ("online_i8i8", True)])
@pytest.mark.parametrize("family", ["llama_gqa", "baichuan_w_pack",
                                    "internlm_bias", "tied"])
def test_loader_tp_reads_the_slices(tmp_path, family, method, lm_head):
    path = write_checkpoint(str(tmp_path), *family_tensors(family),
                            dtype="BF16")
    kw = dict(quant_method=method, quantize_lm_head=lm_head)
    _, full = port_params(path, "bfloat16", **kw)
    for r in range(2):
        _, got = port_params(path, "bfloat16", shard=(r, 2), **kw)
        assert_same_bytes(got, shardings.shard_params(full, r, 2))


def test_validate_tp_refusals_match_jax():
    for bad, tp in ((dict(num_kv_heads=4), 8),
                    (dict(num_kv_heads=8, num_heads=8,
                          intermediate_dim=100), 8),
                    (dict(vocab_size=250), 4)):
        cfg = ModelConfig(**{**CFG.__dict__, **bad})
        jcfg = type(CFG)(**{**CFG.__dict__, **bad})
        with pytest.raises(ValueError) as want:
            jsh.validate_tp(jcfg, tp)
        with pytest.raises(ValueError) as got:
            shardings.validate_tp(cfg, tp)
        assert str(got.value) == str(want.value)
    spec = tkv.CacheSpec(num_layers=1, num_pages=4, page_size=16,
                         num_kv_heads=3, head_dim=32)
    with pytest.raises(ValueError, match="divisible"):
        kernel_tp.local_cache_spec(spec, 2)
    assert kernel_tp.local_cache_spec(
        tkv.CacheSpec(1, 4, 16, 8, 32), 4).num_kv_heads == 2


def test_group_needs_its_ranks():
    with pytest.raises(ValueError, match="torch.distributed"):
        shardings.make_group(2)


def test_w4a8_stays_single_card():
    with pytest.raises(ConfigError, match="tensor_parallel_size == 1"):
        ResourceConfig(quant_method="online_w4a8",
                       tensor_parallel_size=2).validate()
    with pytest.raises(ValueError, match="w4a8"):
        kernel_tp.make_sharded_quant_matmul(
            shardings.TPGroup(0, 2), "online_w4a8")
    with pytest.raises(ConfigError, match="power of 2"):
        ResourceConfig(tensor_parallel_size=3).validate()


def test_tp_engine_needs_a_process_group():
    cfg = ModelConfig(**{**CFG.__dict__})
    with pytest.raises(ConfigError, match="one process a rank"):
        create_engine(cfg, ResourceConfig(
            device="cpu", model_format="random", kv_cache_max_tokens=1024,
            tensor_parallel_size=2), GeneratorConfig())


SERVER = ["--device", "cpu", "--model-format", "random",
          "--model-param-path", "tests/data/params_tiny.json",
          "--tokenizer-type", "dummy", "--dtype", "float32",
          "--kv-cache-max-tokens", "4096", "--port", "0"]


def test_data_parallel_with_coordinator_address_is_refused_as_in_jax():
    """One multi-process group serves one replica: dp with
    --coordinator-address is refused with the JAX tool's message
    (serving_tpu/tools/llm_server.py), in the frontend and on a worker."""
    msg = "run one server process per dp replica set"
    with open(os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "ppl", "llm", "serving_tpu", "tools",
            "llm_server.py")) as f:
        assert msg in f.read()
    flags = ["--tensor-parallel-size", "2", "--data-parallel-size", "2",
             "--coordinator-address", "127.0.0.1:1", "--num-processes", "2"]
    with pytest.raises(ConfigError, match=msg):
        llm_server.build_server(SERVER + flags + ["--process-id", "0"])
    with pytest.raises(ConfigError, match=msg):
        llm_server.serve_worker(llm_server.build_parser().parse_args(
            SERVER + flags + ["--process-id", "1"]))


def test_offline_inference_refuses_tensor_parallel(monkeypatch):
    monkeypatch.setattr(sys, "argv", ["offline_inference"] + SERVER[:-2]
                        + ["--tensor-parallel-size", "2"])
    with pytest.raises(ConfigError, match="llm_server"):
        offline_inference.main()


def test_tensor_parallel_flag_reaches_configs_as_in_jax():
    argv = ["--model-param-path", "tests/data/params_tiny.json",
            "--tensor-parallel-size", "2"]
    _, r, _ = common.build_configs(parse(argv, common))
    _, jr, _ = jcommon.build_configs(parse(argv, jcommon))
    assert r.tensor_parallel_size == jr.tensor_parallel_size == 2
