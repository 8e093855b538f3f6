"""K5 (the page read) and the KV-write microbench of the port on the CPU.

- K5's plain version (what the wrapper runs for a CPU tensor) against the
  same read made in numpy, and against a copy of the JAX tool's Pallas
  ``read_kernel`` in interpret mode at a tiny shape (the JAX function is a
  closure inside the tool's ``main`` and cannot be imported): exact.
- The microbench at a tiny geometry: formulations b-d leave the cache
  bytes (a) leaves, and f-h those of the same number of writes of (a) in
  a row; every formulation reports a time.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from ppl.llm.serving_tpu_torch.ops import kernels
from ppl.llm.serving_tpu_torch.ops.kernels import cache_read
from ppl.llm.serving_tpu_torch.tools import microbench_scatter_7b as mb

KVH, LS, PS, R = 4, 3 * 16, 16, 32


def tiny_cache(seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-128, 128, (KVH, LS, R), dtype=np.int8)


def jax_pallas_read(cache, ps, rows=8):
    """The JAX tool's read_kernel (tools/microbench_scatter_7b.py), at
    this shape, in interpret mode."""
    kvh, _, r = cache.shape

    def read_kernel(c_ref, o_ref, buf, sem):
        pltpu.make_async_copy(c_ref.at[:, pl.ds(0, ps), :], buf,
                              sem).start()
        pltpu.make_async_copy(c_ref.at[:, pl.ds(0, ps), :], buf,
                              sem).wait()
        o_ref[...] = buf[:, :rows, :].astype(jnp.float32)

    return pl.pallas_call(
        read_kernel,
        in_specs=[pl.BlockSpec(memory_space=pltpu.ANY)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((kvh, rows, r), jnp.float32),
        scratch_shapes=[pltpu.VMEM((kvh, ps, r), jnp.int8),
                        pltpu.SemaphoreType.DMA],
        interpret=True,
    )(cache)


@pytest.mark.parametrize("rows", [8, 1])
def test_page_read_matches_numpy(rows):
    cache = tiny_cache(0)
    want = cache[:, :rows, :].astype(np.float32)
    got = cache_read.page_read(torch.from_numpy(cache), rows=rows,
                               page_size=PS)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        cache_read.page_read_ref(torch.from_numpy(cache), rows).numpy(),
        want)


def test_page_read_matches_jax_pallas_read():
    cache = tiny_cache(1)
    want = np.asarray(jax_pallas_read(jnp.asarray(cache), PS))
    got = cache_read.page_read(torch.from_numpy(cache), page_size=PS)
    np.testing.assert_array_equal(got.numpy(), want)


def test_page_read_is_a_counted_wrapper():
    assert kernels.WRAPPERS["page_read"] is cache_read.page_read
    assert "page_read" in kernels.launch_counts()
    # the CPU path runs the plain version and launches nothing
    before = cache_read.page_read.launches
    cache_read.page_read(torch.zeros((2, 16, 16), dtype=torch.int8))
    assert cache_read.page_read.launches == before


def test_microbench_forms_leave_the_same_cache():
    lines = []
    out = mb.run(num_layers=2, num_kv_heads=3, page_size=16, row_lanes=32,
                 num_pages=6, tokens=5, steps=4, device="cpu", iters=1,
                 log=lines.append)
    assert set(out["ms"]) == set("abcdefgh")
    assert out["same"] == {k: True for k in "abcdfgh"}
    assert all(v > 0 for v in out["ms"].values())
    assert len(lines) == 9 and lines[0].startswith("cache ")


def test_microbench_form_check_catches_a_wrong_write(monkeypatch):
    """A form that leaves other bytes is reported as differing: the
    check is not vacuous. Here index_put_ writes nothing (b), and the
    page read also bumps a cache byte (g and h)."""
    real_read = mb.page_read

    def read_and_write(cache, **kw):
        cache[0, 0, 0] += 1
        return real_read(cache, **kw)

    monkeypatch.setattr(torch.Tensor, "index_put_", lambda self, *a: self)
    monkeypatch.setattr(mb, "page_read", read_and_write)
    out = mb.run(num_layers=2, num_kv_heads=2, page_size=16, row_lanes=32,
                 num_pages=4, tokens=3, steps=2, device="cpu", iters=1,
                 log=lambda s: None)
    assert out["same"] == dict(a=True, b=False, c=True, d=True, f=True,
                               g=False, h=False)


def test_microbench_refuses_a_missing_gpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        mb.run(device="cuda")
