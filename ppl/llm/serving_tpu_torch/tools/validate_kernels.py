#!/usr/bin/env python3
"""Build every CUDA kernel of the port and run each one alone at small
shapes against its plain PyTorch version, before a bench and after any
kernel change (the counterpart of the JAX package's tool of the same
name, whose cases and shapes it keeps: head_dim 64, 4 kv heads, 8 query
heads, pages of 128 tokens, T = 64 / 4,096 / 4,128).

On the card it first builds the three ``.cu`` sources (one ``nvcc`` each,
all at once) and prints each one's seconds, then launches every kernel
and holds it to its plain version on the same inputs: attention in f32
within atol/rtol 2e-5 (bf16 pages) or 1e-3 / 1e-2 (int8 pages), and in
bf16 within 3e-2; K3 exact in f32 and within one bf16 rounding of
max|ref| in bf16; K4 within 1e-5 of max|ref| in f32 and 2^-8 |ref| +
1e-5 max|ref| in bf16; K5 exact; the KV write (no kernel: PyTorch's
``index_copy_``) byte-equal to a row-by-row write. With ``--device cpu``
(the counterpart of ``--interpret``) the same cases run through the
plain versions, which the wrappers run for CPU tensors.

Cases: ``decode/{bf16,int8}`` (K1; the current token's K/V read from the
cache, as the JAX tool's non-deferred call holds it there) and
``/deferred`` (fresh K/V); ``prefill/{bf16,int8}`` (K2 at start 0, the
chunk's K/V read from the cache) and ``/deferred/{hit,fullhit}`` (fresh
K/V after a one-page prefix hit, and the full-hit replay row);
``append_block/{bf16,int8}``; ``i8i8/{2d,fused-c-leading,prefill-tile}``
and ``w4a8/{2d,fused-c-leading,prefill-tile,down-proj-g44}`` (the 2d and
fused cases also run their first 8 rows, the decode tile); on the card
only ``i8i8/7b-downproj-tile`` and ``w4a8/7b-downproj-tile``; and
``page_read`` (K5). Prints ``ok`` or ``FAIL`` a case, then ``ALL OK`` or
``FAILURES PRESENT``, and exits 1 on a failure.

    python -m ppl.llm.serving_tpu_torch.tools.validate_kernels
    python -m ppl.llm.serving_tpu_torch.tools.validate_kernels --device cpu
"""

from __future__ import annotations

import argparse
import dataclasses
import sys
import time
from typing import Callable, Dict, Optional, Sequence

import numpy as np
import torch

from ppl.llm.serving_tpu_torch.ops import attention as attn_ops
from ppl.llm.serving_tpu_torch.ops import kv_cache as kv_ops
from ppl.llm.serving_tpu_torch.ops import quant as quant_ops
from ppl.llm.serving_tpu_torch.ops.kernels import _build
from ppl.llm.serving_tpu_torch.ops.kernels import cache_read
from ppl.llm.serving_tpu_torch.ops.kernels import paged_attention as pk
from ppl.llm.serving_tpu_torch.ops.kernels import quant_matmul as qk
from ppl.llm.serving_tpu_torch.resources import require_device

HD, KVH, HQ, PS, L, NPAGES, B = 64, 4, 8, 128, 2, 8, 8
BF16_TOL = 3e-2
F32_TOL = 2e-5
INT8_KV_TOL = (1e-3, 1e-2)     # atol, rtol
W4_REL = 1e-5


class Mismatch(AssertionError):
    pass


def close(what: str, out: torch.Tensor, ref: torch.Tensor, atol: float,
          rtol: float = 0.0) -> None:
    diff = (out.float() - ref.float()).abs()
    if not bool((diff <= atol + rtol * ref.float().abs()).all()):
        raise Mismatch(f"{what}: max|diff| {float(diff.max()):.3g} beyond "
                       f"atol {atol:g} rtol {rtol:g}")


def exact(what: str, out: torch.Tensor, ref: torch.Tensor) -> None:
    if out.shape != ref.shape or not torch.equal(out, ref):
        diff = (out.float() - ref.float()).abs().max() if \
            out.shape == ref.shape else "shape"
        raise Mismatch(f"{what}: not exact (max|diff| {diff})")


def spec_of(quant: bool, dtype=torch.bfloat16) -> kv_ops.CacheSpec:
    return kv_ops.CacheSpec(num_layers=L, num_pages=NPAGES, page_size=PS,
                            num_kv_heads=KVH, head_dim=HD,
                            quant_bit=8 if quant else 0,
                            quant_group=8 if quant else 1, dtype=dtype)


def packed_rows(spec: kv_ops.CacheSpec, k: torch.Tensor, v: torch.Tensor):
    """float K/V [..., KVH, hd] -> (packed rows in the cache dtype, bf16
    scale rows or None), as the step packs them."""
    if not spec.quantized:
        return kv_ops.pack_kv_rows(k.to(spec.dtype), v.to(spec.dtype),
                                   spec), None
    qk_, sk = kv_ops.quantize_kv(k, spec.quant_group)
    qv, sv = kv_ops.quantize_kv(v, spec.quant_group)
    return (kv_ops.pack_kv_rows(qk_, qv, spec),
            kv_ops.pack_scale_rows(sk, sv, spec))


def random_cache(spec: kv_ops.CacheSpec, rng: np.random.RandomState, dev):
    """Every slot of the cache holds N(0, 1) K/V (quantized as the step
    quantizes them when int8)."""
    n = spec.num_layers * spec.num_slots
    k, v = (torch.from_numpy(rng.randn(n, KVH, HD).astype(np.float32))
            for _ in range(2))
    rows, srows = packed_rows(spec, k, v)
    cache = rows.permute(1, 0, 2).contiguous().to(dev)
    return cache, None if srows is None else srows.contiguous().to(dev)


def slot_rows(page_table: torch.Tensor, pos: torch.Tensor, layer: int,
              spec: kv_ops.CacheSpec) -> torch.Tensor:
    """Cache rows of positions ``pos`` [B, N] of each page-table row."""
    pages = torch.gather(page_table.long(), 1, (pos // spec.page_size).long())
    return layer * spec.num_slots + pages * spec.page_size + pos % \
        spec.page_size


class Validator:
    """The cases of one run on ``dev``: each launches a kernel (or, on the
    CPU, its wrapper runs the plain version) and holds it to the plain
    version on the same inputs."""

    def __init__(self, dev: torch.device, log: Callable[[str], None]):
        self.dev = dev
        self.log = log
        self.rng = np.random.RandomState(0)
        self.results: Dict[str, bool] = {}

    def t(self, shape, dtype=torch.float32) -> torch.Tensor:
        return torch.from_numpy(self.rng.randn(*shape).astype(
            np.float32)).to(dtype).to(self.dev)

    def check(self, name: str, fn: Callable[[], None]) -> bool:
        t0 = time.perf_counter()
        try:
            fn()
            if self.dev.type == "cuda":
                torch.cuda.synchronize(self.dev)
            self.log(f"  ok   {name}  ({time.perf_counter() - t0:.1f}s)")
            ok = True
        except Exception as e:  # noqa: BLE001 - every case reports
            self.log(f"  FAIL {name}: {type(e).__name__}: {str(e)[:300]}")
            ok = False
        self.results[name] = ok
        return ok

    # -- attention (K1, K2) and the KV write -------------------------------

    def attention_cases(self, quant: bool) -> None:
        tag = "int8" if quant else "bf16"
        spec = spec_of(quant)
        cache, scale = random_cache(spec, self.rng, self.dev)
        pt = torch.from_numpy(self.rng.randint(0, NPAGES, (B, 2)).astype(
            np.int32)).to(self.dev)
        ctx = torch.from_numpy(self.rng.randint(1, 250, B).astype(
            np.int32)).to(self.dev)
        q = self.t((B, HQ, HD))
        layer = 1
        f32_tol = INT8_KV_TOL if quant else (F32_TOL, F32_TOL)

        def variants():
            """(dtype, spec, cache) of the bf16 run and the f32 run."""
            yield torch.bfloat16, spec, cache
            s32 = dataclasses.replace(spec, dtype=torch.float32)
            yield torch.float32, s32, cache if quant else cache.float()

        def decode(fresh_k, fresh_v):
            for dtype, sp, c in variants():
                kw = dict(layer=layer, fresh_k=fresh_k.to(dtype),
                          fresh_v=fresh_v.to(dtype))
                out = pk.paged_decode_attention(q.to(dtype), c, scale, pt,
                                                ctx, sp, **kw)
                ref = attn_ops.decode_attention_ref(q.to(dtype), c, scale, pt,
                                                    ctx, sp, **kw)
                tol = (BF16_TOL, 0.0) if dtype == torch.bfloat16 else f32_tol
                close(f"K1 {dtype}", out, ref, *tol)

        def current_token():
            # the current token's K/V from the cache (ctx - 1), dequantized
            k, v = kv_ops.gather_pages(cache, scale, pt, spec, torch.float32,
                                       layer)
            idx = (ctx.long() - 1)[:, None, None, None].expand(B, 1, KVH, HD)
            return (torch.gather(k, 1, idx)[:, 0],
                    torch.gather(v, 1, idx)[:, 0])

        self.check(f"decode/{tag}", lambda: decode(*current_token()))
        self.check(f"decode/{tag}/deferred",
                   lambda: decode(self.t((B, KVH, HD)), self.t((B, KVH, HD))))

        qp = self.t((2, 128, HQ, HD))
        pt2 = pt[:2]

        def prefill(starts, new_len, fresh_kv, fresh_scale):
            start = torch.tensor(starts, dtype=torch.int32, device=self.dev)
            nl = torch.tensor(new_len, dtype=torch.int32, device=self.dev)
            for dtype, sp, c in variants():
                fkv = fresh_kv if quant else fresh_kv.to(dtype)
                args = (qp.to(dtype), c, scale, pt2, start, nl, sp)
                out = pk.paged_prefill_attention(
                    *args, layer=layer, fresh_kv=fkv, fresh_scale=fresh_scale)
                ref = self.prefill_ref(*args, layer=layer, fresh_kv=fkv,
                                       fresh_scale=fresh_scale)
                tol = (BF16_TOL, 0.0) if dtype == torch.bfloat16 else f32_tol
                close(f"K2 {dtype}", out, ref, *tol)

        def from_cache():
            # the chunk's K/V as the cache holds them, positions 0..127
            rows = slot_rows(pt2, torch.arange(128, device=self.dev)
                             .expand(2, 128), layer, spec)
            fkv = cache[:, rows].permute(1, 0, 2, 3).contiguous()
            fsc = None if scale is None else scale[rows].contiguous()
            return fkv, fsc

        self.check(f"prefill/{tag}",
                   lambda: prefill([0, 0], [100, 60], *from_cache()))
        rows, srows = packed_rows(spec, self.t((2, 128, KVH, HD)),
                                  self.t((2, 128, KVH, HD)))
        fkv = rows.permute(0, 2, 1, 3).contiguous()
        for sname, starts in (("hit", [128, 0]), ("fullhit", [255, 0])):
            self.check(f"prefill/{tag}/deferred/{sname}",
                       lambda starts=starts: prefill(
                           starts, [1 if starts[0] % 128 else 100, 60], fkv,
                           srows))

        ks = self.t((L, 8, KVH, HD))
        self.check(f"append_block/{tag}",
                   lambda: self.append_block(spec, cache, scale, ks))

    @staticmethod
    def prefill_ref(q, cache, scale, page_table, start, new_len, spec, *,
                    layer, fresh_kv, fresh_scale):
        """K2's plain version over the packed fresh slab, dequantized as
        the kernel reads it."""
        fk = fresh_kv[..., :HD].permute(0, 2, 1, 3)
        fv = fresh_kv[..., spec.shd:spec.shd + HD].permute(0, 2, 1, 3)
        if spec.quantized:
            s = fresh_scale[..., :KVH * spec.scale_lane_stride].reshape(
                *fk.shape[:2], KVH, 2, spec.scale_groups)
            fk = kv_ops.dequantize_kv(fk, s[..., 0, :], spec.quant_group,
                                      q.dtype)
            fv = kv_ops.dequantize_kv(fv, s[..., 1, :], spec.quant_group,
                                      q.dtype)
        return attn_ops.prefill_attention_ref(
            q, cache, scale, page_table, start, new_len, spec, layer=layer,
            fresh_k=fk, fresh_v=fv)

    def append_block(self, spec, cache, scale, ks) -> None:
        """The all-layer KV write on ``dev`` against a row-by-row write on
        the CPU: the same bytes."""
        rows, srows = packed_rows(spec, ks, ks)
        slots = torch.arange(8, dtype=torch.int32, device=self.dev)
        c, s = cache.clone(), None if scale is None else scale.clone()
        kv_ops.append_kv_rows_block(c, s, rows, srows, slots, spec)
        want_c = cache.cpu().clone()
        want_s = None if scale is None else scale.cpu().clone()
        for layer in range(spec.num_layers):
            for t in range(8):
                row = layer * spec.num_slots + t
                want_c[:, row] = rows[layer, t].cpu()
                if want_s is not None:
                    want_s[row] = srows[layer, t].cpu()
        exact("cache rows", c.cpu(), want_c)
        if want_s is not None:
            exact("scale rows", s.cpu(), want_s)

    # -- the matmuls (K3, K4) and the page read (K5) ------------------------

    def i8i8(self, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
             decode_rows: int = 0) -> None:
        for rows in (x.shape[0],) + ((decode_rows,) if decode_rows else ()):
            xr = x[:rows].contiguous()
            ref = quant_ops.i8i8_matmul(xr, w, s)
            exact(f"K3 T={rows} f32", qk.i8i8_matmul(xr, w, s), ref)
            out = qk.i8i8_matmul(xr, w, s, out_dtype=torch.bfloat16)
            close(f"K3 T={rows} bf16", out, ref,
                  float(ref.abs().max()) * 2.0 ** -8)

    def w4a8(self, x: torch.Tensor, w: torch.Tensor, s: torch.Tensor,
             decode_rows: int = 0) -> None:
        for rows in (x.shape[0],) + ((decode_rows,) if decode_rows else ()):
            xr = x[:rows].contiguous()
            ref = quant_ops.w4a8_matmul(xr, w, s)
            scale = float(ref.abs().max())
            close(f"K4 T={rows} f32", qk.w4a8_matmul(xr, w, s), ref,
                  W4_REL * scale)
            out = qk.w4a8_matmul(xr, w, s, out_dtype=torch.bfloat16)
            close(f"K4 T={rows} bf16", out, ref, W4_REL * scale, 2.0 ** -8)

    def int8(self, shape, lo=-127, hi=127) -> torch.Tensor:
        return torch.from_numpy(self.rng.randint(lo, hi, shape).astype(
            np.int8)).to(self.dev)

    def scales(self, shape) -> torch.Tensor:
        return torch.from_numpy((self.rng.rand(*shape) * 1e-2 + 1e-3)
                                .astype(np.float32)).to(self.dev)

    def matmul_cases(self, card_only: bool) -> None:
        x = self.t((64, 2048), torch.bfloat16)
        w2, s2 = self.int8((2048, 512)), self.scales((512,))
        self.check("i8i8/2d", lambda: self.i8i8(x, w2, s2, 8))
        wf, sf = self.int8((2, 2048, 512)), self.scales((2, 512))
        self.check("i8i8/fused-c-leading", lambda: self.i8i8(x, wf, sf, 8))
        xp = self.t((4096, 2048), torch.bfloat16)
        self.check("i8i8/prefill-tile", lambda: self.i8i8(xp, w2, s2))

        w4, s4 = self.int8((1024, 512), -128), self.scales((16, 512))
        self.check("w4a8/2d", lambda: self.w4a8(x, w4, s4, 8))
        w4f, s4f = self.int8((2, 1024, 512), -128), self.scales((2, 16, 512))
        self.check("w4a8/fused-c-leading",
                   lambda: self.w4a8(x, w4f, s4f, 8))
        self.check("w4a8/prefill-tile", lambda: self.w4a8(xp, w4, s4))
        # down-proj shape: 44 groups of 128 over D = 5632
        xd = self.t((64, 5632), torch.bfloat16)
        w4d, s4d = self.int8((2816, 512), -128), self.scales((44, 512))
        self.check("w4a8/down-proj-g44", lambda: self.w4a8(xd, w4d, s4d))
        if card_only:
            # LLaMA-2-7B's down projection at the prefill tile (D = 11008,
            # T = 4128); card only, as in the JAX tool
            x7 = self.t((4128, 11008), torch.bfloat16)
            w7, s7 = self.int8((11008, 512)), self.scales((512,))
            self.check("i8i8/7b-downproj-tile", lambda: self.i8i8(x7, w7, s7))
            w47, s47 = self.int8((5504, 512), -128), self.scales((86, 512))
            self.check("w4a8/7b-downproj-tile",
                       lambda: self.w4a8(x7, w47, s47))

    def page_read_case(self) -> None:
        spec = spec_of(True)
        cache = self.int8((KVH, L * spec.num_slots, spec.row_lanes), -128)
        self.check("page_read", lambda: exact(
            "K5", cache_read.page_read(cache, rows=8, page_size=PS),
            cache_read.page_read_ref(cache, 8)))


def build_kernels(log: Callable[[str], None]) -> None:
    """Build the three sources (one nvcc each, all at once) and print each
    one's seconds (or that it was built before)."""
    t0 = time.perf_counter()
    _build.build_seconds.clear()
    _build.build_all()
    for name in _build.SOURCES:
        secs = _build.build_seconds.get(name)
        log(f"nvcc {name}.cu: "
            + (f"{secs:.1f} s" if secs is not None else
               f"built before ({_build.library_path(name).name})"))
    log(f"build: {time.perf_counter() - t0:.1f} s in all")


def run(device: str = "cuda", log: Callable[[str], None] = print
        ) -> Dict[str, bool]:
    """Every case on ``device``; returns ``{case: ok}``. Raises when cuda
    is asked for and there is none."""
    dev = require_device(device)
    if dev.type == "cuda":
        log(f"device={dev} ({torch.cuda.get_device_name(dev)})")
        build_kernels(log)
    else:
        log("device=cpu (the plain versions)")
    v = Validator(dev, log)
    for quant in (False, True):
        v.attention_cases(quant)
    v.matmul_cases(card_only=dev.type == "cuda")
    v.page_read_case()
    return v.results


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="cpu: the same cases through the plain versions")
    args = p.parse_args(argv)
    results = run(args.device)
    ok = all(results.values())
    print("ALL OK" if ok else "FAILURES PRESENT", flush=True)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
