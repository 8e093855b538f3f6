#!/usr/bin/env python3
"""The mma.sync throughput ceiling of the card: int8 IMMA (m16n8k32) and
bf16 HMMA (m16n8k16) issued back to back from registers by
``csrc/mma_ceiling.cu``, at 1, 2 and 4 CTAs of 8 warps per SM.

K3's two tiles and K2's bf16 body are built on mma.sync, so the rate
this reaches, not the data sheet's tensor-core peak (which is wgmma's),
is the most they could do. Needs a CUDA device:

    python -m ppl.llm.serving_tpu_torch.tools.mma_ceiling [--iters 4000]
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess

import torch

from ppl.llm.serving_tpu_torch.ops.kernels import _build

# (name, int8 flag, operations per mma: 2 * m * n * k)
SHAPES = (("IMMA m16n8k32 s8", 1, 2 * 16 * 8 * 32),
          ("HMMA m16n8k16 bf16", 0, 2 * 16 * 8 * 16))
THREADS = 256          # 8 warps a CTA
MMAS_PER_ITER = 16     # independent accumulators a warp (mma_loop)


def run(device: str = "cuda", iters: int = 4000) -> dict:
    """{shape name: {CTAs per SM: TOP/s}} on ``device``."""
    dev = torch.device(device)
    if dev.type != "cuda":
        raise ValueError(f"mma_ceiling measures a CUDA device, not {dev}")
    lib = _build.load("mma_ceiling")
    lib.ppl_mma_ceiling.argtypes = [ctypes.c_int, ctypes.c_void_p,
                                    ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                    ctypes.c_void_p]
    lib.ppl_mma_ceiling.restype = ctypes.c_int
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = torch.empty(4 * sms * THREADS, dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    result = {}
    for name, int8, ops_per_mma in SHAPES:
        rates = {}
        for per_sm in (1, 2, 4):
            blocks = per_sm * sms

            def launch(n):
                err = lib.ppl_mma_ceiling(int8, out.data_ptr(), blocks,
                                          THREADS, n, stream)
                if err:
                    raise RuntimeError(f"mma_ceiling: launch failed "
                                       f"(cudaError {err})")

            launch(10)
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            launch(iters)
            end.record()
            torch.cuda.synchronize(dev)
            ms = start.elapsed_time(end)
            mmas = blocks * THREADS // 32 * iters * MMAS_PER_ITER
            rates[per_sm] = mmas * ops_per_mma / (ms * 1e-3) / 1e12
        result[name] = rates
    return result


def main() -> None:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--iters", type=int, default=4000)
    args = p.parse_args()
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip().splitlines()[0] if card.strip() else "card: ?")
    for name, rates in run(iters=args.iters).items():
        print(f"{name}: " + ", ".join(f"{n} CTA/SM {r:,.0f} TOP/s"
                                      for n, r in rates.items()))


if __name__ == "__main__":
    main()
