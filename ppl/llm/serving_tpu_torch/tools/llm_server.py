#!/usr/bin/env python3
"""The port's serving daemon: wires config -> engine -> generator -> gRPC
frontend and serves ``LLMService.Generation`` streams, wire-compatible
with the JAX package's server and its clients.

    python -m ppl.llm.serving_tpu_torch.tools.llm_server \\
        --model-dir <HF checkpoint dir> [--device cpu] [--port 23333]
    python -m ppl.llm.serving_tpu_torch.tools.llm_server \\
        --model-format random --model-param-path params.json \\
        --tokenizer-type dummy [--device cpu] [--port 23333]

:func:`build_server` does the wiring and returns the bound, not yet
started server; :func:`main` calls it and serves until killed.
"""

import argparse
import dataclasses
import faulthandler
import os
import signal
import sys
from typing import List, Optional, Sequence

import torch

from ppl.llm.serving_tpu_torch import __version__
from ppl.llm.serving_tpu_torch.config import ConfigError, not_ported
from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.ops.kernels import _build
from ppl.llm.serving_tpu_torch.resources import (create_engine,
                                                 require_device)
from ppl.llm.serving_tpu_torch.serving.grpc_server import (AsyncGRPCServer,
                                                           GRPCConnection,
                                                           GRPCServer)
from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer
from ppl.llm.serving_tpu_torch.tools.common import (add_generator_args,
                                                    add_model_args,
                                                    build_configs,
                                                    setup_logging)

# flags of the JAX tool that the port refuses unless left at their
# default: CUDA graphs captured at startup take the place of the AOT
# store and the warm-up manifest, and multi-host serving is not ported
_NOT_PORTED = (("aot_cache", "", "--aot-cache (the AOT executable store)"),
               ("warmup_manifest", "", "--warmup-manifest"),
               ("coordinator_address", None,
                "--coordinator-address (multi-host serving)"),
               ("num_processes", None, "--num-processes (multi-host serving)"),
               ("process_id", None, "--process-id (multi-host serving)"))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=__doc__)
    add_model_args(parser)
    add_generator_args(parser)
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=23333,
                        help="0 = any free port (printed)")
    parser.add_argument("--validate-bucket-grid", type=int, default=1,
                        help="cuda: warm up and capture the extreme "
                             "bucket programs at startup and clamp "
                             "max_running_batch to what fits device "
                             "memory; nothing is captured while serving "
                             "(0 = no validation, refused without "
                             "--kv-cache-max-tokens: each key is captured "
                             "at its second visit). The CPU has nothing "
                             "to capture or run out of: no validation "
                             "there")
    parser.add_argument("--grpc-max-workers", type=int, default=1024,
                        help="threads impl only: max CONCURRENT client "
                             "streams (each holds a pool thread)")
    parser.add_argument("--grpc-impl", default="aio",
                        choices=["aio", "threads"],
                        help="aio: one coroutine per stream; threads: one "
                             "parked pool thread per stream")
    parser.add_argument("--data-parallel-size", type=int, default=1,
                        help="replica engines behind this frontend; on "
                             "cuda replica i runs on cuda:i")
    parser.add_argument("--monitor-port", type=int, default=0,
                        help="serve Prometheus metrics on this port "
                             "(0 = off)")
    parser.add_argument("--aot-cache", default="", help=argparse.SUPPRESS)
    parser.add_argument("--warmup-manifest", default="",
                        help=argparse.SUPPRESS)
    parser.add_argument("--coordinator-address", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--num-processes", type=int, default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--process-id", type=int, default=None,
                        help=argparse.SUPPRESS)
    # accepted for reference-CLI compatibility; nothing serves it
    parser.add_argument("--control-port", type=int, default=0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--version", action="version",
                        version=f"ppl-llm-serving-tpu-torch {__version__}")
    return parser


def replica_devices(device: str, dp: int) -> List[str]:
    """The device of each data-parallel replica: ``cuda:i`` for replica i
    on cuda (more replicas than GPUs raises), the CPU shared otherwise."""
    if dp < 1:
        raise ValueError(f"--data-parallel-size must be >= 1, got {dp}")
    if device == "cpu":
        return ["cpu"] * dp
    if dp == 1:
        return [device]
    if dp > torch.cuda.device_count():
        raise RuntimeError(f"--data-parallel-size {dp} needs {dp} GPUs, "
                           f"PyTorch sees {torch.cuda.device_count()}")
    return [f"cuda:{i}" for i in range(dp)]


def build_server(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` and wire the server as the CLI does; returns
    ``(server, generator, engine)``: the gRPC frontend bound to its port
    (``server.port``), not started; the generator (a
    :class:`DataParallelRouter` over the replicas' generators when
    ``--data-parallel-size`` > 1) with its generate thread running; the
    engine (replica 0's). The caller starts the server (``start()`` or
    ``loop()``), then stops it and shuts the generator down."""
    args = build_parser().parse_args(argv)
    for name, default, flag in _NOT_PORTED:
        if getattr(args, name) != default:
            raise not_ported(flag)
    model_cfg, resource_cfg, gen_cfg = build_configs(args)
    if (resource_cfg.device != "cpu" and not args.validate_bucket_grid
            and not resource_cfg.kv_cache_max_tokens):
        # the auto-sized pool is sized after the validated graphs; without
        # them it takes the memory that lazy captures would need
        raise ConfigError("--validate-bucket-grid 0 needs an explicit "
                          "--kv-cache-max-tokens: an auto-sized KV pool "
                          "leaves no room for graphs captured while "
                          "serving")
    validate = bool(args.validate_bucket_grid) and \
        resource_cfg.device != "cpu"
    devices = replica_devices(resource_cfg.device, args.data_parallel_size)
    tokenizer = create_tokenizer(args.model_type, resource_cfg.tokenizer_path,
                                 args.tokenizer_type,
                                 args.tokenizer_config_path or None)
    conn = GRPCConnection()
    # every replica's engine (and its startup captures) before any
    # generate thread starts
    built = []
    for dev in devices:
        engine, kv_max, max_running_batch = create_engine(
            model_cfg, dataclasses.replace(resource_cfg, device=dev),
            gen_cfg, validate_grid=validate)
        if len(devices) > 1 and not validate:
            # replicas capture lazily, each on its own generate thread
            # while the others dispatch (LLMEngine.capture_error_mode)
            engine.capture_error_mode = "thread_local"
        built.append((engine, kv_max, max_running_batch))
    clamped = min(b[2] for b in built)
    if clamped < gen_cfg.max_running_batch:
        print(f"[WARN] bucket grid clamped: max_running_batch "
              f"{gen_cfg.max_running_batch} -> {clamped} (largest decode "
              f"bucket that fits device memory)", flush=True)
        gen_cfg.max_running_batch = clamped
    gens = [LLMGenerator(model_cfg, gen_cfg, engine, tokenizer, conn, kv_max)
            for engine, kv_max, _ in built]
    if len(gens) > 1:
        from ppl.llm.serving_tpu_torch.serving.dp_router import (
            DataParallelRouter)
        generator = DataParallelRouter(gens)
    else:
        generator = gens[0]

        def fatal_exit():
            # the device is gone: every dispatch fails, only a restart of
            # the process recovers; exit loudly for the supervisor
            print("[FATAL] device backend lost - exiting for supervisor "
                  "restart", flush=True)
            os._exit(13)

        generator.on_fatal = fatal_exit
    server_cls = AsyncGRPCServer if args.grpc_impl == "aio" else GRPCServer
    server = server_cls(conn, generator.process, generator.clear_task,
                        max_workers=args.grpc_max_workers)
    server.init(args.host, args.port)
    if args.monitor_port:
        from ppl.llm.serving_tpu_torch.serving.metrics import MetricsServer
        metrics = MetricsServer(gens[0].profiler, args.monitor_port)
        metrics.start()
        server.on_stop.append(metrics.stop)
    return server, generator, built[0][0]


def main(argv: Optional[Sequence[str]] = None) -> None:
    setup_logging()
    # crash backtraces, also on SIGTERM
    faulthandler.enable()
    faulthandler.register(signal.SIGTERM, chain=True)
    if require_device(build_parser().parse_args(argv).device).type == "cuda":
        # every CUDA source at once (one nvcc each, each logged with its
        # seconds), where the first launches would build them one by one
        _build.build_all()
    server, _, engine = build_server(argv)
    print(f"[INFO] listening on port {server.port} ({engine.device})",
          flush=True)
    server.loop()


if __name__ == "__main__":
    sys.exit(main())
