"""The system under test, built inside the run's process: the port's
gRPC ``LLMService`` wired as ``tools/llm_server.build_server`` wires a
one-card server (``create_engine`` -> ``LLMGenerator`` ->
``AsyncGRPCServer`` on port 0), with the weights drawn on the device from
the run's seed.

The configuration file is the server's ``params.json`` as it runs; its
``server_flags`` are the server's command-line flags, parsed by the
server's own parser. The harness reads the program only through these
entry points, the generator's profiler counters and the engine's graph
and program-key reports.
"""

from __future__ import annotations

import gc
import time
from typing import Dict, List, Optional

import torch

from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.resources import create_engine
from ppl.llm.serving_tpu_torch.serving.grpc_server import (AsyncGRPCServer,
                                                           GRPCConnection)
from ppl.llm.serving_tpu_torch.tools.common import build_configs
from ppl.llm.serving_tpu_torch.tools.llm_server import build_parser


def server_argv(config_path: str, config: Dict, device: str,
                manifest: str, quant_method: Optional[str] = None
                ) -> List[str]:
    argv = ["--model-format", "random", "--model-param-path", config_path,
            "--device", device, *config["server_flags"]]
    if manifest:
        argv += ["--warmup-manifest", manifest]
    if quant_method:
        argv += ["--quant-method", quant_method]
    return argv


class PortServer:
    """Build, serve and free the port's server; ``setup`` holds the
    seconds of each part of its set-up."""

    def __init__(self, config_path: str, config: Dict, seed: int,
                 device: str, manifest: str = "",
                 quant_method: Optional[str] = None):
        self.setup: Dict[str, float] = {}
        self.device = device
        args = build_parser().parse_args(server_argv(
            config_path, config, device, manifest, quant_method))
        model_cfg, resource_cfg, gen_cfg = build_configs(args)
        cuda = device != "cpu"
        t = time.monotonic()
        if cuda:
            # every CUDA source at once, as the server's main does
            from ppl.llm.serving_tpu_torch.ops.kernels import _build
            _build.build_all()
            self.setup["kernels_s"] = time.monotonic() - t
            t = time.monotonic()
        self.engine, self.kv_max, max_running_batch = create_engine(
            model_cfg, resource_cfg, gen_cfg, rng_seed=seed,
            validate_grid=cuda and bool(args.validate_bucket_grid),
            warmup_manifest=args.warmup_manifest)
        self.setup["engine_s"] = time.monotonic() - t
        t = time.monotonic()
        gen_cfg.max_running_batch = min(gen_cfg.max_running_batch,
                                        max_running_batch)
        self.model_cfg, self.gen_cfg = model_cfg, gen_cfg
        self.conn = GRPCConnection()
        self.generator = LLMGenerator(model_cfg, gen_cfg, self.engine, None,
                                      self.conn, self.kv_max)
        self.grpc = AsyncGRPCServer(self.conn, self.generator.process,
                                    self.generator.clear_task)
        self.port = self.grpc.init("127.0.0.1", 0)
        self.grpc.start()
        self.setup["serve_s"] = time.monotonic() - t

    def counters(self) -> Dict:
        """The program's counters now: the profiler's prompt tokens taken
        in and prefix-cache hits, the engine's graphs and eager
        dispatches."""
        g = self.generator.profiler.global_
        graphs = self.engine.graph_stats()
        return dict(input_tokens=g.input_token_cnt,
                    cache_hits=g.cache_hit_count, graphs=graphs["graphs"],
                    eager_visits=graphs["eager_visits"])

    def stop(self) -> None:
        """Stop serving and free the program's device state."""
        self.grpc.stop()
        self.generator.shutdown()
        self.engine.release_graphs()
        self.generator = self.engine = self.grpc = self.conn = None
        gc.collect()
        if self.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
