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

Tensor parallelism: ``--tensor-parallel-size N`` on one host starts N-1
worker ranks itself, one process a card (rank r on ``cuda:r``); this
process is rank 0, the controller and frontend. With
``--coordinator-address host:port --num-processes N --process-id i`` the
same command runs as one rank on every host (the JAX tool's contract):
process 0 serves the TCP store at that address and the frontend, the
others execute the controller's plans in lockstep
(``parallel/multihost.py``); rank i runs on ``cuda:<i mod the host's
cards>``. A rank that fails ends every rank with a nonzero exit, and
every request in flight with a failed status.

Data parallelism: ``--data-parallel-size D`` puts D replicas behind one
frontend and one ``DataParallelRouter`` (requests dealt round robin,
cancels sent to their owner). At tp=1 they are engines of this process,
replica i on ``cuda:i``. With ``--tensor-parallel-size T`` > 1 each
replica is a tensor-parallel group of its own on ``cuda:[i*T,
(i+1)*T)``: this process is replica 0's controller and starts its
workers; replica i > 0's controller is a child process that starts its
own (``serving/replicas.py``). A dead rank or replica controller fails
every request in flight (a FAILED status) and ends every process with a
nonzero exit. The monitor port serves replica 0's
profiler.

SIGINT stops the server cleanly (every rank and replica) and prints the
kernel launches this process made while serving.
"""

import argparse
import dataclasses
import faulthandler
import functools
import json
import os
import signal
import subprocess
import sys
import threading
import time
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ppl.llm.serving_tpu_torch import __version__
from ppl.llm.serving_tpu_torch.config import ConfigError, not_ported
from ppl.llm.serving_tpu_torch.generator import LLMGenerator
from ppl.llm.serving_tpu_torch.ops import kernels
from ppl.llm.serving_tpu_torch.ops.kernels import _build
from ppl.llm.serving_tpu_torch.parallel import multihost, shardings
from ppl.llm.serving_tpu_torch.resources import (create_engine,
                                                 require_device)
from ppl.llm.serving_tpu_torch.serving import replicas
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
# store and the warm-up manifest
_NOT_PORTED = (("aot_cache", "", "--aot-cache (the AOT executable store)"),
               ("warmup_manifest", "", "--warmup-manifest"))
# the repository root, for the worker ranks this server starts
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.dirname(os.path.abspath(__file__))))))


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
                        help="replicas behind this frontend; on cuda "
                             "replica i runs on cuda:i, or with "
                             "--tensor-parallel-size T on cuda:[i*T, "
                             "(i+1)*T), one process a card")
    parser.add_argument("--monitor-port", type=int, default=0,
                        help="serve Prometheus metrics on this port "
                             "(0 = off)")
    parser.add_argument("--aot-cache", default="", help=argparse.SUPPRESS)
    parser.add_argument("--warmup-manifest", default="",
                        help=argparse.SUPPRESS)
    # multi-process tensor parallelism: the same command on every rank
    parser.add_argument("--coordinator-address", default=None,
                        help="host:port of the TCP store process 0 "
                             "serves; one process a rank")
    parser.add_argument("--num-processes", type=int, default=None)
    parser.add_argument("--process-id", type=int, default=None)
    # set on the worker ranks this server starts itself
    parser.add_argument("--exit-with-parent", action="store_true",
                        help=argparse.SUPPRESS)
    # the first card of this rank's group (rank r on cuda:first + r), and
    # a replica controller's channel to the frontend
    parser.add_argument("--first-device", type=int, default=0,
                        help=argparse.SUPPRESS)
    parser.add_argument("--replica-channel", default=None,
                        help=argparse.SUPPRESS)
    parser.add_argument("--replica-index", type=int, default=None,
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


def drop_flags(argv: Sequence[str], flags: Dict[str, bool]) -> List[str]:
    """``argv`` without the flags in ``flags`` (name -> whether it takes a
    value), given as ``--flag value`` or ``--flag=value``."""
    out, skip = [], False
    for a in argv:
        if skip:
            skip = False
            continue
        name, eq, _ = a.partition("=")
        if name in flags:
            skip = flags[name] and not eq
            continue
        out.append(a)
    return out


def start_process(argv: Sequence[str],
                  env: Optional[Dict[str, str]] = None) -> subprocess.Popen:
    """This tool in a process of its own (a worker rank or a replica's
    controller), importable from the repository's root."""
    env = dict(os.environ if env is None else env)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, (
        _ROOT, env.get("PYTHONPATH"))))
    return subprocess.Popen([sys.executable, "-m", "ppl.llm.serving_tpu_torch"
                             ".tools.llm_server", *argv], env=env)


def refuse_dp_with_coordinator(args) -> None:
    """The JAX tool's rule: one multi-process group serves one replica."""
    if args.data_parallel_size > 1 and args.coordinator_address is not None:
        raise ConfigError("--data-parallel-size is incompatible with the "
                          "multi-host controller mode; run one server "
                          "process per dp replica set")


def group_devices(device: str) -> List[str]:
    """Every rank's device, by rank, as each rank names its own: a gather
    over gloo that every rank of the group makes."""
    index = -1 if device == "cpu" else torch.device(device).index
    got = [torch.zeros(1, dtype=torch.int64)
           for _ in range(dist.get_world_size())]
    dist.all_gather(got, torch.tensor([index], dtype=torch.int64))
    return ["cpu" if int(t) < 0 else f"cuda:{int(t)}" for t in got]


def join_group(args, resource_cfg, argv: Optional[Sequence[str]] = None
               ) -> Tuple[shardings.TPGroup, List[subprocess.Popen], object,
                          List[str]]:
    """Make this process one rank of the tensor-parallel group: returns
    (its group, the worker processes it started, ``resource_cfg`` on the
    rank's device, every rank's device by rank). Rank r runs on
    ``cuda:<--first-device + r>`` (modulo the host's cards). Without
    ``--coordinator-address`` this process is rank 0 of one host: it
    serves the TCP store on a port the OS picks and starts ranks 1..N-1
    with ``argv`` (raises when there are fewer cards than ranks)."""
    tp_size = resource_cfg.tensor_parallel_size
    cpu = resource_cfg.device == "cpu"
    first = args.first_device
    count = 0 if cpu else torch.cuda.device_count()
    if not cpu and count < (first + tp_size if args.coordinator_address
                            is None else 1):
        raise RuntimeError(f"--tensor-parallel-size {tp_size} needs "
                           f"{tp_size} GPUs on this host"
                           + (f" from cuda:{first}" if first else "")
                           + f", PyTorch sees {count}")
    store, workers = None, []
    if args.coordinator_address is None:
        rank, world = 0, tp_size
        store = dist.TCPStore("127.0.0.1", 0, tp_size, is_master=True,
                              timeout=multihost.TIMEOUT,
                              wait_for_workers=False)
        argv = drop_flags(sys.argv[1:] if argv is None else argv,
                          {"--data-parallel-size": True})
        workers = [start_process(
            [*argv, "--coordinator-address", f"127.0.0.1:{store.port}",
             "--num-processes", str(tp_size), "--process-id", str(i),
             "--exit-with-parent"]) for i in range(1, tp_size)]
    else:
        rank, world = args.process_id, args.num_processes
        if rank is None or world is None:
            raise ConfigError("--coordinator-address needs --num-processes "
                              "and --process-id")
        if world != tp_size:
            raise ConfigError(
                f"--num-processes {world} must equal --tensor-parallel-size "
                f"{tp_size}: one process a rank of one tensor-parallel "
                "group (replicas of groups: --data-parallel-size without "
                "--coordinator-address)")
    device = "cpu" if cpu else f"cuda:{(first + rank) % count}"
    if not cpu:
        torch.cuda.set_device(device)
    multihost.initialize(args.coordinator_address, world, rank,
                         device=device, store=store)
    return (shardings.make_group(tp_size), workers,
            dataclasses.replace(resource_cfg, device=device),
            group_devices(device))


def end_all(procs: Sequence[subprocess.Popen], msg: str,
            conn: Optional[GRPCConnection] = None) -> None:
    """A rank or a replica is gone: a ``[FATAL]`` line, every request in
    flight on the frontend's ``conn`` ends with a failed status, every
    process in ``procs`` is killed and this one ends with exit 1."""
    print(f"[FATAL] {msg}", flush=True)
    if conn is not None:
        conn.fail_all(1, msg)
        # the failed statuses reach their streams before the frontend goes
        time.sleep(1.0)
    for p in procs:
        if p.poll() is None:
            p.kill()
    os._exit(1)


def stop_ranks(workers: List[subprocess.Popen],
               others: Sequence[subprocess.Popen] = (),
               conn: Optional[GRPCConnection] = None
               ) -> Callable[..., List[Optional[int]]]:
    """Watch the worker ranks this server started: one that exits before
    the server stops them ends every process (:func:`end_all`: the
    frontend's ``conn`` fails its requests in flight; the workers and
    ``others``, the other replicas, are killed). Returns ``stop(engine)``
    for the generator's ``on_shutdown``: the stop message to every rank,
    this rank's end in the group, then each started worker's exit; it
    returns the workers' exit codes (None: the group did not end, or a
    worker was killed)."""
    stopping = threading.Event()

    def watch():
        while not stopping.wait(0.5):
            dead = [(r, p) for r, p in enumerate(workers, 1)
                    if p.poll() is not None]
            if dead and not stopping.is_set():
                end_all([*workers, *others],
                        f"tensor-parallel rank {dead[0][0]} exited with "
                        f"{dead[0][1].returncode}; ending every rank", conn)

    def stop(engine) -> List[Optional[int]]:
        stopping.set()
        multihost.broadcast_stop()
        ended = multihost.shutdown(engine)
        codes = []
        for p in workers:
            try:
                codes.append(p.wait(timeout=60))
            except subprocess.TimeoutExpired:
                p.kill()
                p.wait()
                codes.append(None)
        return codes if ended else codes + [None]

    if workers:
        threading.Thread(target=watch, name="rank-watch", daemon=True).start()
    return stop


def serve_worker(args) -> None:
    """A worker rank: its shard of the engine, then the controller's plans
    in lockstep until the stop message."""
    if args.exit_with_parent:
        multihost.exit_with_parent()
    refuse_dp_with_coordinator(args)
    model_cfg, resource_cfg, gen_cfg = build_configs(args)
    tp, _, resource_cfg, _ = join_group(args, resource_cfg)
    validate = bool(args.validate_bucket_grid) and \
        resource_cfg.device != "cpu"
    engine, _, _ = create_engine(model_cfg, resource_cfg, gen_cfg,
                                 validate_grid=validate, tp=tp)
    multihost.worker_serve(engine)
    if not multihost.shutdown(engine):
        sys.stdout.flush()
        os._exit(1)


def serve_replica(args) -> int:
    """Replica ``--replica-index`` i > 0 of a data-parallel set of
    tensor-parallel groups: this process is its controller (rank 0 of its
    own group, on ``cuda:--first-device``) and starts its workers; the
    frontend sends it requests and cancels over ``--replica-channel`` and
    gets every response back (``serving/replicas.py``). Returns the exit
    code: 0 when the group ended and every worker exited with 0."""
    if args.exit_with_parent:
        multihost.exit_with_parent()
    index = args.replica_index
    model_cfg, resource_cfg, gen_cfg = build_configs(args)
    if gen_cfg.trace_dir:
        gen_cfg.trace_dir = os.path.join(gen_cfg.trace_dir, f"replica{index}")
    argv = drop_flags(sys.argv[1:], {"--replica-channel": True,
                                     "--replica-index": True,
                                     "--exit-with-parent": False})
    tp, workers, resource_cfg, devices = join_group(args, resource_cfg, argv)
    stop = stop_ranks(workers)
    validate = bool(args.validate_bucket_grid) and \
        resource_cfg.device != "cpu"
    engine, kv_max, max_running_batch = create_engine(
        model_cfg, resource_cfg, gen_cfg, validate_grid=validate, tp=tp)
    gen_cfg.max_running_batch = min(gen_cfg.max_running_batch,
                                    max_running_batch)
    tokenizer = create_tokenizer(args.model_type, resource_cfg.tokenizer_path,
                                 args.tokenizer_type,
                                 args.tokenizer_config_path or None)
    # connected once built: the frontend takes the replicas' reports in
    # the order they come
    chan = replicas.connect(args.replica_channel)
    gen = LLMGenerator(model_cfg, gen_cfg, engine, tokenizer,
                       replicas.RelayConnection(chan), kv_max,
                       plan_channel=multihost.controller_plan_channel)
    codes: List[Optional[int]] = []
    report = {}

    def finish():
        # after the generate thread, before the graphs go (stop)
        report.update(
            dispatch_counts=dict(engine.dispatch_counts),
            graphs=engine.graph_stats(), launches=kernels.launch_counts(),
            cache_hit_count=gen.profiler.global_.cache_hit_count)
        codes.extend(stop(engine))

    gen.on_shutdown.append(finish)
    chan.send(("ready", dict(index=index, devices=devices, kv_max=kv_max,
                             max_running_batch=max_running_batch,
                             graphs=engine.graph_stats()["graphs"])))
    kernels.reset_launch_counts()
    if not replicas.serve_channel(chan, gen):
        print(f"[FATAL] data-parallel replica {index}: the frontend has "
              "gone; ending its ranks", flush=True)
        for p in workers:
            p.kill()
        os._exit(1)
    gen.shutdown()
    chan.send(("bye", dict(report, worker_exit_codes=codes)))
    chan.close()
    return 0 if all(c == 0 for c in codes) else 1


def _replica_lost(procs: List[subprocess.Popen], conn: GRPCConnection,
                  index: int, returncode: Optional[int]) -> None:
    """A replica's controller ended while serving (its proxy has failed
    its requests in flight): every other process ends, this one with exit
    1."""
    end_all(procs, f"data-parallel replica {index} exited with "
            f"{returncode}; ending every replica", conn)


def build_server(argv: Optional[Sequence[str]] = None):
    """Parse ``argv`` and wire the server as the CLI does; returns
    ``(server, generator, engine)``: the gRPC frontend bound to its port
    (``server.port``), not started; the generator (a
    :class:`DataParallelRouter` over the replicas when
    ``--data-parallel-size`` > 1: their generators, or under tensor
    parallelism a :class:`~..serving.replicas.LocalReplica` and a
    :class:`~..serving.replicas.ReplicaProxy` a child replica) with its
    generate thread running; the engine (replica 0's, or rank 0's under
    tensor parallelism, whose worker ranks the generator's shutdown
    stops). The caller starts the server (``start()`` or ``loop()``),
    then stops it and shuts the generator down."""
    args = build_parser().parse_args(argv)
    for name, default, flag in _NOT_PORTED:
        if getattr(args, name) != default:
            raise not_ported(flag)
    refuse_dp_with_coordinator(args)
    model_cfg, resource_cfg, gen_cfg = build_configs(args)
    dp, tp_size = args.data_parallel_size, resource_cfg.tensor_parallel_size
    parallel = tp_size > 1 or args.coordinator_address is not None
    if parallel and args.process_id not in (None, 0):
        raise ValueError("build_server runs rank 0; a worker rank runs "
                         "serve_worker")
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
    base_argv = drop_flags(sys.argv[1:] if argv is None else argv,
                           {"--data-parallel-size": True})
    children: Dict[int, subprocess.Popen] = {}
    listener = None
    if parallel and dp > 1:
        # each replica a tensor-parallel group of its own: replica i > 0's
        # controller a child process on cuda:i*tp, started first so that
        # the replicas build their weights at the same time
        if (resource_cfg.device != "cpu"
                and torch.cuda.device_count() < dp * tp_size):
            raise RuntimeError(
                f"--data-parallel-size {dp} x --tensor-parallel-size "
                f"{tp_size} needs {dp * tp_size} GPUs, PyTorch sees "
                f"{torch.cuda.device_count()}")
        listener = replicas.ReplicaListener()
        children = {i: start_process(
            [*base_argv, "--first-device", str(i * tp_size),
             "--replica-channel", listener.address, "--replica-index",
             str(i), "--exit-with-parent"], env=listener.child_env(
                 os.environ)) for i in range(1, dp)}
    conn = GRPCConnection()
    try:
        tp, plan_channel, stop, workers = None, None, None, []
        devices0 = None
        if parallel:
            tp, workers, resource_cfg, devices0 = join_group(
                args, resource_cfg, base_argv)
            stop = stop_ranks(workers, list(children.values()), conn)
            plan_channel = multihost.controller_plan_channel
        devices = replica_devices(resource_cfg.device,
                                  1 if children else dp)
        tokenizer = create_tokenizer(args.model_type,
                                     resource_cfg.tokenizer_path,
                                     args.tokenizer_type,
                                     args.tokenizer_config_path or None)
        # every replica's engine (and its startup captures) before any
        # generate thread starts
        built = []
        for dev in devices:
            engine, kv_max, max_running_batch = create_engine(
                model_cfg, dataclasses.replace(resource_cfg, device=dev),
                gen_cfg, validate_grid=validate, tp=tp)
            if len(devices) > 1 and not validate:
                # replicas capture lazily, each on its own generate thread
                # while the others dispatch (LLMEngine.capture_error_mode)
                engine.capture_error_mode = "thread_local"
            built.append((engine, kv_max, max_running_batch))
        ready = (listener.accept(children, multihost.TIMEOUT.total_seconds())
                 if children else {})
    except BaseException:
        for p in children.values():
            p.kill()
        raise
    clamped = min([b[2] for b in built]
                  + [info["max_running_batch"] for _, info in ready.values()])
    if clamped < gen_cfg.max_running_batch:
        print(f"[WARN] bucket grid clamped: max_running_batch "
              f"{gen_cfg.max_running_batch} -> {clamped} (largest decode "
              f"bucket that fits device memory)", flush=True)
        gen_cfg.max_running_batch = clamped
    gens = [LLMGenerator(model_cfg, gen_cfg, engine, tokenizer, conn, kv_max,
                         plan_channel=plan_channel)
            for engine, kv_max, _ in built]
    if stop is not None:
        gens[0].on_shutdown.append(functools.partial(stop, built[0][0]))
    if children:
        log_requests = not args.disable_log_req
        lost = functools.partial(_replica_lost,
                                 [*workers, *children.values()], conn)
        reps = [replicas.LocalReplica(gens[0], devices0, workers,
                                      log_requests)]
        reps += [replicas.ReplicaProxy(i, children[i], *ready[i], conn, lost,
                                       log_requests)
                 for i in sorted(children)]
        for r in reps:
            print(f"[INFO] data-parallel replica {r.index}: tensor-parallel "
                  f"ranks on {', '.join(r.devices)}", flush=True)
    if len(gens) > 1 or children:
        from ppl.llm.serving_tpu_torch.serving.dp_router import (
            DataParallelRouter)
        generator = DataParallelRouter(reps if children else gens)
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


def main(argv: Optional[Sequence[str]] = None) -> int:
    setup_logging()
    # crash backtraces, also on SIGTERM
    faulthandler.enable()
    faulthandler.register(signal.SIGTERM, chain=True)
    args = build_parser().parse_args(argv)
    # SIGINT stops the server, also where it was started with SIGINT
    # ignored (a background job of a shell); a process this server
    # started ignores it: its stop comes from the server (a terminal's
    # Ctrl-C reaches the whole process group)
    signal.signal(signal.SIGINT, signal.SIG_IGN if args.exit_with_parent
                  else signal.default_int_handler)
    if require_device(args.device).type == "cuda":
        # every CUDA source at once (one nvcc each, each logged with its
        # seconds), where the first launches would build them one by one
        _build.build_all()
    if args.process_id not in (None, 0):
        serve_worker(args)
        return 0
    if args.replica_channel is not None:
        return serve_replica(args)
    server, generator, engine = build_server(argv)
    print(f"[INFO] listening on port {server.port} ({engine.device})",
          flush=True)
    kernels.reset_launch_counts()
    try:
        server.loop()
    except KeyboardInterrupt:
        print("[INFO] interrupted: stopping the server", flush=True)
    server.stop()
    generator.shutdown()
    print(f"[INFO] kernel launches while serving: "
          f"{json.dumps(kernels.launch_counts())}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
