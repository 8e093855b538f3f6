"""``llm_server --device cpu --tensor-parallel-size 2 --data-parallel-size
2``: two replicas, each a gloo group of two ranks, behind one frontend.
This server process is replica 0's controller and starts its worker;
replica 1's controller is a child process that starts its own. Round
robin reaches both replicas, each streamed request's greedy tokens are
one card's, a cancel reaches only the replica that owns the request,
and a dead rank of either replica fails the in-flight requests and ends
the server with a nonzero exit and a ``[FATAL]`` line. Against the
JAX package's ``DataParallelRouter`` over two tp=2 meshes of its
8-device CPU mesh, on the same checkpoint: the same replica serves each
request, with the same greedy tokens.

The server runs in a process of its own; every wait has a deadline and
every process is killed on the way out."""

import os
import re
import signal
import threading
import time

import grpc
import jax
import torch

from ppl.llm.serving_tpu.config import ModelConfig as JModelConfig
from ppl.llm.serving_tpu.config import ResourceConfig as JResourceConfig
from ppl.llm.serving_tpu.connection import LocalConnection as JConnection
from ppl.llm.serving_tpu.generator import LLMGenerator as JGenerator
from ppl.llm.serving_tpu.parallel import shardings as jsh
from ppl.llm.serving_tpu.request import Request as JRequest
from ppl.llm.serving_tpu.resources import create_engine as j_create_engine
from ppl.llm.serving_tpu.serving.dp_router import (
    DataParallelRouter as JRouter)
from ppl.llm.serving_tpu_torch.config import ModelConfig
from ppl.llm.serving_tpu_torch.models import llama
from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2

import chip_smoke
from test_generator_e2e import DummyTokenizer, make_gen_cfg
from test_torch_tp_server import (ARGV, EXIT_S, IDS, NEW, RPC_S, START_S,
                                  ServerProcess, one_card_tokens)

DP_TP = ["--tensor-parallel-size", "2", "--data-parallel-size", "2"]
TAKES = re.compile(r"data-parallel replica (\d+) takes task (\d+)")
CANCELS = re.compile(r"data-parallel replica (\d+) cancels task (\d+)")


def stub_of(ch):
    return ch.unary_stream(
        "/ppl.llm.proto.LLMService/Generation",
        request_serializer=llm_pb2.BatchedRequest.SerializeToString,
        response_deserializer=llm_pb2.BatchedResponse.FromString)


def batch(reqs):
    """[(client id, token ids, new tokens)] in one BatchedRequest: the
    frontend hands them to the router in this order."""
    b = llm_pb2.BatchedRequest()
    for cid, ids, n in reqs:
        r = b.req.add()
        r.id = cid
        r.tokens.ids.extend(ids)
        r.stopping_parameters.max_new_tokens = n
        r.stopping_parameters.ignore_eos_token = True
    return b


def stream_batch(port, reqs):
    """Tokens and final statuses by client id."""
    toks, status = {}, {}
    with grpc.insecure_channel(f"127.0.0.1:{port}") as ch:
        for b in stub_of(ch)(batch(reqs), timeout=RPC_S):
            for rsp in b.rsp:
                toks.setdefault(rsp.id, []).extend(rsp.tokens.ids)
                status[rsp.id] = rsp.status
    return toks, status


def owners(log, pattern=TAKES):
    """task id -> replica, from the server's log lines."""
    return {int(t): int(r) for r, t in pattern.findall(log)}


def children_of(pid):
    """The processes ``pid`` started that still run."""
    try:
        with open(f"/proc/{pid}/task/{pid}/children") as f:
            return [int(k) for k in f.read().split()]
    except FileNotFoundError:
        return []


def descendants(pid):
    """Every process below ``pid``."""
    out, todo = [], [pid]
    while todo:
        kids = children_of(todo.pop())
        out += kids
        todo += kids
    return out


def kill_all(server):
    for pid in descendants(server.proc.pid):
        try:
            os.kill(pid, signal.SIGKILL)
        except ProcessLookupError:
            pass
    server.kill()


def wait_for(cond, timeout_s, what):
    deadline = time.monotonic() + timeout_s
    while not cond():
        assert time.monotonic() < deadline, what
        time.sleep(0.1)


class LongStream:
    """A long request on a stream of its own, read on a thread until its
    end; ``cancel()`` closes it from the client's side."""

    def __init__(self, port, cid, n=2000):
        self.tokens, self.statuses, self.error = [], [], None
        self.first = threading.Event()
        self.done = threading.Event()
        self._ch = grpc.insecure_channel(f"127.0.0.1:{port}")
        self._call = stub_of(self._ch)(batch([(cid, IDS, n)]),
                                       timeout=RPC_S)
        threading.Thread(target=self._read, daemon=True).start()

    def _read(self):
        try:
            for b in self._call:
                for rsp in b.rsp:
                    self.tokens.extend(rsp.tokens.ids)
                    self.statuses.append(rsp.status)
                    self.first.set()
        except grpc.RpcError as e:
            self.error = e
        finally:
            self.first.set()
            self.done.set()

    def cancel(self):
        self._call.cancel()
        self.done.wait(RPC_S)
        self._ch.close()


def test_dp2_tp2_server_routes_cancels_and_a_dead_rank_ends_all():
    server = ServerProcess(ARGV + DP_TP)
    try:
        assert server.listening.wait(START_S), server.log()
        # four ranks: this server, its worker, replica 1's controller and
        # that one's worker
        procs = descendants(server.proc.pid)
        assert len(procs) == 3, (procs, server.log())
        assert "data-parallel replica 1: tensor-parallel ranks on cpu, cpu" \
            in server.log()
        # round robin over both replicas, each with one card's tokens
        toks, status = stream_batch(server.port, [(10 + i, IDS, NEW)
                                                  for i in range(4)])
        want = one_card_tokens()
        assert all(toks[10 + i] == want for i in range(4)), toks
        assert all(status[10 + i] == llm_pb2.FINISHED for i in range(4))
        log = "".join(server.lines)
        assert owners(log) == {1: 0, 2: 1, 3: 0, 4: 1}, log[-3000:]
        # a cancel reaches its owner only: tasks 5 (replica 0) and 6
        # (replica 1), each canceled after its first token
        streams = [LongStream(server.port, 20 + i) for i in range(2)]
        for s in streams:
            assert s.first.wait(RPC_S)
        for s in streams:
            s.cancel()
        wait_for(lambda: len(CANCELS.findall("".join(server.lines))) >= 2,
                 RPC_S, "cancels not logged")
        log = "".join(server.lines)
        assert owners(log) == {1: 0, 2: 1, 3: 0, 4: 1, 5: 0, 6: 1}
        assert sorted(CANCELS.findall(log)) == [("0", "5"), ("1", "6")], \
            log[-3000:]
        # a long request on replica 1 (task 8), then a rank of replica 1
        # dies: the request fails, every process ends, the server with a
        # nonzero exit
        warm = LongStream(server.port, 30, n=4)
        warm.done.wait(RPC_S)
        inflight = LongStream(server.port, 31)
        assert inflight.first.wait(RPC_S)
        assert owners("".join(server.lines))[8] == 1
        replica1 = [p for p in descendants(server.proc.pid)
                    if descendants(p)]
        assert len(replica1) == 1, server.log()
        os.kill(descendants(replica1[0])[0], signal.SIGKILL)
        assert inflight.done.wait(EXIT_S), "the in-flight request hung"
        assert inflight.statuses[-1] == llm_pb2.FAILED, (
            inflight.statuses[-3:], inflight.error)
        wait_for(lambda: server.proc.poll() is not None, EXIT_S,
                 "the server did not end")
        assert server.proc.returncode not in (None, 0), server.log()
        log = server.log()
        assert "[FATAL] tensor-parallel rank 1 exited" in log, log
        assert "[FATAL] data-parallel replica 1 exited" in log, log
    finally:
        kill_all(server)


def test_dp2_tp2_a_dead_rank_of_replica_0_fails_every_request():
    """Replica 0's worker dies while both replicas serve a request: each
    request ends with a FAILED status (not a broken stream), and every
    process ends, the server with a nonzero exit."""
    server = ServerProcess(ARGV + DP_TP + ["--disable-log-req"])
    try:
        assert server.listening.wait(START_S), server.log()
        streams = [LongStream(server.port, 40 + i) for i in range(2)]
        for s in streams:
            assert s.first.wait(RPC_S)
        # the server's children: replica 0's worker and replica 1's
        # controller (whose own child is replica 1's worker)
        worker0 = [p for p in children_of(server.proc.pid)
                   if not children_of(p)]
        assert len(worker0) == 1, server.log()
        os.kill(worker0[0], signal.SIGKILL)
        for s in streams:
            assert s.done.wait(EXIT_S), "an in-flight request hung"
            assert s.error is None, s.error
            assert s.statuses[-1] == llm_pb2.FAILED, s.statuses[-3:]
        wait_for(lambda: server.proc.poll() is not None, EXIT_S,
                 "the server did not end")
        assert server.proc.returncode not in (None, 0), server.log()
        assert "[FATAL] tensor-parallel rank 1 exited" in server.log()
    finally:
        kill_all(server)


# the tiny checkpoint both packages load, and the traffic: two prompts,
# each sent twice in one BatchedRequest (dealt 0, 1, 0, 1)
WIDTHS = dict(hidden_dim=64, intermediate_dim=128, num_layers=2,
              num_heads=4, num_kv_heads=2, vocab_size=256)
PROMPTS = [DummyTokenizer().encode("data parallel groups"),
           DummyTokenizer().encode("two of them")]
LENGTHS = [16, 12]
RESOURCE = dict(kv_cache_max_tokens=2048, multi_step=4,
                token_buckets=(32, 64, 128, 256), batch_buckets=(4, 8, 16))
GEN = dict(max_running_batch=8, max_prefill_batch=4, max_tokens_per_step=256,
           max_input_tokens_per_request=128,
           max_output_tokens_per_request=64,
           max_total_tokens_per_request=192)


def traffic():
    """[(task id, prompt, new tokens)] in dealing order."""
    out = []
    for p, (ids, n) in enumerate(zip(PROMPTS, LENGTHS)):
        out += [(2 * p + 1 + r, ids, n) for r in range(2)]
    return out


def jax_router_run(path):
    """The JAX package's dp=2 router over two tp=2 meshes (devices 0-1
    and 2-3), both replicas from the checkpoint at ``path``: (owner by
    task id, tokens by task id)."""
    model_cfg = JModelConfig.from_hf_config(os.path.join(path, "config.json"),
                                            dtype="float32", page_size=16)
    gen_cfg = make_gen_cfg(stop_tokens=frozenset(), **GEN)
    devices = jax.devices()
    conn = JConnection()
    gens = []
    for i in range(2):
        engine, kv_max = j_create_engine(
            model_cfg, JResourceConfig(model_format="hf", model_dir=path,
                                       tensor_parallel_size=2, **RESOURCE),
            gen_cfg, mesh=jsh.make_mesh(2, devices[2 * i:2 * i + 2]))
        gens.append(JGenerator(model_cfg, gen_cfg, engine, DummyTokenizer(),
                               conn, kv_max))
    router = JRouter(gens)
    try:
        reqs = traffic()
        conn.set_wanted(len(reqs))
        for tid, ids, n in reqs:
            router.process(JRequest(id=tid, token_ids=list(ids),
                                    generation_length=n, top_k=1,
                                    early_stopping=False, stop_tokens=set()))
        assert conn.wait(timeout=RPC_S), "the JAX router timed out"
        return (dict(router._owner),
                {k: list(v) for k, v in conn.tokens.items()})
    finally:
        router.shutdown()


def test_dp2_tp2_matches_the_jax_router(tmp_path):
    path = str(tmp_path / "ckpt")
    os.makedirs(path)
    cfg = ModelConfig(**WIDTHS, dtype="float32")
    params = llama.init_params(cfg, torch.Generator().manual_seed(7),
                               dtype=torch.float32)
    chip_smoke.write_hf_checkpoint(torch, params, WIDTHS, path)
    want_owner, want_tokens = jax_router_run(path)

    server = ServerProcess([
        "--device", "cpu", "--model-dir", path, "--tokenizer-type", "dummy",
        "--dtype", "float32", "--page-size", "16", "--quant-method", "none",
        "--kv-cache-max-tokens", str(RESOURCE["kv_cache_max_tokens"]),
        "--multi-step", str(RESOURCE["multi_step"]),
        "--token-buckets", "32,64,128,256", "--batch-buckets", "4,8,16",
        "--max-running-batch", "8", "--max-prefill-batch", "4",
        "--max-tokens-per-step", "256",
        "--max-input-tokens-per-request", "128",
        "--max-output-tokens-per-request", "64",
        "--max-total-tokens-per-request", "192",
        "--host", "127.0.0.1", "--port", "0", *DP_TP])
    try:
        assert server.listening.wait(START_S), server.log()
        reqs = traffic()
        toks, status = stream_batch(server.port, reqs)
        # the frontend numbers tasks 1, 2, ... in arrival order: client
        # id tid here
        assert all(status[t] == llm_pb2.FINISHED for t, _, _ in reqs)
        assert owners("".join(server.lines)) == want_owner == {
            1: 0, 2: 1, 3: 0, 4: 1}
        assert toks == want_tokens
        for p in range(len(PROMPTS)):
            assert toks[2 * p + 1] == toks[2 * p + 2]
            assert len(toks[2 * p + 1]) == LENGTHS[p]
    finally:
        kill_all(server)
