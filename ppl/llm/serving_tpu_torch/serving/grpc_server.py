"""Streaming gRPC frontend of the port, wire-compatible with the JAX
package's server and with the reference's clients.

The same ``LLMService.Generation(BatchedRequest) returns (stream
BatchedResponse)`` contract (``llm.proto``): client-id -> internal-uid
remapping, per-token streaming with finish reasons, and cancellation of a
call's live tasks when its client disconnects. Two frontends share it:
:class:`GRPCServer` parks one pool thread per live stream,
:class:`AsyncGRPCServer` runs one coroutine per stream on a grpc.aio loop
in its own thread.

No thread of this module touches a CUDA tensor: a frontend thread only
parses the request and hands it to ``process`` (tokenize and enqueue on
the host) or a cancel to ``clear_task`` (a host queue). Every dispatch,
graph replay and graph capture runs on the generator's generate thread.

The service is registered through a generic handler with the
protoc-generated message classes (no grpc_tools codegen needed): the
same bytes on the wire.
"""

from __future__ import annotations

import asyncio
import logging
import queue
import threading
from concurrent import futures
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import grpc

from ..connection import Connection
from ..request import FinishFlag, Request, Response
from .proto import llm_pb2

logger = logging.getLogger("ppl.llm.serving_tpu_torch.grpc")

_SERVICE_NAME = "ppl.llm.proto.LLMService"
_MAX_MESSAGE = 64 * 1024 * 1024
_OPTIONS = [("grpc.max_send_message_length", _MAX_MESSAGE),
            ("grpc.max_receive_message_length", _MAX_MESSAGE)]

_TOKEN_ID_LIMIT = 1 << 31   # token-in ids must fit the plans' int32

_FINISH_REASON = {
    FinishFlag.LENGTH: llm_pb2.FINISH_REASON_LENGTH,
    FinishFlag.EOS_TOKEN: llm_pb2.FINISH_REASON_EOS_TOKEN,
    FinishFlag.STOP_SEQUENCE: llm_pb2.FINISH_REASON_STOP_SEQUENCE,
}


def parse_pb_request(pb_req: llm_pb2.Request, uid: int) -> Request:
    """proto -> Request with the reference's defaulting rules: the
    do_sample gate (greedy unless set), top_p outside [0, 1] -> 0, zero
    temperature and repetition penalty -> 1.0, early_stopping =
    !ignore_eos_token; stop tokens are taken in token-in mode only."""
    req = Request(id=uid)
    if pb_req.prompt:
        req.prompt = pb_req.prompt
    else:
        req.token_ids = list(pb_req.tokens.ids)
        stop_ids = list(pb_req.stopping_parameters.stop_tokens.ids)
        req.stop_tokens = set(stop_ids) if stop_ids else set()
    cp = pb_req.choosing_parameters
    if cp.do_sample:
        req.top_k = cp.top_k
        req.top_p = cp.top_p
    else:
        req.top_k = 1
        req.top_p = 0.0
    if not (0.0 <= req.top_p <= 1.0):
        req.top_p = 0.0
    req.temperature = cp.temperature or 1.0
    req.repetition_penalty = cp.repetition_penalty or 1.0
    req.presence_penalty = cp.presence_penalty
    req.frequency_penalty = cp.frequency_penalty
    req.generation_length = pb_req.stopping_parameters.max_new_tokens
    req.early_stopping = not pb_req.stopping_parameters.ignore_eos_token
    return req


class _CallState:
    """One client Generation call: its outgoing queue and live tids.

    With ``loop`` (the grpc.aio frontend) the queue is an asyncio.Queue
    and producers (the generator's threads, via ``GRPCConnection.send``)
    post through ``call_soon_threadsafe``; without it (the threaded
    frontend) a thread-safe SimpleQueue is consumed by a pool thread."""

    __slots__ = ("out_queue", "tid_to_client_id", "pending", "_loop")

    def __init__(self, loop: Optional[asyncio.AbstractEventLoop] = None):
        self._loop = loop
        self.out_queue = asyncio.Queue() if loop else queue.SimpleQueue()
        self.tid_to_client_id: Dict[int, int] = {}
        self.pending = 0

    def put(self, item) -> None:
        if self._loop is not None:
            self._loop.call_soon_threadsafe(self.out_queue.put_nowait, item)
        else:
            self.out_queue.put(item)


class GRPCConnection(Connection):
    """Routes the generator's upcalls back to the right client stream."""

    def __init__(self):
        self._lock = threading.Lock()
        self._tid_to_call: Dict[int, _CallState] = {}

    def register(self, call: _CallState, tid: int, client_id: int) -> None:
        with self._lock:
            call.tid_to_client_id[tid] = client_id
            call.pending += 1
            self._tid_to_call[tid] = call

    def on_profiling(self, profiler) -> None:
        from ..profiler import print_profiler
        print_profiler(profiler)

    def _finish_tid(self, call: _CallState, tid: int) -> bool:
        """Returns True when the call has no tids left; the caller must
        enqueue the end-of-stream sentinel AFTER the final response batch."""
        del self._tid_to_call[tid]
        call.pending -= 1
        return call.pending <= 0

    def drop_call(self, call: _CallState) -> List[int]:
        """Client disconnected: unregister and return the tids to cancel."""
        with self._lock:
            tids = [tid for tid, c in self._tid_to_call.items() if c is call]
            for tid in tids:
                del self._tid_to_call[tid]
            call.pending = 0
            return tids

    def send(self, responses: Sequence[Response]) -> None:
        """Group one step's responses per client call into
        BatchedResponse messages."""
        grouped: Dict[int, Tuple[_CallState, llm_pb2.BatchedResponse]] = {}
        done_calls: List[_CallState] = []
        with self._lock:
            for rsp in responses:
                call = self._tid_to_call.get(rsp.id)
                if call is None:
                    continue  # canceled mid-flight
                ent = grouped.get(id(call))
                if ent is None:
                    ent = (call, llm_pb2.BatchedResponse())
                    grouped[id(call)] = ent
                pb = ent[1].rsp.add()
                pb.id = call.tid_to_client_id[rsp.id]
                pb.generated = rsp.generated
                if rsp.token >= 0:
                    pb.tokens.ids.append(rsp.token)
                pb.detail.logprobs = rsp.logprob
                pb.detail.is_special = rsp.is_special
                if rsp.finish_flag == FinishFlag.NOT_FINISHED:
                    pb.status = llm_pb2.PROCESSING
                else:
                    pb.status = llm_pb2.FINISHED
                    pb.detail.finish_reason = _FINISH_REASON[rsp.finish_flag]
                    if self._finish_tid(call, rsp.id):
                        done_calls.append(call)
        for call, batched in grouped.values():
            call.put(batched)
        for call in done_calls:
            call.put(None)  # end-of-stream sentinel

    def notify_failure(self, tid: int, rc: int = 1, msg: str = "") -> None:
        with self._lock:
            call = self._tid_to_call.get(tid)
            if call is None:
                return
            batched = llm_pb2.BatchedResponse()
            pb = batched.rsp.add()
            pb.id = call.tid_to_client_id[tid]
            pb.status = llm_pb2.FAILED
            pb.generated = msg
            done = self._finish_tid(call, tid)
        call.put(batched)
        if done:
            call.put(None)

    def fail_all(self, rc: int = 1, msg: str = "") -> None:
        """Fail every request still in flight (the server is ending)."""
        with self._lock:
            tids = list(self._tid_to_call)
        for tid in tids:
            self.notify_failure(tid, rc, msg)


def _generic_handler(generation):
    return grpc.method_handlers_generic_handler(
        _SERVICE_NAME,
        {"Generation": grpc.unary_stream_rpc_method_handler(
            generation,
            request_deserializer=llm_pb2.BatchedRequest.FromString,
            response_serializer=llm_pb2.BatchedResponse.SerializeToString,
        )})


class _Frontend:
    """What both frontends share: the wiring and the uid sequence."""

    def __init__(self, conn: GRPCConnection,
                 process_func: Callable[[Request], None],
                 on_disconnected_func: Callable[[int], None]):
        self._conn = conn
        self._process = process_func
        self._on_disconnected = on_disconnected_func
        self._uid_seq = 0
        self._uid_lock = threading.Lock()
        self.port = 0   # the bound port, once init() has bound it
        # called after the gRPC server stops (a metrics endpoint beside it)
        self.on_stop: List[Callable[[], None]] = []

    def _next_uid(self) -> int:
        with self._uid_lock:
            self._uid_seq += 1
            return self._uid_seq

    def _submit(self, call: _CallState,
                batched_req: llm_pb2.BatchedRequest) -> None:
        for pb_req in batched_req.req:
            uid = self._next_uid()
            self._conn.register(call, uid, pb_req.id)
            if not pb_req.prompt and max(pb_req.tokens.ids, default=0) \
                    >= _TOKEN_ID_LIMIT:
                # the step plans hold token ids as int32: such an id would
                # fail the plan of every request in the step. Ids below
                # the limit but past the vocabulary are served (clamped)
                self._conn.notify_failure(
                    uid, 1, f"id [{pb_req.id}] invalid token id: "
                    f"{max(pb_req.tokens.ids)} >= {_TOKEN_ID_LIMIT}")
                continue
            self._process(parse_pb_request(pb_req, uid))

    def _cancel(self, call: _CallState) -> None:
        for tid in self._conn.drop_call(call):
            logger.info("client disconnected, canceling task %d", tid)
            self._on_disconnected(tid)


class GRPCServer(_Frontend):
    """The threaded frontend on grpcio's thread pool."""

    def __init__(self, conn: GRPCConnection,
                 process_func: Callable[[Request], None],
                 on_disconnected_func: Callable[[int], None],
                 max_workers: int = 1024):
        # Each stream OCCUPIES a pool thread for its whole life (the
        # response generator blocks in the pool), so max_workers bounds
        # CONCURRENT STREAMS, not transient work: a small pool serializes
        # stream ingestion itself. 1024 parked threads (blocked on
        # queue.get) is the threaded equivalent of an async loop.
        super().__init__(conn, process_func, on_disconnected_func)
        self._server = grpc.server(
            futures.ThreadPoolExecutor(max_workers=max_workers),
            options=_OPTIONS)
        self._server.add_generic_rpc_handlers(
            (_generic_handler(self._generation),))

    def _generation(self, batched_req: llm_pb2.BatchedRequest, context):
        call = _CallState()

        def on_cancel():
            self._cancel(call)
            call.out_queue.put(None)

        context.add_callback(on_cancel)
        if not batched_req.req:
            return  # empty batch: close the stream, don't wait forever
        self._submit(call, batched_req)
        while True:
            item = call.out_queue.get()
            if item is None:
                return
            yield item

    def init(self, host: str, port: int) -> int:
        bound = self._server.add_insecure_port(f"{host}:{port}")
        if bound == 0:
            raise RuntimeError(f"failed to bind {host}:{port}")
        self.port = bound
        return bound

    def start(self) -> None:
        self._server.start()

    def loop(self) -> None:
        self.start()
        logger.info("gRPC server listening")
        self._server.wait_for_termination()

    def stop(self, grace: float = 1.0) -> None:
        self._server.stop(grace).wait(timeout=grace + 10)
        for fn in self.on_stop:
            fn()


class AsyncGRPCServer(_Frontend):
    """The grpc.aio frontend: one coroutine per live stream, no parked
    thread.

    The event loop runs in a daemon thread of its own, so the server tool
    and the tests keep the init()/start()/loop()/stop() interface; the
    grpc.aio objects are made INSIDE that loop (they bind to the loop
    current at construction). The generator's threads post responses with
    ``loop.call_soon_threadsafe`` (``_CallState.put``).
    """

    def __init__(self, conn: GRPCConnection,
                 process_func: Callable[[Request], None],
                 on_disconnected_func: Callable[[int], None],
                 max_workers: int = 0):  # accepted for interface parity
        super().__init__(conn, process_func, on_disconnected_func)
        self._loop: Optional[asyncio.AbstractEventLoop] = None
        self._loop_thread: Optional[threading.Thread] = None
        self._server = None

    async def _generation(self, batched_req: llm_pb2.BatchedRequest,
                          context):
        call = _CallState(loop=asyncio.get_running_loop())
        if not batched_req.req:
            return  # empty batch: close the stream, don't wait forever
        try:
            self._submit(call, batched_req)
            while True:
                item = await call.out_queue.get()
                if item is None:
                    return
                yield item
        finally:
            # normal end: drop_call returns [] (every tid finished); on a
            # disconnect CancelledError lands on the await above and the
            # still-live tids are canceled here
            self._cancel(call)

    async def _create_and_bind(self, host: str, port: int) -> int:
        self._server = grpc.aio.server(options=_OPTIONS)
        self._server.add_generic_rpc_handlers(
            (_generic_handler(self._generation),))
        return self._server.add_insecure_port(f"{host}:{port}")

    def _run(self, coro):
        return asyncio.run_coroutine_threadsafe(coro, self._loop).result()

    def init(self, host: str, port: int) -> int:
        self._loop = asyncio.new_event_loop()
        self._loop_thread = threading.Thread(
            target=self._loop.run_forever, name="grpc-aio-loop", daemon=True)
        self._loop_thread.start()
        bound = self._run(self._create_and_bind(host, port))
        if bound == 0:
            raise RuntimeError(f"failed to bind {host}:{port}")
        self.port = bound
        return bound

    def start(self) -> None:
        self._run(self._server.start())

    def loop(self) -> None:
        self.start()
        logger.info("gRPC server listening")
        self._run(self._server.wait_for_termination())

    def stop(self, grace: float = 1.0) -> None:
        self._run(self._server.stop(grace))
        self._loop.call_soon_threadsafe(self._loop.stop)
        self._loop_thread.join(timeout=10)
        for fn in self.on_stop:
            fn()
