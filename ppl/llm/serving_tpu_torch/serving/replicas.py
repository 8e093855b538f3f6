"""Data-parallel replicas of tensor-parallel groups behind one frontend.

The JAX package builds one mesh a replica inside one process
(``serving_tpu/tools/llm_server.py``). Here a rank is a process with a
card, so a replica of a tensor-parallel group is a group of processes
with its own ``torch.distributed`` world, TCP store and NCCL
communicators: no step collective can cross replicas. The frontend's
process is replica 0's controller; replica i > 0's controller is a child
process on ``cuda:i*tp`` that starts its own worker ranks.

This module is the channel between the frontend and such a child: one
pickled message pair over a local socket
(``multiprocessing.connection``, authenticated with a key the frontend
hands the child in its environment, so that nothing unpickles bytes of
another sender). The frontend side is a :class:`ReplicaProxy`, which
gives the :class:`~.dp_router.DataParallelRouter` the replica's
``process``/``clear_task``/``shutdown`` and relays every response to the
frontend's connection in order; the child side is
:func:`serve_channel` with a :class:`RelayConnection` as its generator's
connection. Replica 0 sits behind a :class:`LocalReplica`, so every
replica logs the tasks it takes and the cancels it gets alike.

Messages, frontend to child: ``("process", Request)``, ``("clear",
tid)``, ``("shutdown",)``. Child to frontend: ``("ready", info)`` once its
engine is built, then ``("send", responses)``, ``("fail", tid, rc,
msg)``, ``("tokenize", tid, ids)``, and ``("bye", report)`` after its
shutdown.
"""

from __future__ import annotations

import logging
import os
import secrets
import subprocess
import threading
import time
from multiprocessing.connection import Client, Listener
from typing import Callable, Dict, List, Optional, Sequence

from ..connection import Connection

logger = logging.getLogger("ppl.llm.serving_tpu_torch.replicas")

# the environment variable that carries the channel's key to a child
KEY_ENV = "PPL_REPLICA_KEY"


def _log_task(enabled: bool, index: int, what: str, tid: int) -> None:
    if enabled:
        logger.info("data-parallel replica %d %s task %d", index, what, tid)


class LocalReplica:
    """Replica 0: the generator in the frontend's process, as the router
    sees it; ``devices``: its ranks' cards, by rank; ``workers``: the
    worker ranks' processes."""

    def __init__(self, generator, devices: Sequence[str],
                 workers: Sequence[subprocess.Popen] = (),
                 log_requests: bool = True):
        self.index = 0
        self.generator = generator
        self.devices = list(devices)
        self.workers = list(workers)
        self.log_requests = log_requests
        self.tasks = 0
        self._lock = threading.Lock()

    def process(self, req) -> None:
        with self._lock:
            self.tasks += 1
        _log_task(self.log_requests, 0, "takes", req.id)
        self.generator.process(req)

    def clear_task(self, tid: int) -> None:
        _log_task(self.log_requests, 0, "cancels", tid)
        self.generator.clear_task(tid)

    def shutdown(self) -> None:
        self.generator.shutdown()


class ReplicaListener:
    """The frontend's end of the channels: a socket on 127.0.0.1 that the
    replica children connect to, each with its index."""

    def __init__(self):
        self._key = secrets.token_bytes(32)
        # room for every replica's connection while one reports ready
        self._listener = Listener(("127.0.0.1", 0), backlog=64,
                                  authkey=self._key)
        self.address = "%s:%d" % self._listener.address

    def child_env(self, env: Dict[str, str]) -> Dict[str, str]:
        return dict(env, **{KEY_ENV: self._key.hex()})

    def accept(self, procs: Dict[int, subprocess.Popen],
               timeout_s: float) -> Dict[int, tuple]:
        """Wait for every child in ``procs`` (by replica index) to connect
        and report ready: returns ``{index: (channel, info)}``. Raises if a
        child exits first or the time runs out."""
        got: Dict[int, tuple] = {}
        errors: List[BaseException] = []

        def take():
            try:
                while len(got) < len(procs):
                    chan = self._listener.accept()
                    msg = chan.recv()
                    if msg[0] != "ready" or msg[1]["index"] not in procs:
                        raise RuntimeError(f"unexpected replica message "
                                           f"{msg[0]!r}")
                    got[msg[1]["index"]] = (chan, msg[1])
            except (OSError, EOFError, RuntimeError) as e:
                errors.append(e)

        t = threading.Thread(target=take, name="replica-accept",
                             daemon=True)
        t.start()
        deadline = time.monotonic() + timeout_s
        try:
            while t.is_alive():
                dead = {i: p.returncode for i, p in procs.items()
                        if i not in got and p.poll() is not None}
                if dead:
                    raise RuntimeError(
                        "data-parallel replica(s) exited during startup: "
                        + ", ".join(f"{i} with {rc}"
                                    for i, rc in sorted(dead.items())))
                if time.monotonic() > deadline:
                    raise RuntimeError(f"data-parallel replicas "
                                       f"{sorted(set(procs) - set(got))} "
                                       f"not ready after {timeout_s:.0f} s")
                t.join(0.2)
        finally:
            self._listener.close()
        if errors:
            raise RuntimeError(f"replica channel: {errors[0]}")
        return got


class ReplicaProxy:
    """Replica ``index`` > 0 as the router sees it: its requests and
    cancels forwarded to the child's controller over ``chan``, the
    child's responses relayed to ``conn`` on a reader thread, in the
    order they come. If the child ends before :meth:`shutdown`,
    ``on_lost(index, returncode)`` runs (the server fails every request
    in flight and ends)."""

    def __init__(self, index: int, proc: subprocess.Popen, chan, info: dict,
                 conn: Connection, on_lost: Callable[[int, Optional[int]],
                                                     None],
                 log_requests: bool = True):
        self.index = index
        self.proc = proc
        self.devices = list(info["devices"])
        self.info = info
        self.report: Optional[dict] = None   # the child's "bye" message
        self.log_requests = log_requests
        self.tasks = 0
        self._chan = chan
        self._conn = conn
        self._on_lost = on_lost
        self._lock = threading.Lock()
        self._stopping = threading.Event()
        self._reader = threading.Thread(target=self._read,
                                        name=f"replica-{index}-reader",
                                        daemon=True)
        self._reader.start()

    def _send(self, msg) -> None:
        with self._lock:
            self._chan.send(msg)

    def process(self, req) -> None:
        _log_task(self.log_requests, self.index, "takes", req.id)
        with self._lock:
            self.tasks += 1
        try:
            self._send(("process", req))
        except OSError:
            # the child is gone: the reader's on_lost fails it
            pass

    def clear_task(self, tid: int) -> None:
        _log_task(self.log_requests, self.index, "cancels", tid)
        try:
            self._send(("clear", tid))
        except OSError:
            pass

    def _read(self) -> None:
        while True:
            try:
                msg = self._chan.recv()
            except (EOFError, OSError):
                break
            kind = msg[0]
            if kind == "send":
                self._conn.send(msg[1])
            elif kind == "fail":
                self._conn.notify_failure(msg[1], msg[2], msg[3])
            elif kind == "tokenize":
                self._conn.on_tokenize(msg[1], msg[2])
            elif kind == "bye":
                self.report = msg[1]
                break
        if self._stopping.is_set():
            return
        try:
            rc = self.proc.wait(timeout=5)
        except subprocess.TimeoutExpired:
            rc = None
        self._on_lost(self.index, rc)

    def shutdown(self, timeout_s: float = 120.0) -> None:
        """Stop the child's generator and its ranks; waits for its exit
        (``self.proc.returncode``; killed past ``timeout_s``)."""
        self._stopping.set()
        try:
            self._send(("shutdown",))
        except OSError:
            pass
        self._reader.join(timeout_s)
        try:
            self.proc.wait(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            logger.error("data-parallel replica %d did not exit within %g "
                         "s; killed", self.index, timeout_s)
            self.proc.kill()
            self.proc.wait()
        self._chan.close()


class RelayConnection(Connection):
    """A replica child's generator connection: every upcall goes to the
    frontend over the channel, one message each, in call order; the
    profiler's periodic report is printed here."""

    def __init__(self, chan):
        self._chan = chan
        self._lock = threading.Lock()

    def _send(self, msg) -> None:
        with self._lock:
            self._chan.send(msg)

    def send(self, responses) -> None:
        self._send(("send", list(responses)))

    def notify_failure(self, tid: int, rc: int = 1, msg: str = "") -> None:
        self._send(("fail", tid, rc, msg))

    def on_tokenize(self, tid: int, token_ids) -> None:
        self._send(("tokenize", tid, list(token_ids)))

    def on_profiling(self, profiler) -> None:
        from ..profiler import print_profiler
        print_profiler(profiler)


def connect(address: str):
    """The child's end of its channel to the frontend at ``address``
    ("host:port"), authenticated with the key in its environment."""
    host, _, port = address.rpartition(":")
    return Client((host, int(port)),
                  authkey=bytes.fromhex(os.environ[KEY_ENV]))


def serve_channel(chan, generator) -> bool:
    """The child's loop: run the frontend's requests and cancels on
    ``generator`` until the shutdown message (True) or the frontend's
    end (False)."""
    while True:
        try:
            msg = chan.recv()
        except (EOFError, OSError):
            return False
        if msg[0] == "process":
            generator.process(msg[1])
        elif msg[0] == "clear":
            generator.clear_task(msg[1])
        elif msg[0] == "shutdown":
            return True
