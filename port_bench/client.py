"""The load generator: an asyncio gRPC client of ``LLMService.Generation``
in token-in / token-out mode, run as a child process of the benchmark.

    python -m port_bench.client < job.json

``job.json`` holds ``target`` (host:port), ``traffic`` (the traffic
file's parameters), ``seed``, ``seconds``, ``vocab``, ``page_size`` and
optionally ``warmup_s`` and ``rate_per_s`` overrides. The client sends
the traffic's warm-up, then its window, then keeps the load on during
the drain (uncounted) until every request due in the window has ended or
the drain limit has passed; a window request still running then is a
miss. It prints ``WINDOW_START <t>`` and ``WINDOW_END <t>`` (monotonic
seconds, the clock every process of the machine shares) as the window
opens and closes, and last one ``RESULT <json>`` line: every request's
due, send, first and finish times, lengths, streamed chunks and its
prefix-cache hit as the traffic implies it, and, for a sample drawn
from the seed among the window's finished requests (the longest one
always in it), the prompt and served token ids.

It imports nothing of the program: the message classes are the
benchmark's own copy of the protocol's stubs.
"""

from __future__ import annotations

import asyncio
import json
import random
import sys
import time
from typing import Dict, List, Optional

import grpc
import grpc.aio

from port_bench.proto import llm_pb2
from port_bench.traffic import Plan

GENERATION = "/ppl.llm.proto.LLMService/Generation"


def now() -> float:
    return time.monotonic()


class PrefixPages:
    """The full pages of every prompt sent so far, by the hash of the
    prefix they end: a request's hit as the traffic implies it (what an
    unbounded prefix cache would serve)."""

    def __init__(self, page_size: int):
        self.page = page_size
        self.seen = set()

    def hit(self, ids: List[int]) -> int:
        h, hit, matched = 0, 0, True
        for j in range(len(ids) // self.page):
            h = hash((h, tuple(ids[j * self.page:(j + 1) * self.page])))
            if matched and h in self.seen:
                hit += self.page
            else:
                matched = False
            self.seen.add(h)
        return hit


class Client:
    def __init__(self, job: Dict):
        self.job = job
        self.traffic = job["traffic"]
        self.plan = Plan(self.traffic, int(job["seed"]), float(job["seconds"]),
                         int(job["vocab"]), job.get("warmup_s"),
                         job.get("rate_per_s"))
        self.pages = PrefixPages(int(job["page_size"]))
        self.records: List[Dict] = []
        self.tokens: Dict[int, List[int]] = {}
        self.prompts: Dict[int, List[int]] = {}
        self.window_pending = 0
        self.tasks: List[asyncio.Task] = []
        self.stopping = False
        self.t0 = self.w0 = self.w1 = 0.0

    def phase_of(self, due: float) -> str:
        return ("warmup" if due < self.w0 else
                "window" if due < self.w1 else "drain")

    async def request(self, stub, prompt: List[int], max_new: int,
                      due: float, phase: str) -> Dict:
        rid = len(self.records)
        rec = dict(rid=rid, phase=phase, due=due, send=None, first=None,
                   finish=None, n_in=len(prompt), n_out=0, max_new=max_new,
                   failed=False, chunks=[], hit_est=self.pages.hit(prompt))
        self.records.append(rec)
        self.prompts[rid] = prompt
        toks = self.tokens[rid] = []
        batched = llm_pb2.BatchedRequest()
        req = batched.req.add()
        req.id = rid
        req.tokens.ids.extend(prompt)
        req.stopping_parameters.max_new_tokens = max_new
        req.stopping_parameters.ignore_eos_token = True
        rec["send"] = now()
        try:
            async for rsp_batch in stub(batched):
                t = now()
                n = 0
                for rsp in rsp_batch.rsp:
                    if rsp.status == llm_pb2.FAILED:
                        rec["failed"] = True
                        rec["error"] = rsp.generated
                        return rec
                    toks.extend(rsp.tokens.ids)
                    n += len(rsp.tokens.ids)
                    if rsp.status == llm_pb2.FINISHED:
                        rec["finish"] = t
                if n:
                    if rec["first"] is None:
                        rec["first"] = t
                    rec["chunks"].append([t, n])
                    rec["n_out"] += n
            if rec["finish"] is None:
                rec["failed"] = True
                rec["error"] = "stream ended unfinished"
        except grpc.aio.AioRpcError as e:
            rec["failed"] = True
            rec["error"] = f"{e.code()}: {e.details()}"
        finally:
            if phase == "window":
                self.window_pending -= 1
        return rec

    async def sleep_until(self, t: float) -> None:
        delay = t - now()
        if delay > 0:
            await asyncio.sleep(delay)

    def spawn(self, coro) -> None:
        self.tasks.append(asyncio.create_task(coro))

    async def one(self, stub, job, start: float) -> None:
        due = start + job.offset
        phase = self.phase_of(due)
        if phase == "window":
            self.window_pending += 1
        await self.sleep_until(due)
        if self.stopping:
            if phase == "window":
                self.window_pending -= 1
            return
        await self.request(stub, job.prompt, job.max_new, due, phase)

    async def session(self, stub, job, start: float) -> None:
        due = start + job.offset
        history = list(self.plan.system_prompts[job.system])
        context = int(self.traffic["sessions"]["context"])
        for user, answer, think in job.turns:
            prompt = history + user
            if len(prompt) + answer > context:
                return
            phase = self.phase_of(due)
            if phase == "window":
                self.window_pending += 1
            await self.sleep_until(due)
            if self.stopping:
                if phase == "window":
                    self.window_pending -= 1
                return
            rec = await self.request(stub, prompt, answer, due, phase)
            if rec["failed"]:
                return
            history = prompt + self.tokens[rec["rid"]]
            due = now() + think

    async def mark(self, label: str, t: float) -> None:
        await self.sleep_until(t)
        print(f"{label} {t!r}", flush=True)

    async def run(self) -> Dict:
        d = self.plan.durations
        async with grpc.aio.insecure_channel(self.job["target"]) as channel:
            await asyncio.wait_for(channel.channel_ready(), 60)
            stub = channel.unary_stream(
                GENERATION,
                request_serializer=llm_pb2.BatchedRequest.SerializeToString,
                response_deserializer=llm_pb2.BatchedResponse.FromString)
            self.t0 = now() + 0.2
            self.w0 = self.t0 + d["warmup"]
            self.w1 = self.w0 + d["window"]
            starts = {"warmup": self.t0, "window": self.w0, "drain": self.w1}
            marks = [asyncio.create_task(self.mark("WINDOW_START", self.w0)),
                     asyncio.create_task(self.mark("WINDOW_END", self.w1))]
            if self.plan.loop == "closed":
                await self.sleep_until(self.t0)
                for c in range(int(self.traffic["clients"])):
                    self.spawn(self.caller(stub, c))
            else:
                for phase in ("warmup", "window", "drain"):
                    for job in self.plan.jobs[phase]:
                        self.spawn(self.session(stub, job, starts[phase])
                                   if job.turns else
                                   self.one(stub, job, starts[phase]))
            await asyncio.gather(*marks)
            end = self.w1 + d["drain"]
            while now() < end and self.window_pending > 0:
                await asyncio.sleep(0.05)
            drain_end = now()
            self.stopping = True
            for t in self.tasks:
                t.cancel()
            await asyncio.gather(*self.tasks, return_exceptions=True)
        for r in self.records:
            if r["phase"] == "window" and r["finish"] is None:
                r["failed"] = True
                r.setdefault("error", "not finished by the drain limit")
        return dict(window=[self.w0, self.w1], drain_end=drain_end,
                    requests=self.records, sample=self.sample())

    async def caller(self, stub, c: int) -> None:
        """Closed-loop caller ``c``: its next request, when the last one
        has ended, from the pool of the phase it is sent in; the callers
        take the pool's items in turn."""
        i = c
        while not self.stopping:
            due = now()
            phase = self.phase_of(due)
            pool = self.plan.jobs[phase]
            job = pool[i % len(pool)]
            i += int(self.traffic["clients"])
            if phase == "window":
                self.window_pending += 1
            await self.request(stub, job.prompt, job.max_new, due, phase)

    def sample(self) -> List[Dict]:
        """Finished window requests drawn from the seed, the longest
        first, until ``sample_min_served`` served tokens or
        ``sample_max_requests`` requests."""
        done = [r for r in self.records if r["phase"] == "window"
                and not r["failed"] and r["n_out"] > 0]
        if not done:
            return []
        longest = max(done, key=lambda r: (r["n_in"] + r["n_out"], r["rid"]))
        rest = [r for r in done if r is not longest]
        random.Random(f"{self.job['seed']}/sample").shuffle(rest)
        picked, served = [], 0
        most = int(self.traffic["sample_max_requests"])
        for r in [longest] + rest:
            if (served >= int(self.traffic["sample_min_served"])
                    or len(picked) >= most):
                break
            picked.append(r)
            served += r["n_out"]
        return [dict(rid=r["rid"], prompt=self.prompts[r["rid"]],
                     tokens=self.tokens[r["rid"]]) for r in picked]


def main(argv: Optional[List[str]] = None) -> int:
    job = json.load(sys.stdin)
    result = asyncio.run(Client(job).run())
    print("RESULT " + json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
