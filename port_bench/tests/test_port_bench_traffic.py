"""The traffic generator and the load generator's session logic."""

import asyncio
import collections

import pytest

from port_bench import client as client_mod
from port_bench import traffic
from port_bench.proto import llm_pb2
from port_bench.tests import tiny

CHAT = {"loop": "open", "rate_per_s": 5.0, "warmup_s": 4, "drain_s": 10,
        "prompt": {"dist": "lognormal", "median": 256, "sigma": 0.8,
                   "min": 16, "max": 2048},
        "output": {"dist": "lognormal", "median": 160, "sigma": 0.7,
                   "min": 16, "max": 1024}}
SESSIONS = dict(CHAT, rate_per_s=2.0, sessions={
    "system_prompts": 8, "system_tokens": 768, "zipf_s": 1.1,
    "turns_min": 2, "turns_max": 5, "think_mean_s": 1.0, "context": 2048},
    prompt={"dist": "lognormal", "median": 64, "sigma": 0.6, "min": 16,
            "max": 256},
    output={"dist": "lognormal", "median": 64, "sigma": 0.5, "min": 16,
            "max": 192})
DOCS = {"loop": "closed", "clients": 4, "pool": 32, "warmup_s": 2,
        "drain_s": 10,
        "prompt": {"dist": "uniform", "min": 1536, "max": 3584},
        "output": {"dist": "uniform", "min": 64, "max": 256}}


def shape(plan):
    """Everything of a plan but its token ids."""
    return {p: [(j.offset, len(j.prompt), j.max_new, j.system,
                 [(len(u), a, th) for u, a, th in j.turns])
                for j in jobs] for p, jobs in plan.jobs.items()}


@pytest.mark.parametrize("t", [CHAT, SESSIONS, DOCS],
                         ids=["chat", "sessions", "docs"])
def test_same_seed_same_inputs(t):
    a = traffic.Plan(t, 2**31 + 11, 20, 64000)
    b = traffic.Plan(t, 2**31 + 11, 20, 64000)
    assert shape(a) == shape(b)
    assert [[j.prompt for j in a.jobs[p]] for p in traffic.PHASES] == \
        [[j.prompt for j in b.jobs[p]] for p in traffic.PHASES]
    assert a.system_prompts == b.system_prompts


@pytest.mark.parametrize("t", [CHAT, SESSIONS, DOCS],
                         ids=["chat", "sessions", "docs"])
def test_seeds_share_the_work_in_another_order(t):
    a = traffic.Plan(t, 1, 20, 64000)
    b = traffic.Plan(t, 2**33 + 1, 20, 64000)
    for p in traffic.PHASES:
        # the same requests (sessions), the same gaps, in another order
        sa = sorted(repr(x[1:]) for x in shape(a)[p])
        sb = sorted(repr(x[1:]) for x in shape(b)[p])
        assert sa == sb
        assert [x[1:] for x in shape(a)[p]] != [x[1:] for x in shape(b)[p]]
    assert shape(a)["window"] != shape(b)["window"]
    ids = [j.prompt or j.turns[0][0] for j in a.jobs["window"]]
    assert ids != [j.prompt or j.turns[0][0] for j in b.jobs["window"]]


def test_open_loop_lengths_rate_and_ranges():
    plan = traffic.Plan(CHAT, 7, 40, 64000)
    window = plan.jobs["window"]
    assert len(window) == 200
    assert all(0 <= j.offset < 40 for j in window)
    assert all(16 <= len(j.prompt) <= 2048 for j in window)
    assert all(16 <= j.max_new <= 1024 for j in window)
    assert all(1 <= t < 64000 for j in window for t in j.prompt)
    lens = sorted(len(j.prompt) for j in window)
    assert 200 < lens[100] < 320          # the median near 256
    # stratified: the window always holds its tail
    assert max(j.max_new for j in window) == 1024


def test_sessions_stay_within_the_context_and_zipf():
    plan = traffic.Plan(SESSIONS, 3, 40, 103168)
    window = plan.jobs["window"]
    assert len(window) == 80
    counts = collections.Counter(j.system for j in window)
    assert counts[0] > counts[1] > counts[7]
    assert all(2 <= len(j.turns) <= 5 for j in window)
    assert all(len(p) == 768 for p in plan.system_prompts)
    for j in window:
        for user, answer, think in j.turns:
            assert 16 <= len(user) <= 256 and 16 <= answer <= 192
            assert think > 0


def test_closed_loop_pools():
    plan = traffic.Plan(DOCS, 5, 30, 64000)
    for p in traffic.PHASES:
        assert len(plan.jobs[p]) == 32
        assert all(1536 <= len(j.prompt) <= 3584 and 64 <= j.max_new <= 256
                   for j in plan.jobs[p])


class FakeStub:
    """A server that answers each request with ``max_new`` tokens, and
    records the prompts."""

    def __init__(self):
        self.prompts = []

    def __call__(self, batched):
        req = batched.req[0]
        self.prompts.append(list(req.tokens.ids))
        n = req.stopping_parameters.max_new_tokens

        async def stream():
            for i in range(n):
                rsp = llm_pb2.BatchedResponse()
                r = rsp.rsp.add()
                r.tokens.ids.append(1000 + len(self.prompts) * 10 + i)
                r.status = llm_pb2.FINISHED if i == n - 1 else \
                    llm_pb2.PROCESSING
                yield rsp
        return stream()


def test_sessions_resend_system_prompt_and_history():
    t = dict(tiny.TRAFFIC["tiny-sessions"])
    c = client_mod.Client(dict(target="-", traffic=t, seed=9, seconds=2,
                               vocab=256, page_size=16))
    c.w0, c.w1 = 0.0, 1e12
    job = max(c.plan.jobs["window"], key=lambda j: len(j.turns))
    job.turns = [(u, a, 0.0) for u, a, _ in job.turns]
    stub = FakeStub()
    asyncio.run(c.session(stub, job, start=0.0))
    system = c.plan.system_prompts[job.system]
    history = list(system)
    assert len(stub.prompts) == len(job.turns)
    for k, ((user, answer, _), sent) in enumerate(zip(job.turns,
                                                      stub.prompts)):
        assert sent == history + user
        assert c.records[k]["n_out"] == answer
        history = sent + c.tokens[k]
    assert all(r["phase"] == "window" for r in c.records)
    # the second turn onwards hits the system prompt's full pages
    assert c.records[1]["hit_est"] >= len(system) // 16 * 16


def test_session_ends_before_passing_the_context():
    t = dict(tiny.TRAFFIC["tiny-sessions"])
    t["sessions"] = dict(t["sessions"], context=48 + 24 + 16)
    c = client_mod.Client(dict(target="-", traffic=t, seed=9, seconds=2,
                               vocab=256, page_size=16))
    c.w0, c.w1 = 0.0, 1e12
    job = c.plan.jobs["window"][0]
    job.turns = [(list(range(1, 21)), 16, 0.0)] * 3
    stub = FakeStub()
    asyncio.run(c.session(stub, job, start=0.0))
    assert all(len(p) + 16 <= 48 + 24 + 16 for p in stub.prompts)
    assert len(stub.prompts) == 1
