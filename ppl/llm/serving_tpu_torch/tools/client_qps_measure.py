#!/usr/bin/env python3
"""Throughput/latency benchmark client of the port (the JAX package's
``tools/client_qps_measure.py``): replays a ShareGPT-style workload
against an ``LLMService`` server at a Poisson request rate (or all at
once with ``--request-rate inf``), records per-request send, first-token
and finish timestamps, and reports the reference's metric set: benchmark
time, average input and output length, time per token, prefill, decode
and end-to-end latency averages with their min/p1/.../p99/max
distributions, tokens out per second, tokens in+out per second, QPS.

``--token-in-out`` sends token ids with a fixed generation length.

    python -m ppl.llm.serving_tpu_torch.tools.client_qps_measure \\
        --target 127.0.0.1:23333 --dataset samples.json
"""

import argparse
import asyncio
import json
import random
import time

import grpc
import grpc.aio

from ppl.llm.serving_tpu_torch.serving.proto import llm_pb2

GENERATION = "/ppl.llm.proto.LLMService/Generation"


def load_workload(path, tokenizer, count):
    with open(path) as f:
        samples = json.load(f)
    out = []
    for entry in samples[:count]:
        convs = entry.get("conversations", [])
        prompt = next((c["value"] for c in convs if c.get("from") == "human"),
                      None)
        answer = next((c["value"] for c in convs if c.get("from") == "gpt"),
                      "")
        if not prompt:
            continue
        n_in = len(tokenizer.encode(prompt))
        n_out = max(1, len(tokenizer.encode(answer)))
        out.append((prompt, n_in, n_out))
    return out


class Stats:
    def __init__(self):
        self.send_ts = {}
        self.first_ts = {}
        self.finish_ts = {}
        self.out_tokens = {}
        self.in_tokens = {}
        self.token_ids = {}       # rid -> the streamed token ids
        self.finish_reason = {}   # rid -> detail.finish_reason at FINISHED
        self.failed_ids = set()   # a failed rid NEVER counts as done,
                                  # even if it streamed tokens first

    @property
    def failed(self):
        return len(self.failed_ids)


async def run_one(channel, stats, rid, prompt, n_in, n_out, token_in_out,
                  early_stopping=False, token_ids=None, timeout=None):
    """One request as its own stream; ``token_ids`` (token-in mode) are
    sent as given, else the synthetic ids of the reference client."""
    batched = llm_pb2.BatchedRequest()
    req = batched.req.add()
    req.id = rid
    if token_ids is not None:
        req.tokens.ids.extend(token_ids)
    elif token_in_out:
        req.tokens.ids.extend([(i * 13 + 5) % 31999 + 1 for i in range(n_in)])
    else:
        req.prompt = prompt
    req.stopping_parameters.max_new_tokens = n_out
    # reference parity: --early_stopping defaults false, i.e. the client
    # normally IGNORES eos (client_qps_measure.cc:32,88); pass
    # --early-stopping to measure the realistic EOS-stopping path
    req.stopping_parameters.ignore_eos_token = not early_stopping
    stub = channel.unary_stream(
        GENERATION,
        request_serializer=llm_pb2.BatchedRequest.SerializeToString,
        response_deserializer=llm_pb2.BatchedResponse.FromString)
    stats.send_ts[rid] = time.perf_counter()
    stats.in_tokens[rid] = n_in
    stats.out_tokens[rid] = 0
    stats.token_ids[rid] = []
    try:
        async for batched_rsp in stub(batched, timeout=timeout):
            now = time.perf_counter()
            for rsp in batched_rsp.rsp:
                if rsp.status == llm_pb2.FAILED:
                    stats.failed_ids.add(rid)
                    stats.finish_ts[rid] = now
                    return
                stats.first_ts.setdefault(rid, now)
                stats.out_tokens[rid] += max(1, len(rsp.tokens.ids))
                stats.token_ids[rid].extend(rsp.tokens.ids)
                if rsp.status == llm_pb2.FINISHED:
                    stats.finish_ts[rid] = now
                    stats.finish_reason[rid] = rsp.detail.finish_reason
    except grpc.RpcError:
        stats.failed_ids.add(rid)
        stats.finish_ts[rid] = time.perf_counter()


def pct(sorted_vals, q):
    if not sorted_vals:
        return 0.0
    idx = min(len(sorted_vals) - 1, int(q / 100 * len(sorted_vals)))
    return sorted_vals[idx]


def report_dist(name, vals_ms):
    vals = sorted(vals_ms)
    line = (f"[RESULT] {name}: min {vals[0]:.1f}, " if vals else
            f"[RESULT] {name}: empty")
    if vals:
        for q in (1, 10, 25, 50, 75, 80, 90, 95, 99):
            line += f"p{q} {pct(vals, q):.1f}, "
        line += f"max {vals[-1]:.1f} (ms)"
    print(line)


def summarize(stats, elapsed):
    """The metric set over the requests that finished: per-request
    latencies in ms (prefill = send to first token, decode = per token
    after the first, prompt = send to finish) and the averages and
    rates the report prints."""
    done = [r for r in stats.finish_ts if r in stats.first_ts
            and stats.out_tokens.get(r, 0) > 0
            and r not in stats.failed_ids]
    total_out = sum(stats.out_tokens[r] for r in done)
    total_in = sum(stats.in_tokens[r] for r in done)
    prefill = [(stats.first_ts[r] - stats.send_ts[r]) * 1e3 for r in done]
    decode = [((stats.finish_ts[r] - stats.first_ts[r])
               / max(stats.out_tokens[r] - 1, 1)) * 1e3 for r in done]
    e2e = [(stats.finish_ts[r] - stats.send_ts[r]) * 1e3 for r in done]
    n = max(len(done), 1)
    return dict(
        done=done, total_in=total_in, total_out=total_out,
        prefill_ms=prefill, decode_ms=decode, e2e_ms=e2e,
        avg_prefill_ms=sum(prefill) / n, avg_decode_ms=sum(decode) / n,
        avg_e2e_ms=sum(e2e) / n,
        time_per_token_ms=elapsed * 1e3 / max(total_out, 1),
        tokens_out_per_s=total_out / elapsed,
        tokens_inout_per_s=(total_in + total_out) / elapsed,
        requests_per_s=len(done) / elapsed)


async def measure(target, dataset, num_requests, request_rate=float("inf"),
                  token_in_out=False, early_stopping=False, timeout=None,
                  tokenizer_path=""):
    """Replay the first ``num_requests`` samples of ``dataset`` against
    ``target``; returns (their Stats, seconds from the first send to the
    last finish, the number of requests sent)."""
    if tokenizer_path:
        from ppl.llm.serving_tpu_torch.tokenizer import create_tokenizer
        tok = create_tokenizer("llama", tokenizer_path)
    else:
        from ppl.llm.serving_tpu_torch.tokenizer.factory import ByteTokenizer
        tok = ByteTokenizer()
    workload = load_workload(dataset, tok, num_requests)
    print(f"[INFO] loaded {len(workload)} requests from {dataset}")

    rng = random.Random(0)
    stats = Stats()
    async with grpc.aio.insecure_channel(target) as channel:
        t0 = time.perf_counter()
        tasks = []
        for rid, (prompt, n_in, n_out) in enumerate(workload):
            tasks.append(asyncio.create_task(run_one(
                channel, stats, rid, prompt, n_in, n_out,
                token_in_out, early_stopping, timeout=timeout)))
            if request_rate != float("inf"):
                await asyncio.sleep(rng.expovariate(request_rate))
        await asyncio.gather(*tasks)
        elapsed = time.perf_counter() - t0
    return stats, elapsed, len(workload)


def report(stats, elapsed, n_sent):
    """Print the reference's metric block; returns :func:`summarize`'s
    dict."""
    m = summarize(stats, elapsed)
    done = m["done"]
    print(f"[RESULT] benchmark time: {elapsed:.2f} s")
    print(f"[RESULT] finished {len(done)}/{n_sent} "
          f"(failed {stats.failed})")
    if done:
        print(f"[RESULT] avg input len: {m['total_in'] / len(done):.1f}, "
              f"avg output len: {m['total_out'] / len(done):.1f}")
        print(f"[RESULT] time per token: {m['time_per_token_ms']:.2f} ms")
        print(f"[RESULT] avg prefill latency: {m['avg_prefill_ms']:.1f} ms")
        print(f"[RESULT] avg decode latency per token: "
              f"{m['avg_decode_ms']:.2f} ms")
        print(f"[RESULT] avg prompt latency: {m['avg_e2e_ms']:.1f} ms")
        print(f"[RESULT] tokens out per sec: {m['tokens_out_per_s']:.1f}")
        print(f"[RESULT] tokens inout per sec: "
              f"{m['tokens_inout_per_s']:.1f}")
        print(f"[RESULT] requests per sec: {m['requests_per_s']:.2f}")
        report_dist("prefill latency", m["prefill_ms"])
        report_dist("decode latency", m["decode_ms"])
        report_dist("prompt latency", m["e2e_ms"])
    return m


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--target", default="127.0.0.1:23333")
    p.add_argument("--dataset", required=True,
                   help="samples_1024.json-format workload")
    p.add_argument("--tokenizer-path", default="")
    p.add_argument("--num-requests", type=int, default=1024)
    p.add_argument("--request-rate", type=lambda s: float(s),
                   default=float("inf"),
                   help="Poisson arrivals per second; inf = all at once")
    p.add_argument("--token-in-out", action="store_true")
    p.add_argument("--early-stopping", action="store_true",
                   help="stop on EOS (reference --early_stopping; "
                        "default ignores EOS like the reference client)")
    p.add_argument("--timeout", type=float, default=3600.0,
                   help="deadline of each request's stream, seconds")
    args = p.parse_args(argv)
    report(*asyncio.run(measure(
        args.target, args.dataset, args.num_requests, args.request_rate,
        args.token_in_out, args.early_stopping, args.timeout,
        args.tokenizer_path)))


if __name__ == "__main__":
    main()
