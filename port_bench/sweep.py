"""The knee sweep of an open-loop cell: one server, the cell's traffic
offered at each of a list of rates in turn, and a line for each rate.

    python3 -m port_bench.sweep --workload <name> --seed <n> \\
        --rates 2,3,4,5 [--seconds 30] [--warmup 8] [--drain 30]

Each rate runs the load generator afresh (warm-up, window, drain); the
line gives the window's TTFT median and 95th percentile, TPOT's 95th
percentile, the output tokens a second, the requests due and failed,
the share of due requests finished per second of the window, and the
median TTFT of the window's second half over its first's (above 1 the
queue grew through the window). The knee is the highest rate whose
queue does not grow; a cell's traffic file then fixes four fifths of
it. Not part of a run: the benchmark never searches for a rate.
"""

from __future__ import annotations

import argparse
import json
import statistics
import sys
import time
from typing import List, Optional

from port_bench import run, stats


def sweep_line(rate: float, result: dict) -> dict:
    window = stats.in_window(result["requests"])
    w0, w1 = result["window"]
    mid = (w0 + w1) / 2
    ttft = [stats.ttft_ms(r) for r in window]
    halves = [[stats.ttft_ms(r) for r in window
               if (r["due"] < mid) == first] for first in (True, False)]
    growth = None
    if all(halves):
        growth = statistics.median(halves[1]) / statistics.median(halves[0])
    return dict(rate=rate, due=len(window),
                failed=sum(r["failed"] for r in window),
                ttft_p50_ms=stats.tail_ms(ttft, 50),
                ttft_p95_ms=stats.tail_ms(ttft, 95),
                tpot_p95_ms=stats.tail_ms([stats.tpot_ms(r) for r in window],
                                          95),
                out_tok_s=stats.tokens_between(result["requests"], w0, w1)
                / (w1 - w0),
                ttft_growth=growth)


def main(argv: Optional[List[str]] = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--rates", required=True)
    p.add_argument("--seconds", type=float, default=30)
    p.add_argument("--warmup", type=float, default=8)
    p.add_argument("--drain", type=float, default=30)
    args = p.parse_args(argv)
    run.set_cache_env()
    from port_bench.registry import Bench, load_json
    from port_bench.server import PortServer
    bench = Bench(run.ROOT)
    work = bench.workload(args.workload)
    traffic = dict(bench.traffic(work), drain_s=args.drain)
    cfg_path = bench.config_path(work)
    cfg = load_json(cfg_path)
    server = PortServer(cfg_path, cfg, args.seed, "cuda")
    print(f"[sweep] set-up {json.dumps(server.setup)}, KV pool "
          f"{server.kv_max} tokens", file=sys.stderr, flush=True)
    try:
        for rate in (float(r) for r in args.rates.split(",")):
            client = run.ClientProcess(dict(
                target=f"127.0.0.1:{server.port}", traffic=traffic,
                seed=args.seed, seconds=args.seconds,
                vocab=cfg["vocab_size"], page_size=cfg["page_size"],
                warmup_s=args.warmup, rate_per_s=rate))
            try:
                result = json.loads(client.expect(
                    "RESULT", args.warmup + args.seconds + args.drain + 120))
            finally:
                client.close()
            print(json.dumps(sweep_line(rate, result)), flush=True)
            time.sleep(2)
    finally:
        server.stop()
    return 0


if __name__ == "__main__":
    sys.exit(main())
