"""A scratch checkout for the CPU tests: a copy of ``port_bench`` with a
``BENCHMARK.json`` whose cells serve tiny models of the two families at
a few requests a second, so that a whole run fits a test on the CPU."""

from __future__ import annotations

import json
import os
import shutil

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

TINY = {
    "hidden_dim": 64, "intermediate_dim": 128, "num_layers": 2,
    "num_heads": 4, "num_kv_heads": 4, "vocab_size": 256,
    "norm_eps": 1e-06, "cache_quant_bit": 8, "cache_quant_group": 8,
    "cache_layout": 0, "cache_mode": 1, "page_size": 16,
    "dynamic_batching": True, "auto_causal": True, "dtype": "bfloat16",
    "reduced": [],
}
FLAGS = ["--dtype", "bfloat16", "--quant-method", "online_i8i8",
         "--cache-quant-bit", "8", "--enable-prefix-cache",
         "--batch-buckets", "8", "--max-running-batch", "8",
         "--token-buckets", "64,128,256", "--max-input-tokens-per-request",
         "256", "--max-total-tokens-per-request", "320",
         "--max-tokens-per-step", "320", "--kv-cache-max-tokens", "4096",
         "--page-size", "16"]
CONFIGS = {
    "tiny-alibi": dict(TINY, model_type="baichuan", position_encoding="alibi",
                       server_flags=FLAGS),
    "tiny-bias": dict(TINY, model_type="internlm", attn_bias=True,
                      server_flags=FLAGS),
}
COMMON = {"warmup_s": 1.0, "drain_s": 60, "trace_offset_s": 0.2,
          "trace_seconds": 0.8, "sample_min_served": 40,
          "sample_max_requests": 3}
TRAFFIC = {
    "tiny-chat": dict(COMMON, loop="open", rate_per_s=6.0,
                      prompt={"dist": "lognormal", "median": 40,
                              "sigma": 0.5, "min": 8, "max": 120},
                      output={"dist": "lognormal", "median": 12,
                              "sigma": 0.4, "min": 4, "max": 32}),
    "tiny-sessions": dict(COMMON, loop="open", rate_per_s=3.0,
                          sessions={"system_prompts": 3,
                                    "system_tokens": 48, "zipf_s": 1.1,
                                    "turns_min": 2, "turns_max": 3,
                                    "think_mean_s": 0.1, "context": 256},
                          prompt={"dist": "lognormal", "median": 12,
                                  "sigma": 0.4, "min": 4, "max": 24},
                          output={"dist": "lognormal", "median": 8,
                                  "sigma": 0.4, "min": 4, "max": 16}),
    "tiny-docs": dict(COMMON, loop="closed", clients=3, pool=16,
                      prompt={"dist": "uniform", "min": 64, "max": 200},
                      output={"dist": "uniform", "min": 4, "max": 16}),
}
CELLS = [("tiny.chat", "tiny-alibi", "tiny-chat"),
         ("tiny.sessions", "tiny-bias", "tiny-sessions"),
         ("tiny.docs", "tiny-alibi", "tiny-docs")]
# the widest gap sound tiny runs read on the CPU: 0 to 0.0045 (two seeds
# a cell); the program's int4 path (the control) 0.165 to 0.382 on the
# same seeds, a token altered where it is produced more
TINY_LIMIT = 0.05


def make_root(dst: str) -> str:
    """A checkout at ``dst``: ``port_bench`` copied (code and data) with
    the tiny configurations, mixes and cells added; returns ``dst``."""
    bench = os.path.join(dst, "port_bench")
    shutil.copytree(BENCH_DIR, bench, ignore=shutil.ignore_patterns(
        ".cache", "__pycache__", "tests"))
    spec = json.load(open(os.path.join(os.path.dirname(BENCH_DIR),
                                       "BENCHMARK.json")))
    for name, cfg in CONFIGS.items():
        with open(os.path.join(bench, "configs", name + ".json"), "w") as f:
            json.dump(cfg, f)
        spec["configs"].append({"name": name, "source": "tests",
                                "file": f"port_bench/configs/{name}.json",
                                "reduced": []})
    for name, t in TRAFFIC.items():
        with open(os.path.join(bench, "traffic", name + ".json"), "w") as f:
            json.dump(t, f)
    names = [c[0] for c in CELLS]
    for name, config, traffic in CELLS:
        spec["workloads"].append({"name": name, "config": config,
                                  "traffic": traffic, "chips": 1,
                                  "why": "tests"})
        with open(os.path.join(bench, "cells", name + ".json"), "w") as f:
            json.dump({"max_logit_gap": TINY_LIMIT}, f)
    for m in spec["end_to_end"] + spec["per_layer"]:
        if "workloads" in m:
            m["workloads"] += names[:2]
    # the closed-loop cell's throughput and KV-pool readers
    spec["end_to_end"].append({"name": "out_tok_s", "unit": "tokens/s",
                               "better": "higher", "bound": 0.25,
                               "source": "host_clock",
                               "workloads": names[2:]})
    spec["per_layer"].append({"name": "kv_used", "unit": "%",
                              "better": "higher",
                              "source": "program_counter",
                              "layer": "KV pool", "moves": "out_tok_s",
                              "workloads": names[2:]})
    with open(os.path.join(dst, "BENCHMARK.json"), "w") as f:
        json.dump(spec, f, indent=1)
    return dst
