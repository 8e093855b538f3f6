"""Finding a cell's pieces by the names ``BENCHMARK.json`` gives them: the
configuration's file, the traffic file ``port_bench/traffic/<traffic>.json``,
the cell's file ``port_bench/cells/<workload>.json`` (its correctness
limits), and each metric's reader in ``port_bench/metrics/``.

A metric's reader is a module of ``port_bench/metrics/`` with ``read(ctx,
name)``, found by the metric's name: the module whose ``NAMES`` lists the
name, or else whose file is named after it, or after the part of it
before the first dot (``mfu.tail`` and ``mfu.tput`` are ``mfu.py``'s).
A later change adds a cell, a mix, a configuration or a metric by adding
files and entries; nothing here names one.
"""

from __future__ import annotations

import importlib.util
import json
import os
from typing import Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))


def load_json(path: str) -> Dict:
    with open(path) as f:
        return json.load(f)


class Bench:
    """``BENCHMARK.json`` at ``root`` and the files it names."""

    def __init__(self, root: str):
        self.root = root
        self.dir = os.path.join(root, os.path.basename(HERE))
        self.spec = load_json(os.path.join(root, "BENCHMARK.json"))
        self._readers: Optional[Dict[str, Callable]] = None

    def workload(self, name: str) -> Dict:
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json (known: "
                       f"{[w['name'] for w in self.spec['workloads']]})")

    def config_entry(self, name: str) -> Dict:
        for c in self.spec["configs"]:
            if c["name"] == name:
                return c
        raise KeyError(f"no config {name!r} in BENCHMARK.json")

    def config_path(self, workload: Dict) -> str:
        return os.path.join(self.root,
                            self.config_entry(workload["config"])["file"])

    def traffic(self, workload: Dict) -> Dict:
        return load_json(os.path.join(self.dir, "traffic",
                                      workload["traffic"] + ".json"))

    def cell(self, workload: Dict) -> Dict:
        return load_json(os.path.join(self.dir, "cells",
                                      workload["name"] + ".json"))

    def metrics(self, kind: str, workload: Dict) -> List[Dict]:
        """The ``end_to_end`` or ``per_layer`` metrics this cell reports:
        those without a ``workloads`` list and those whose list names
        it."""
        return [m for m in self.spec[kind]
                if workload["name"] in m.get("workloads", [workload["name"]])]

    def readers(self) -> Dict[str, Callable]:
        if self._readers is None:
            self._readers = {}
            mdir = os.path.join(self.dir, "metrics")
            for fn in sorted(os.listdir(mdir)):
                if not fn.endswith(".py") or fn.startswith("_"):
                    continue
                stem = fn[:-3]
                spec = importlib.util.spec_from_file_location(
                    f"port_bench.metrics.{stem}", os.path.join(mdir, fn))
                mod = importlib.util.module_from_spec(spec)
                spec.loader.exec_module(mod)
                for n in getattr(mod, "NAMES", (stem,)):
                    self._readers[n] = mod.read
        return self._readers

    def reader(self, name: str) -> Callable:
        readers = self.readers()
        for key in (name, name.split(".")[0]):
            if key in readers:
                return readers[key]
        raise KeyError(f"no reader for the metric {name!r} in "
                       f"{os.path.join(self.dir, 'metrics')}")
