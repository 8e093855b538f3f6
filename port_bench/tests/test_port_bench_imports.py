"""No module of the benchmark imports JAX, jaxlib, flax or the JAX
package, and the reference imports nothing of the program: names are
compared by whole dotted components, since the port's package name
begins with the JAX package's."""

import ast
import os

import pytest

from port_bench import run

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def is_jax(name: str) -> bool:
    parts = name.split(".")
    return parts[0] in ("jax", "jaxlib", "flax") or \
        parts[:3] == ["ppl", "llm", "serving_tpu"]


def is_port(name: str) -> bool:
    return name.split(".")[:3] == ["ppl", "llm", "serving_tpu_torch"]


def imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module
            yield from (f"{node.module}.{a.name}" for a in node.names)


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_component_comparison():
    assert is_jax("ppl.llm.serving_tpu")
    assert is_jax("ppl.llm.serving_tpu.engine")
    assert is_jax("jax.numpy") and is_jax("flax")
    assert not is_jax("ppl.llm.serving_tpu_torch")
    assert not is_jax("ppl.llm.serving_tpu_torch.engine")
    assert not is_jax("jaxtyping")
    assert is_port("ppl.llm.serving_tpu_torch.ops")
    assert not is_port("ppl.llm.serving_tpu")


@pytest.mark.parametrize("path", sorted(sources()),
                         ids=lambda p: os.path.relpath(p, BENCH))
def test_no_module_imports_jax(path):
    bad = [n for n in imports(path) if is_jax(n)]
    assert not bad, f"{path} imports {bad}"


def test_the_reference_imports_nothing_of_the_program():
    for path in sources("reference"):
        names = list(imports(path))
        assert not [n for n in names if is_port(n) or is_jax(n)
                    or n.split(".")[0] == "ppl"], path


def test_the_run_check_matches_whole_components():
    mods = {"ppl.llm.serving_tpu_torch": 1,
            "ppl.llm.serving_tpu_torch.engine": 1, "jaxtyping": 1,
            "numpy": 1}
    assert run.jax_loaded(mods) == []
    mods.update({"ppl.llm.serving_tpu": 1, "jax._src": 1, "flax": 1})
    assert run.jax_loaded(mods) == ["flax", "jax._src",
                                    "ppl.llm.serving_tpu"]


@pytest.mark.parametrize("late", ["jax", "ppl.llm.serving_tpu.engine"])
def test_a_late_import_withholds_the_result(monkeypatch, capsys, late):
    """A module that the reference or a metric's reader loads after the
    program has stopped is caught before the result line is printed."""
    import sys
    import types

    import torch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(run, "set_cache_env", lambda env=None: None)

    def run_cell(*args, **kwargs):
        monkeypatch.setitem(sys.modules, late, types.ModuleType(late))
        return {"correct": True}, ["check failed: 0 (limit 0)"]
    monkeypatch.setattr(run, "run_cell", run_cell)
    assert run.main(["--workload", "baichuan13b.chat", "--seed", "1",
                     "--seconds", "1", "--trace", "0"]) == 3
    out, err = capsys.readouterr()
    assert out == ""
    assert late in err
