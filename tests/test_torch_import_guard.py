"""The port imports neither JAX nor anything of the JAX package, nor
``safetensors`` or ``transformers``, and importing it builds nothing.
Checked in a subprocess, because this test session's conftest imports
jax. The walk covers the serving frontend (``serving.*``: gRPC server,
proto, metrics, dp router), the serving tools, the checkpoint loader,
the sentencepiece tokenizer, the eval tools and the measuring tools
(bench, trace_summary, validate_kernels, the microbenches, bench_sweep,
bench_cold_start, bench_canonical, microbench_tunnel), of these only
bench_cold_start and bench_canonical (gRPC clients of the server) may
load grpc, tensor parallelism (``parallel.*``: shardings, kernel_tp,
multihost), the data-parallel replicas' channel (``serving.replicas``),
the library-embedding sample (``samples.embed_serving``) and the native
host runtime (``utils._native``), whose C++ source is the port's own file
and which builds nothing at import either."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

GUARD = r"""
import importlib, os, pkgutil, sys
import ppl.llm.serving_tpu_torch as port
names = [m.name for m in pkgutil.walk_packages(port.__path__,
                                               port.__name__ + ".")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules
             if k == "jax" or k.startswith("jax.") or k.startswith("jaxlib")
             or k == "ppl.llm.serving_tpu"
             or k.startswith("ppl.llm.serving_tpu."))
print(len(names), bad)
assert not bad, bad
serving = {"serving", "serving.grpc_server", "serving.metrics",
           "serving.dp_router", "serving.replicas", "serving.proto",
           "serving.proto.llm_pb2",
           "tools.llm_server", "tools.client_sample",
           "tools.client_qps_measure", "tools.client_pressure",
           "tools.gen_samples", "tools.benchmark_prefix_cache",
           "tools.bench_cold_start"}
missing = {m for m in serving if port.__name__ + "." + m not in names}
assert not missing, missing
checkpoints = {"models.loader", "tokenizer.sp_model", "tokenizer.sp_tokenizer",
               "tools.eval_ppl", "tools.eval_accuracy_delta"}
missing = {m for m in checkpoints if port.__name__ + "." + m not in names}
assert not missing, missing
missing = {m for m in MEASURING if port.__name__ + "." + m not in names}
assert not missing, missing
# the library-embedding sample
assert port.__name__ + ".samples.embed_serving" in names
# tensor parallelism over torch.distributed
parallel = {"parallel", "parallel.shardings", "parallel.kernel_tp",
            "parallel.multihost"}
missing = {m for m in parallel if port.__name__ + "." + m not in names}
assert not missing, missing
# the port reads safetensors and trains its probe without these packages
others = sorted(k for k in sys.modules
                if k.split(".")[0] in ("safetensors", "transformers"))
assert not others, others
assert "triton" not in sys.modules
from ppl.llm.serving_tpu_torch.ops.kernels import _build
print("built:", sorted(_build._libs))
assert not _build._libs
# the native host runtime: the port's own C++ source, nothing loaded yet
assert port.__name__ + ".utils._native" in names
from ppl.llm.serving_tpu_torch.utils import _native
assert _native._module is None and _native.MODULE not in sys.modules
src = os.path.realpath(_native.SOURCE)
assert src == os.path.join(os.path.realpath(port.__path__[0]), "csrc",
                           "ppl_llm_host.cpp"), src
assert os.path.isfile(src)
"""


# the measuring tools; all but the gRPC clients stay clear of grpc
GRPC_CLIENTS = ("tools.bench_cold_start", "tools.bench_canonical")
MEASURING = ("tools.bench", "tools.trace_summary", "tools.validate_kernels",
             "tools.microbench_quant_matmul", "tools.microbench_scatter",
             "tools.bench_sweep", "tools.microbench_tunnel") + GRPC_CLIENTS

NO_GRPC = r"""
import importlib, sys
n_clients = int(sys.argv[1])
names = sys.argv[2:]
for name in names[:-n_clients]:
    importlib.import_module("ppl.llm.serving_tpu_torch." + name)
loaded = sorted(k for k in sys.modules if k.split(".")[0] == "grpc")
assert not loaded, loaded
for name in names[-n_clients:]:
    importlib.import_module("ppl.llm.serving_tpu_torch." + name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib")
             or k.startswith("ppl.llm.serving_tpu."))
assert not bad, bad
print("ok")
"""


def test_port_imports_no_jax():
    out = subprocess.run([sys.executable, "-c",
                          f"MEASURING = {MEASURING!r}\n" + GUARD], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr
    n_modules = int(out.stdout.split()[0])
    assert n_modules >= 45, out.stdout


def test_port_sources_name_no_jax():
    """No module of the port, nor chip_smoke.py, names jax or the JAX
    package in an import."""
    root = os.path.join(REPO, "ppl", "llm", "serving_tpu_torch")
    paths = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, files in os.walk(root):
        paths += [os.path.join(dirpath, f) for f in files
                  if f.endswith(".py")]
    offenders = []
    for path in paths:
        with open(path) as fh:
            for line in fh:
                s = line.strip()
                if not s.startswith(("import ", "from ")):
                    continue
                words = s.replace(",", " ").split()
                if any(w == "jax" or w.startswith("jax.")
                       or w.startswith("ppl.llm.serving_tpu.")
                       or w == "ppl.llm.serving_tpu" for w in words):
                    offenders.append(f"{path}: {s}")
    assert len(paths) >= 30 and not offenders, offenders


def test_measuring_tools_load_no_grpc_but_bench_cold_start():
    """The bench, the trace summary, validate_kernels, the microbenches and
    the sweep import without grpc (they run where no server does);
    bench_cold_start and bench_canonical, gRPC clients of the server, are
    allowed it."""
    assert MEASURING[-len(GRPC_CLIENTS):] == GRPC_CLIENTS
    out = subprocess.run([sys.executable, "-c", NO_GRPC,
                          str(len(GRPC_CLIENTS)), *MEASURING],
                         cwd=REPO, capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0 and out.stdout.strip() == "ok", \
        out.stdout + out.stderr
