"""Build and load the port's CUDA kernels.

Each source in ``csrc/`` compiles with ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, loaded with ``ctypes``.
Nothing builds when a module is imported: a wrapper's first launch
builds its library (``load``), and :func:`build_all` builds every source
at once, one ``nvcc`` process per source, all started together.

Libraries land in ``$PPL_COMPILE_CACHE/kernels`` when that variable is
set and not empty (as the JAX package's compile cache reads it), else in
``build/kernels/`` inside the package directory (listed in
``.gitignore``); :func:`build_dir` says which. They are named by a hash
of the source text, of every shared header (``csrc/*.cuh``) and of the
compiler flags, so an edited source or header never loads a stale
library. A build writes to a temporary name and renames it into place,
and the compiler's ``-Xptxas -v`` report (registers, shared memory,
spills) is kept beside the library as ``<name>.ptxas.txt``.
:func:`sass_counts` counts chosen instructions (the tensor cores'
``IMMA``, ``HMMA``; the bulk copy's ``UBLKCP``) per kernel of a built
library, from :func:`sass_listing`; :func:`sm_count`
reads the device's SM count for the launch plans.
Every ``nvcc`` run is logged with its seconds (``nvcc built <library> in
<s> s``) and kept in :data:`build_seconds`.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import re
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Dict, Iterable, List

import torch

_PKG_DIR = Path(__file__).resolve().parents[2]
SRC_DIR = _PKG_DIR / "csrc"
BUILD_DIR = _PKG_DIR / "build" / "kernels"
SOURCES = ("paged_attention", "quant_matmul", "cache_read")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: Dict[str, ctypes.CDLL] = {}
# source name -> seconds its last nvcc run took, in this process
build_seconds: Dict[str, float] = {}
logger = logging.getLogger("ppl.llm.serving_tpu_torch.kernels")


def build_dir() -> Path:
    """Where the libraries go: ``$PPL_COMPILE_CACHE/kernels`` when the
    variable is set and not empty, else :data:`BUILD_DIR`."""
    root = os.environ.get("PPL_COMPILE_CACHE", "")
    return Path(root) / "kernels" if root else BUILD_DIR


def find_nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        nvcc = "/usr/local/cuda/bin/nvcc"
    if nvcc is None:
        raise RuntimeError(
            "nvcc not found: the CUDA kernels of serving_tpu_torch build "
            "with the CUDA toolkit at first use")
    return nvcc


def library_path(name: str) -> Path:
    h = hashlib.sha1((SRC_DIR / f"{name}.cu").read_bytes())
    for header in sorted(SRC_DIR.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return build_dir() / f"lib{name}_{h.hexdigest()[:16]}.so"


def _start(name: str, nvcc: str):
    out = library_path(name)
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(SRC_DIR / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return name, proc, tmp, out, time.perf_counter()


def _finish(name: str, proc, tmp: Path, out: Path, t0: float) -> None:
    log, _ = proc.communicate()
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {out.name}:\n{log}")
    out.with_name(out.name.replace(".so", ".ptxas.txt")).write_text(log)
    os.replace(tmp, out)
    build_seconds[name] = seconds
    logger.info("nvcc built %s in %.1f s", out.name, seconds)


def build(names: Iterable[str]) -> List[Path]:
    """Build the libraries of ``names`` that are not built yet, all
    compilers running at once; returns their paths."""
    names = list(names)
    build_dir().mkdir(parents=True, exist_ok=True)
    pending = [n for n in names if not library_path(n).exists()]
    if pending:
        nvcc = find_nvcc()
        jobs = [_start(n, nvcc) for n in pending]
        # one waiting thread a compiler, so that each one's seconds end
        # when it does
        with ThreadPoolExecutor(len(jobs)) as pool:
            futures = [pool.submit(_finish, *job) for job in jobs]
        errors = []
        for fut in futures:
            try:
                fut.result()
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))
    return [library_path(n) for n in names]


def build_all() -> List[Path]:
    return build(SOURCES)


def ptxas_report(name: str) -> str:
    """The compiler's register/shared-memory/spill lines for ``name``."""
    path = library_path(name)
    rep = path.with_name(path.name.replace(".so", ".ptxas.txt"))
    if not rep.exists():
        return ""
    return "\n".join(line for line in rep.read_text().splitlines()
                     if "registers" in line or "spill" in line
                     or "Compiling entry" in line)


def find_cuobjdump() -> str:
    tool = shutil.which("cuobjdump")
    if tool is None:
        nvcc = Path(find_nvcc())
        tool = str(nvcc.with_name("cuobjdump"))
    return tool


def parse_sass_counts(sass: str, ops: Iterable[str]) -> Dict[str, Dict[str, int]]:
    """Per function of a ``cuobjdump -sass`` listing, how many
    instructions start with each opcode of ``ops`` (``IMMA`` matches
    ``IMMA.16832.S8.S8``, not ``IMMAX``)."""
    ops = tuple(ops)
    counts: Dict[str, Dict[str, int]] = {}
    current = None
    pat = re.compile(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_]*)")
    for line in sass.splitlines():
        head = line.strip()
        if head.startswith("Function : "):
            current = counts.setdefault(head[len("Function : "):].strip(),
                                        {op: 0 for op in ops})
            continue
        m = pat.search(line)
        if current is not None and m and m.group(1) in ops:
            current[m.group(1)] += 1
    return counts


def sass_listing(name: str) -> str:
    """``cuobjdump -sass`` of the built library of source ``name``."""
    (path,) = build([name])
    return subprocess.run([find_cuobjdump(), "-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout


def sass_counts(name: str, ops: Iterable[str] = ("IMMA", "HMMA")
                ) -> Dict[str, Dict[str, int]]:
    """``parse_sass_counts`` of the built library of source ``name``."""
    return parse_sass_counts(sass_listing(name), ops)


_SM_COUNT: Dict[object, int] = {}


def sm_count(device) -> int:
    """The SM count of a CUDA device (what the launch plans read)."""
    if device not in _SM_COUNT:
        _SM_COUNT[device] = torch.cuda.get_device_properties(
            device).multi_processor_count
    return _SM_COUNT[device]


def load(name: str) -> ctypes.CDLL:
    """The loaded library of source ``name``, built on first use."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            (path,) = build([name])
            lib = ctypes.CDLL(str(path))
            _libs[name] = lib
        return lib
