"""Build the port's CUDA kernels from the sources in ``kernels/csrc``.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, compiled by ``nvcc`` for Hopper (``sm_90a``) and loaded with
``ctypes``. Nothing is built at import time: a kernel's wrapper calls
:func:`load` at its first launch. Libraries land in
``kernels/build/<hash>/`` (git-ignored), keyed by a hash of the sources
and flags, so an edit rebuilds and a second run in the same checkout
reuses the build. ``nvcc``'s ``-Xptxas -v`` report (registers, shared
memory, spills) is kept beside each library as ``<name>.log``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Iterable, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD = Path(__file__).resolve().parent / "build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found (looked on PATH and in "
                           "/usr/local/cuda/bin): the CUDA kernels are built "
                           "from source at first use and need the CUDA toolkit")
    return path


def sources() -> list:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD / h.hexdigest()[:16] / f"lib{name}.so"


def build_all(names: Optional[Iterable[str]] = None) -> Dict[str, float]:
    """Compile every named source (default: all) that has no current
    library, one ``nvcc`` per source, all started together. Returns the
    seconds each build took (0.0 for one already built). Raises with
    ``nvcc``'s output when a build fails."""
    names = list(sources() if names is None else names)
    started = {}
    secs = {name: 0.0 for name in names}
    for name in names:
        out = lib_path(name)
        if out.exists():
            continue
        out.parent.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        started[name] = (proc, tmp, out, time.perf_counter())
    for name, (proc, tmp, out, t0) in started.items():
        log, _ = proc.communicate()
        secs[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed to build {name}.cu "
                               f"(exit {proc.returncode}):\n{log}")
        out.with_name(f"{name}.log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return secs


def build_log(name: str) -> str:
    """The ``-Xptxas -v`` report of the current build of ``name``."""
    return lib_path(name).with_name(f"{name}.log").read_text()


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """Multiprocessors of CUDA device ``index``, for the launch plans."""
    import torch

    return torch.cuda.get_device_properties(index).multi_processor_count


def load(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = _loaded[name] = ctypes.CDLL(str(lib_path(name)))
    return lib
