"""Build the package's CUDA sources with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` is compiled at first use into its own shared library
with a plain C interface, ``build/torch_kernels/lib<name>_<hash>.so`` at the
root of the checkout.  The hash covers the source, every ``csrc/*.cuh``
header and the flags, so an edited kernel is rebuilt and an unchanged one is
loaded as it is.  ``build()`` starts one nvcc per source, all at once.  A
build failure raises with the compiler's output; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

_PKG_DIR = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG_DIR, "csrc")
# csrc/<name>.cu
SOURCES = ("neighbors", "fps", "groups", "dense", "knn_group", "group_mlp")
BUILD_DIR = os.path.join(os.path.dirname(_PKG_DIR), "build", "torch_kernels")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                           "bin", "nvcc")
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def source_path(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def library_path(name: str) -> str:
    """Path of the built library of ``csrc/<name>.cu`` for the current
    source, headers and flags."""
    digest = hashlib.sha256()
    for path in [source_path(name)] + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Compile the given sources (default: all) into their libraries, one
    nvcc process per source, all started together.  Returns each source's
    nvcc output (the ptxas report: registers and spills of each kernel)."""
    names = list(SOURCES if names is None else names)
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = {}
    for name in names:
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        proc = subprocess.Popen([nvcc_path(), *NVCC_FLAGS, "-o", tmp,
                                 source_path(name)],
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                text=True)
        jobs[name] = (proc, tmp)
    reports, failed = {}, []
    for name, (proc, tmp) in jobs.items():
        reports[name] = proc.communicate()[0]
        if proc.returncode != 0:
            os.unlink(tmp)
            failed.append(name)
        else:
            os.replace(tmp, library_path(name))   # atomic: never half a file
    if failed:
        raise RuntimeError("nvcc failed for " + ", ".join(
            f"{source_path(n)}:\n{reports[n]}" for n in failed))
    return reports


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu``, compiled first if missing."""
    path = library_path(name)
    if not os.path.exists(path):
        build([name])
    return ctypes.CDLL(path)
