"""Build and load the port's CUDA kernels.

Each ``ops/csrc/<name>.cu`` exports plain C functions.  At first use it
is compiled by ``nvcc`` for sm_90a into ``build/torch_kernels/`` at the
root of the checkout and loaded with ctypes (no PyTorch headers, so a
build takes seconds).  The library file carries a hash of its source and
of the shared headers (``csrc/*.cuh``), so an edited kernel is never
served from a stale build.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "torch_kernels"
# --split-compile=0: the device code is optimised on every core at once (a
# source of many template instances builds in about half the time)
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
              "--split-compile=0"]

_libs: dict[str, ctypes.CDLL] = {}
_lock = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built on the machine with the card")
    return path


def library_path(name: str) -> Path:
    """where the library of csrc/<name>.cu goes: its file name carries a
    hash of the source and of every shared header, so a change to either
    gives a new library"""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> Path:
    """compile csrc/<name>.cu unless its library is already built; the
    compiler's register/spill report goes to <library>.log"""
    out = library_path(name)
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
                        str(CSRC / f"{name}.cu")],
                       capture_output=True, text=True)
    out.with_suffix(".log").write_text(r.stdout + r.stderr)
    if r.returncode != 0:
        raise RuntimeError(f"nvcc failed on {name}.cu:\n{r.stderr[-4000:]}")
    os.replace(tmp, out)   # atomic: concurrent builds of one source agree
    return out


def load(name: str) -> ctypes.CDLL:
    """the loaded kernel library, built on first use"""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = _libs[name] = ctypes.CDLL(str(build(name)))
        return lib
