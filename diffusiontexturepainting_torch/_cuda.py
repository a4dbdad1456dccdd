"""Build the package's CUDA kernels with nvcc and bind them with ctypes.

Each `csrc/<name>.cu` becomes one shared library with a plain C interface,
built for Hopper (`sm_90a`) at first use into `_build/<digest>/`, where
the digest covers the sources and the compiler flags, so an edited source
never loads a stale library. Nothing here runs at import time: the package
imports on machines without CUDA, and only a CUDA tensor reaches a kernel.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import tempfile
import threading
import time
from collections import Counter
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parent / "_build"
SOURCES = ("conv3x3", "flash_attention", "ff_geglu", "moments",
           "conv_staged", "attn_arms", "attn_layouts", "attn_transposed",
           "conv_arms", "flash_attention_sm90", "conv_sm90", "gn_conv_sm90",
           "ff_geglu_sm90", "pv_product_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this
# process, by source name.
build_reports: dict[str, str] = {}


class LaunchCounter:
    """Counts a wrapper's kernel launches, in all and by shape."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.shapes: Counter = Counter()

    def record(self, shape_key) -> None:
        self.launches += 1
        self.shapes[shape_key] += 1

    def reset(self) -> None:
        self.launches = 0
        self.shapes = Counter()


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on "
                           "PATH); the kernels are built from csrc/ at "
                           "first use")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def _digest(name: str) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.glob("*.cuh")) + [CSRC / f"{name}.cu"]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_ROOT / _digest(name) / f"libdtp_{name}.so"


def build(name: str) -> Path:
    """Compile csrc/<name>.cu unless its digest's library exists."""
    out = library_path(name)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    # compile to a private name, then rename: a concurrent or interrupted
    # build never leaves a half-written library under the final name
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=out.parent)
    os.close(fd)
    try:
        cmd = [_nvcc(), *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp,
               str(CSRC / f"{name}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {name}.cu:\n{proc.stderr}")
        build_reports[name] = proc.stderr
        os.replace(tmp, out)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)
    return out


def build_all() -> float:
    """Build every kernel library in parallel; returns the seconds taken."""
    tic = time.perf_counter()
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        list(pool.map(build, SOURCES))
    return time.perf_counter() - tic


def library(name: str) -> ctypes.CDLL:
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            lib.dtp_error_string.restype = ctypes.c_char_p
            lib.dtp_error_string.argtypes = [ctypes.c_int]
            _libs[name] = lib
        return lib


@functools.cache
def function(source: str, symbol: str, argtypes: tuple):
    """The C entry point `symbol` of csrc/<source>.cu, returning a
    cudaError_t as int."""
    fn = getattr(library(source), symbol)
    fn.restype = ctypes.c_int
    fn.argtypes = list(argtypes)
    return fn


def check(source: str, symbol: str, code: int) -> None:
    if code != 0:
        msg = library(source).dtp_error_string(code).decode()
        raise RuntimeError(f"{symbol} failed: CUDA error {code} ({msg})")


def stream_of(t) -> int:
    import torch

    return torch.cuda.current_stream(t.device).cuda_stream
