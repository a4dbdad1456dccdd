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
           "ff_geglu_sm90", "pv_product_sm90", "window_taps_sm90")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
# ptxas report (registers, shared memory, spills) of each build in this
# process, by source name.
build_reports: dict[str, str] = {}


class LaunchCounter:
    """Counts a wrapper's kernel launches, in all, by shape and by the
    dtype of the launch ("bfloat16", "float32": which source ran); `split`
    counts apart the launches beyond a call's first, where a call's batch
    ran in several launches (batch_runs). Every counter made is in
    `LaunchCounter.all`: a CUDA graph's replay calls no wrapper, so
    core/engine.py adds what its capture counted (snapshot, add)."""

    all: list = []

    def __init__(self, name: str):
        self.name = name
        self.launches = 0
        self.split = 0
        self.shapes: Counter = Counter()
        self.dtypes: Counter = Counter()
        LaunchCounter.all.append(self)

    def snapshot(self) -> tuple:
        return (self.launches, self.split, Counter(self.shapes),
                Counter(self.dtypes))

    def restore(self, snap: tuple) -> None:
        self.launches, self.split = snap[0], snap[1]
        self.shapes, self.dtypes = Counter(snap[2]), Counter(snap[3])

    def add(self, delta: tuple) -> None:
        """Adds a (launches, split, shapes, dtypes) delta, as recorded
        between two snapshots."""
        self.launches += delta[0]
        self.split += delta[1]
        self.shapes.update(delta[2])
        self.dtypes.update(delta[3])

    def since(self, snap: tuple) -> tuple:
        """The delta of the counts since `snap`."""
        return (self.launches - snap[0], self.split - snap[1],
                self.shapes - snap[2], self.dtypes - snap[3])

    def record(self, shape_key, dtype=None, split: bool = False) -> None:
        self.launches += 1
        self.split += bool(split)
        self.shapes[shape_key] += 1
        if dtype is not None:
            self.dtypes[str(dtype).removeprefix("torch.")] += 1

    def reset(self) -> None:
        self.launches = 0
        self.split = 0
        self.shapes = Counter()
        self.dtypes = Counter()


# the most blocks of a grid's y and z dimensions
GRID_LIMIT = 65535


def batch_runs(B: int, m_tiles_of) -> list:
    """[(b0, b1), ...]: a batch of B images in as few launches as keep each
    launch's m_tiles_of(images) within GRID_LIMIT (the kernels' tile index
    is gridDim.y), in runs that differ by at most one image; [(0, B)] where
    one launch holds them all."""
    if m_tiles_of(B) <= GRID_LIMIT:
        return [(0, B)]
    most = B - 1
    while most > 1 and m_tiles_of(most) > GRID_LIMIT:
        most -= 1
    if m_tiles_of(most) > GRID_LIMIT:
        raise ValueError(f"one image needs {m_tiles_of(1)} tiles, above "
                         f"the grid's {GRID_LIMIT}")
    n = -(-B // most)
    bounds = [B * k // n for k in range(n + 1)]
    return list(zip(bounds[:-1], bounds[1:]))


def launch_by_runs(B: int, m_tiles_of, launch, counter, key, dtype):
    """launch(b0, n) once for each run of whole images batch_runs gives,
    each launch counted on `counter` (if any), those past the first as
    split. Returns what the launches returned (a run's statistics or None),
    joined along the batch."""
    got = []
    for k, (b0, b1) in enumerate(batch_runs(B, m_tiles_of)):
        got.append(launch(b0, b1 - b0))
        if counter is not None:
            counter.record(key, dtype, split=k > 0)
    if len(got) == 1 or got[0] is None:
        return got[0]
    import torch

    return torch.cat(got)


def offset_ptr(t, b0: int):
    """The address of image b0 of a batch-major tensor (None for None)."""
    if t is None:
        return None
    if b0 == 0:
        return t.data_ptr()
    return t.data_ptr() + b0 * t.stride(0) * t.element_size()


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
