"""Host-computed constants on the device, copied there once.

A value the host computes (a resize matrix, a scheduler row's coefficients,
the CLIP normalization, positional codes) is copied to the device at its
first use and kept. A copy from pageable host memory waits for the stream,
and a CUDA graph cannot capture one: core/engine.py runs each program once
before it captures it, so the captured program finds its constants here.
Never write to a tensor this returns.
"""

from __future__ import annotations

import threading

import numpy as np
import torch

_cache: dict = {}
_lock = threading.Lock()


def device_constant(array, device, dtype=None) -> torch.Tensor:
    """`array` (numpy, or a sequence of numbers) as a tensor on `device`,
    cast to `dtype` (default: the array's own), made once per values,
    dtype and device."""
    a = np.ascontiguousarray(array)
    device = torch.device(device)
    key = (a.tobytes(), a.dtype.str, a.shape, str(dtype), str(device))
    with _lock:
        t = _cache.get(key)
        if t is None:
            t = torch.tensor(a, dtype=dtype, device=device)
            _cache[key] = t
        return t
