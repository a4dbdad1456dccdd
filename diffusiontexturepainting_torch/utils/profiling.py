"""Latency instrumentation.

Port of diffusiontexturepainting_tpu/utils/profiling.py. `StageTimer` keeps
named wall-clock stages and prints the JAX package's table of them; on a
CUDA device it also records a pair of CUDA events a stage on the device's
current stream, read only when asked (`device_records`, `summary`), so a
stage never waits for the device. `device_trace` wraps torch.profiler,
`timed_call` times a call to the end of its device work, and
`percentile_stats` summarizes samples as the JAX package does.
"""

from __future__ import annotations

import contextlib
import logging
import os
import statistics
import time
from collections import defaultdict

import torch

logger = logging.getLogger(__name__)

# event pairs a stage keeps unread before it reads those whose work is done
_PENDING_CAP = 64
_RULE = "|----------------------|---------|---------|---------|-------|"


def _table(title: str, records: dict) -> list:
    lines = [_RULE,
             "| {:^20} | {:^7} | {:^7} | {:^7} | {:^5} |".format(
                 title, "p50 ms", "p99 ms", "last ms", "n"),
             _RULE]
    for name, vals in records.items():
        s = sorted(vals)
        p50 = s[len(s) // 2]
        p99 = s[min(len(s) - 1, int(len(s) * 0.99))]
        lines.append("| {:<20} | {:>7.2f} | {:>7.2f} | {:>7.2f} | {:>5d} |"
                     .format(name[:20], p50, p99, vals[-1], len(vals)))
    lines.append(_RULE)
    return lines


class StageTimer:
    """Named wall-clock stages with a printable latency table; on a CUDA
    `device`, each stage's device time too (CUDA events on the device's
    current stream)."""

    def __init__(self, enabled: bool = True, device=None):
        self.enabled = enabled
        self.device = None if device is None else torch.device(device)
        self.records = defaultdict(list)
        self._device_ms = defaultdict(list)
        self._pending = defaultdict(list)  # name -> [(start, end) events]

    @contextlib.contextmanager
    def stage(self, name: str):
        if not self.enabled:
            yield
            return
        events = stream = None
        if self.device is not None and self.device.type == "cuda":
            stream = torch.cuda.current_stream(self.device)
            events = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
            events[0].record(stream)
        tic = time.perf_counter()
        try:
            yield
        finally:
            ms = (time.perf_counter() - tic) * 1000.0
            self.records[name].append(ms)
            if events is not None:
                events[1].record(stream)
                self._pending[name].append(events)
                if len(self._pending[name]) > _PENDING_CAP:
                    self._drain(name, wait=False)
            logger.debug("%s: %.2f ms", name, ms)

    def _drain(self, name: str, wait: bool) -> None:
        """Read the stage's event pairs, oldest first: all of them (waiting
        for the device), or while their work is done (Event.query, which
        never waits)."""
        pairs = self._pending[name]
        while pairs and (wait or pairs[0][1].query()):
            start, end = pairs.pop(0)
            end.synchronize()
            self._device_ms[name].append(start.elapsed_time(end))

    def device_records(self) -> dict:
        """{stage: [device ms, ...]} from the CUDA events (waits for the
        stages' work to finish); empty off CUDA."""
        for name in list(self._pending):
            self._drain(name, wait=True)
        return {k: list(v) for k, v in self._device_ms.items() if v}

    def summary(self) -> str:
        """The JAX package's table of the wall-clock stages (the reference's
        print_summary), followed on CUDA by the same table of device ms."""
        lines = _table("Stage", self.records)
        device = self.device_records()
        if device:
            lines += _table("Stage (device)", device)
        return "\n".join(lines)

    def print_summary(self):
        print(self.summary())


@contextlib.contextmanager
def device_trace(log_dir: str, name: str | None = None):
    """torch.profiler over the block (CPU, and CUDA where there is a card),
    written to `log_dir` as Chrome JSON (`name`, by default
    `{time:.3f}.trace.json`); yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(
        log_dir, name or f"{time.time():.3f}.trace.json"))


def _cuda_devices(obj, found: set) -> set:
    if isinstance(obj, torch.Tensor):
        if obj.device.type == "cuda":
            found.add(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _cuda_devices(v, found)
    elif isinstance(obj, (list, tuple)):
        for v in obj:
            _cuda_devices(v, found)
    return found


def timed_call(fn, *args, **kwargs):
    """fn(*args, **kwargs), then a synchronize of each CUDA device its
    result's tensors lie on; returns (result, milliseconds)."""
    tic = time.perf_counter()
    out = fn(*args, **kwargs)
    for device in _cuda_devices(out, set()):
        torch.cuda.synchronize(device)
    return out, (time.perf_counter() - tic) * 1000.0


def percentile_stats(samples_ms):
    s = sorted(samples_ms)
    n = len(s)
    return {
        "p50": s[n // 2],
        "p90": s[min(n - 1, int(n * 0.90))],
        "p99": s[min(n - 1, int(n * 0.99))],
        "mean": statistics.fmean(s),
        "min": s[0],
        "max": s[-1],
        "n": n,
    }
