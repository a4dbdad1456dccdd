"""Engine: a program per operating point, captured once as a CUDA graph.

Port of diffusiontexturepainting_tpu/core/engine.py. The JAX engine traces
and compiles one stamp program per (resolution, steps, DeepCache spec) and
dispatches the compiled program; here a program is run once, captured as a
CUDA graph (torch.cuda.CUDAGraph) and replayed, so a stamp's thousands of
kernel launches leave the host as one. The key of a stamp program is
(scheduler, resolution, steps, DeepCache spec, f32 final step, B): the JAX
key, the static knobs the port's model keys on, and the batch size. The
brush encode is a program a resolution, as the JAX model jits it.

A program owns static input buffers, allocated outside the capture, and
the output tensors its capture made. A call, under the engine's one lock:
fill the buffers with device-side writes (a tensor is copied into its
buffer, a host setting is written by fill_, never copied from pageable host
memory, which would wait for the stream), replay, then clone the outputs,
so the caller holds them before any other replay. On the CPU there are no
graphs: the same function runs eagerly on the same buffers, which is how
the tests reach the engine.

A capture records the addresses of everything the program reads: the
served weights (reloads copy into them, models/layers.py and vae.py),
the buffers, the constants of ops/constants.py. So a program is captured
after the weights are on the device, and kept across reload_params, as the
JAX engine keeps its programs. Nothing falls back: a capture or a replay
that fails raises.

Not carried over from the JAX engine: the scoped-VMEM recompile fallback
(a TPU limit; the port allows no fallback), the XLA persistent cache (the
kernels' _build/<digest>/ libraries play that part), the K-chained stroke
buckets (a STAMP_AT is one replay) and the async warm-up on dummy
parameters (a capture records the served weights' addresses).
"""

from __future__ import annotations

import contextlib
import threading
import time
from collections import namedtuple

import torch

from .._cuda import LaunchCounter
from ..pipeline.inpaint import SETTING_DTYPES, fill_values, per_request

# held while a program is captured: one capture at a time in the process
_CAPTURE_LOCK = threading.Lock()

# A program input given as host numbers: a (len(values),) buffer of
# `dtype`, written by fill_ (pipeline/inpaint.py fill_values).
HostValues = namedtuple("HostValues", "values dtype")


def _buffer(arg, device):
    if arg is None:
        return None
    if isinstance(arg, HostValues):
        return torch.empty(len(arg.values), dtype=arg.dtype, device=device)
    return torch.empty(arg.shape, dtype=arg.dtype, device=device)


def _fill(buf, arg, i: int) -> None:
    if (buf is None) != (arg is None):
        raise ValueError(f"program input {i}: None where the program "
                         "was built with a tensor, or the converse")
    if arg is None:
        return
    if isinstance(arg, HostValues):
        if len(arg.values) != buf.shape[0]:
            raise ValueError(f"program input {i}: {len(arg.values)} values "
                             f"for a buffer of {buf.shape[0]}")
        fill_values(buf, arg.values)
        return
    if arg.shape != buf.shape or arg.dtype != buf.dtype:
        raise ValueError(f"program input {i}: {tuple(arg.shape)} "
                         f"{arg.dtype}, the program's buffer "
                         f"{tuple(buf.shape)} {buf.dtype}")
    buf.copy_(arg)


class Program:
    """fn(*buffers) -> tuple of tensors, over static buffers; captured at
    its first call on CUDA, run eagerly on the CPU."""

    def __init__(self, engine: "Engine", key: tuple, fn,
                 graphed: bool = True):
        self.engine = engine
        self.key = key
        self.fn = fn
        self.graphed = graphed
        self.inputs = None
        self.outputs = None
        self.graph = None
        self.deltas = []  # (counter, its counts in one replay)
        self.replays = 0

    def __call__(self, *args):
        """The outputs of fn on `args` (tensors, HostValues or None, the
        same shapes and dtypes at every call), each a tensor of its own."""
        e = self.engine
        with e.lock, torch.inference_mode(), e.on_device():
            if self.inputs is None:
                self.inputs = [_buffer(a, e.device) for a in args]
            if len(args) != len(self.inputs):
                raise ValueError(f"{len(args)} inputs for a program of "
                                 f"{len(self.inputs)}")
            for i, (buf, arg) in enumerate(zip(self.inputs, args)):
                _fill(buf, arg, i)
            if e.device.type != "cuda" or not self.graphed:
                return tuple(self.fn(*self.inputs))
            if self.graph is None:
                self._capture()
            self.graph.replay()
            for counter, delta in self.deltas:
                counter.add(delta)
            self.replays += 1
            return tuple(o.clone() for o in self.outputs)

    def _capture(self) -> None:
        """One eager pass on a side stream (PyTorch's warm-up before a
        capture: lazy initializations, the kernels' builds, the device
        constants), then the capture into the engine's pool. Neither pass
        counts as served launches: this thread's launches are diverted
        (LaunchCounter.diverted), and what the capture counted is added at
        every replay; another thread's launches meanwhile count as
        usual."""
        e = self.engine
        tic = time.perf_counter()
        stream = torch.cuda.current_stream(e.device)
        side = torch.cuda.Stream(e.device)
        side.wait_stream(stream)
        with LaunchCounter.diverted():
            with torch.cuda.stream(side):
                self.fn(*self.inputs)
        stream.wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        # one capture at a time in the process (PyTorch's rule), each on a
        # stream of the engine's own card (torch.cuda.graph's default
        # stream is made once, on whichever card was current then);
        # thread_local: the server's other threads (a worker a card, the
        # connections' threads) may allocate or synchronize meanwhile;
        # kernels launch on the current stream (_cuda.stream_of), the
        # capture's inside this block
        with _CAPTURE_LOCK, LaunchCounter.diverted() as counted, \
                torch.cuda.graph(graph, pool=e.pool,
                                 stream=e.capture_stream,
                                 capture_error_mode="thread_local"):
            outputs = tuple(self.fn(*self.inputs))
        self.deltas = [(c, tuple(d)) for c, d in counted.items() if d[0]]
        self.graph, self.outputs = graph, outputs
        e.captures[self.key] = {"seconds": time.perf_counter() - tic,
                                "pool_bytes": e.pool_bytes()}


class Engine:
    """The programs of one model on `device`, keyed by operating point.

    One lock covers every program's fill, replay and clone: the batching
    service runs batches on one worker, but a connection's brush encode may
    run on its own thread. On CUDA the programs share one memory pool
    (torch.cuda.graph_pool_handle()), so the device holds the largest
    program's intermediates, not the sum of all. That is safe here because
    a program's inputs live outside the pool, its outputs are cloned before
    any other replay, every program runs on the one current stream, and
    replays are serialized by the lock: a replay may overwrite what another
    program left in the pool, never what a caller still reads."""

    def __init__(self, device):
        self.device = torch.device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", torch.cuda.current_device())
        self.lock = threading.RLock()
        self.programs: dict = {}
        # {program key: {"seconds": the eager pass and the capture,
        # "pool_bytes": the pool's reserved bytes after it}}
        self.captures: dict = {}
        self.pool = self.capture_stream = None
        if self.device.type == "cuda":
            self.pool = torch.cuda.graph_pool_handle()
            self.capture_stream = torch.cuda.Stream(self.device)

    def program(self, key: tuple, fn, graphed: bool = True) -> Program:
        """The program of `key` (built around fn at its first request).
        ops.conv3x3._IN_PAD, a module switch a capture bakes in (the
        in-kernel-padding kernels take K7's and K4's calls), is part of
        the key. graphed=False: a program that runs eagerly on its
        buffers on CUDA too (a stamp whose UNet calls replay programs of
        other cards, parallel/cfg_shard.py)."""
        from ..ops import conv3x3

        key = tuple(key) + (("_IN_PAD",) if conv3x3._IN_PAD else ())
        with self.lock:
            prog = self.programs.get(key)
            if prog is None:
                prog = self.programs[key] = Program(self, key, fn, graphed)
            return prog

    def on_device(self):
        """The engine's card as the thread's current device (a capture, a
        replay and a kernel's attributes follow the current device), or
        nothing on the CPU."""
        if self.device.type != "cuda":
            return contextlib.nullcontext()
        return torch.cuda.device(self.device)

    def pool_bytes(self) -> int:
        """The bytes the programs' pool reserves on the device."""
        pool = tuple(self.pool)
        return sum(seg["total_size"] for seg in torch.cuda.memory_snapshot()
                   if tuple(seg.get("segment_pool_id", ())) == pool)


class Stamp:
    """make_stamp_fn's function `fn` served by replaying a program of
    `engine` per (resolution, B); `key` (scheduler, steps, DeepCache spec,
    f32 final step) is fn's. The call signatures of make_stamp_fn's stamp
    (stamp(...), B = 1, and .batched(...)), its `schedule` and
    `scheduler`; `eager` is the function itself, which runs without the
    engine. graphed=False: the programs run eagerly on their buffers (the
    CFG-sharded stamp, whose UNet calls are programs of their own cards).
    """

    def __init__(self, engine: Engine, fn, key: tuple,
                 graphed: bool = True):
        self.engine = engine
        self.eager = fn
        self.key = tuple(key)
        self.graphed = graphed
        self.schedule = fn.schedule
        self.scheduler = fn.scheduler

    def program_key(self, res: int, batch: int) -> tuple:
        """(scheduler, resolution, steps, DeepCache spec, f32 final step,
        B)."""
        scheduler, steps, spec, f32 = self.key
        return (scheduler, int(res), steps, spec, f32, int(batch))

    def batched(self, canvas_u8, brush, cond, uncond, enc_noise,
                init_latents, cfg_weight, tg_weight, tg_steps, context_pad,
                step_noise=None):
        """make_stamp_fn's stamp.batched, through the program of the
        canvas's size and batch."""
        B, res = canvas_u8.shape[0], canvas_u8.shape[1]
        settings = [HostValues(per_request(v, B), dtype) for v, dtype in
                    zip((cfg_weight, tg_weight, tg_steps, context_pad),
                        SETTING_DTYPES)]
        prog = self.engine.program(self.program_key(res, B), self.eager.run,
                                   self.graphed)
        return prog(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
                    *settings, step_noise)

    def __call__(self, canvas_u8, brush, cond, uncond, enc_noise,
                 init_latents, cfg_weight, tg_weight, tg_steps, context_pad,
                 step_noise=None):
        raw, comp = self.batched(canvas_u8, brush, cond, uncond, enc_noise,
                                 init_latents, cfg_weight, tg_weight,
                                 tg_steps, context_pad, step_noise)
        return raw[0], comp[0]
