"""Concurrent painters on one or more devices: the port's `--mesh data=N`.

Port of the JAX package's serving/parallel_model.py, on threads rather
than asyncio (the port's server is websockets.sync: a thread a
connection). Stamps from concurrent websocket connections are
micro-batched; a batch of up to `max_batch` requests is split into
contiguous shares, one a device of the data mesh, which run at once, each
as one batched stamp program of its device's model (parallel/serving.py
ParallelStampEngine; on CUDA the replay of a CUDA graph per batch size,
core/engine.py), each request with its own settings; the replies go out
when every share is done. A lone request still runs alone after
`window_ms`. Unlike the JAX dispatcher, which hands a batch to the device
when its window ends, a batch here is taken when the mesh is free for it,
and waits longer (RETURN_MS) for a painter of the last batch: painters who
each send their next stamp on their reply then share batches instead of
taking turns. Shares are not padded to the JAX package's power-of-two
buckets: a partial batch runs at its own size.

Stroke sessions are pinned round-robin to the mesh's devices
(acquire_session_slot, the JAX service's acquire_session_device), as the
JAX service pins them: a session's canvas and brush live on its device,
and its STAMP_ATs replay that device's programs. A device holds one model replica (params_on), shared by every
session pinned there and by the batches' shares on it; the first device's
is the base model itself, so nothing is held twice. Each distinct device
has its own worker thread, which runs all of that device's work in order:
sessions pinned to different cards run at the same time.

Pieces:
  ParallelInpainterService  the shared state: the base model, a replica
                            and a worker a device, the request counter
  SessionModel              one connection's view: its own brush and its
                            own stroke session (the model surface
                            serving/wire.py answers)
  _BatchDispatcher          the micro-batcher (collect -> run on the
                            mesh -> scatter results)

Draws: the service's locked counter gives each request its number, and a
request draws what TorchConditionalInpainter.draws gives at that number on
its device (the generator's stream does not depend on the card), so its
stamp in a batch is the stamp it would get alone at that counter (up to
the kernels' summation order, which may follow the batch: PERF.md).
"""

from __future__ import annotations

import threading
import time
from collections import Counter
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Dict, Tuple

import numpy as np
import torch

from ..pipeline.session import erase_keep, session_erase
from .model_base import (
    ConditionalInpainterBase,
    crop_resize_square,
    ensure_float01,
    validate_session_canvas,
)


# How long a batch waits, at most, for a painter of its key's last batch to
# send its next stamp: that painter's reply and its next canvas pass through
# both ends' interpreters, more than the 3 ms window on the H100's host
# (PERF.md). A lone painter never waits for it (its own stamp is
# queued); a painter that stops costs one batch this wait.
RETURN_MS = 50.0


class _BatchDispatcher:
    """Micro-batches submissions keyed by operating point.

    Batches run one at a time on `executor` (the device is serial), and a
    key's queue is taken only when the executor comes to its batch: what
    arrives while the device is busy waits and runs together. Taken, a
    batch short of `batch_size` waits up to `window_ms` for peers, and up
    to `return_ms` (RETURN_MS) while an owner of the key's last batch has
    not sent its next request (concurrent painters, each sending its next
    stamp on its reply, so share batches instead of taking turns); a full
    batch goes at once, and what is left over queues its next batch at
    once (no wait: it has waited). Every waiter of a batch that raises
    gets the exception. `waited` holds the batches taken and the ms they
    waited in all."""

    def __init__(self, run_batch, batch_size: int, window_ms: float = 3.0,
                 executor=None):
        self._run_batch = run_batch  # (key, payloads) -> list of results
        self.batch_size = batch_size
        self.window_ms = window_ms
        self.return_ms = max(RETURN_MS, window_ms)
        self._queues: Dict[Tuple, list] = {}
        self._queued = set()  # keys whose next batch is on the executor
        self._owners: Dict[Tuple, set] = {}  # of each key's last batch
        self._cond = threading.Condition()
        self._executor = executor or ThreadPoolExecutor(max_workers=1)
        self.waited = {"batches": 0, "ms": 0.0}

    def submit(self, key: Tuple, payload, owner=None):
        """Queue `payload` of `owner` (a connection, or None) under `key`
        and wait for its result."""
        fut = Future()
        with self._cond:
            self._queues.setdefault(key, []).append((payload, fut, owner))
            if key not in self._queued:
                self._queued.add(key)
                self._executor.submit(self._run, key, True)
            self._cond.notify_all()
        return fut.result()

    def _take(self, key, wait: bool) -> list:
        """The key's next batch, on the executor: at most batch_size
        requests, once full or when its wait ends."""
        start = time.monotonic()
        with self._cond:
            while wait and len(self._queues[key]) < self.batch_size:
                back = {o for _, _, o in self._queues[key]}
                missing = self._owners.get(key, set()) - back
                limit = self.return_ms if missing else self.window_ms
                left = start + limit / 1000.0 - time.monotonic()
                if left <= 0:
                    break
                self._cond.wait(left)
            q = self._queues[key]
            batch, self._queues[key] = q[:self.batch_size], q[self.batch_size:]
            self._owners[key] = {o for _, _, o in batch if o is not None}
            if self._queues[key]:
                self._executor.submit(self._run, key, False)
            else:
                self._queued.discard(key)
            self.waited["batches"] += 1
            self.waited["ms"] += (time.monotonic() - start) * 1e3
        return batch

    def _run(self, key, wait: bool) -> None:
        batch = self._take(key, wait)
        try:
            results = self._run_batch(key, [p for p, _, _ in batch])
        except BaseException as e:  # noqa: BLE001 - every waiter gets it
            for _, fut, _ in batch:
                fut.set_exception(e)
            return
        for (_, fut, _), res in zip(batch, results):
            fut.set_result(res)


class SessionModel:
    """One websocket connection's view of the shared service: its own brush
    (encoded by the base model's patch encoder) and its own stroke session
    (a resident canvas on the device the service pins it to); its stamps
    batch with other connections'. The model surface serving/wire.py
    answers."""

    def __init__(self, service: "ParallelInpainterService"):
        self.service = service
        base = service.base
        self.image = base.image
        self._brush, self._cond, self._uncond = (base._brush, base._cond,
                                                 base._uncond)
        # the session's slot of the mesh and its device, pinned at its
        # first BEGIN_SESSION
        self.slot = self.device = None
        self._on_device = None  # (brush, cond, uncond) there
        self._session_canvas = None
        self._erase_keep = None
        # the request counter of each STAMP_AT since BEGIN_SESSION (its
        # draws), so a session can be replayed stamp by stamp
        self.stamp_counters = []

    def resolution(self) -> int:
        return self.service.base.resolution()

    def set_brush(self, image: np.ndarray) -> None:
        self.image, self._brush, self._cond, self._uncond = \
            self.service.run(self.service.base.encode_brush, image)
        self._on_device = None

    def create_preview_brush_context(self, brush_image):
        return ConditionalInpainterBase.create_preview_brush_context(
            self, brush_image)

    def generate_u8(self, canvas_u8: np.ndarray, **settings) -> np.ndarray:
        """uint8 in, uint8 out, batched with concurrent requests."""
        return self.service.submit(self, canvas_u8, settings)

    def generate(self, canvas: np.ndarray, **settings) -> np.ndarray:
        canvas_u8 = (np.clip(ensure_float01(canvas), 0, 1)
                     * 255).astype(np.uint8)
        return self.generate_u8(canvas_u8, **settings).astype(
            np.float32) / 255.0

    # --- the stroke session: sequential by nature, so not batched; each
    # request runs on the worker of the session's device

    def begin_session(self, canvas_u8: np.ndarray) -> None:
        canvas_u8 = validate_session_canvas(canvas_u8, self.resolution())
        if self.device is None:
            self.slot = self.service.acquire_session_slot()
            self.device = self.service.devices[self.slot]
        self._run(self._begin, np.array(canvas_u8))

    def _run(self, fn, *args):
        return self.service.run_on(self.device, fn, *args)

    @torch.inference_mode()
    def _begin(self, canvas_u8):
        self._session_canvas = torch.from_numpy(canvas_u8).to(self.device)
        self.stamp_counters = []

    def session_active(self) -> bool:
        return self._session_canvas is not None

    def stamp_at(self, x0: int, y0: int, return_pixels: bool = True,
                 overpaint: bool = False, **settings):
        """The stamp_at of the session's device's model on this
        connection's canvas and brush, with the service's next counter."""
        self._require_session()
        return self._run(self._stamp_at, x0, y0, return_pixels, overpaint,
                         settings)

    def _stamp_at(self, x0, y0, return_pixels, overpaint, settings):
        counter = self.service.next_counter()
        self.stamp_counters.append(counter)
        if self._on_device is None:
            self._on_device = tuple(t.to(self.device) for t in (
                self._brush, self._cond, self._uncond))
        return self.service.params_on(self.device).stamp_into(
            self._require_session(), *self._on_device, counter, x0, y0,
            return_pixels, overpaint, settings)

    def erase_at(self, x0: int, y0: int, return_pixels: bool = True):
        self._require_session()
        return self._run(self._erase_at, x0, y0, return_pixels)

    @torch.inference_mode()
    def _erase_at(self, x0, y0, return_pixels):
        canvas = self._require_session()
        if self._erase_keep is None:
            self._erase_keep = erase_keep(self.resolution(), canvas.device)
        crop = session_erase(canvas, self._erase_keep, x0, y0)
        return crop.cpu().numpy() if return_pixels else None

    def fetch_canvas(self) -> np.ndarray:
        """Waits for the connection's queued stamps and downloads its
        canvas (a copy)."""
        self._require_session()
        return self._run(lambda: np.array(self._require_session().cpu()))

    def end_session(self) -> None:
        self._session_canvas = None

    def _require_session(self):
        if self._session_canvas is None:
            raise RuntimeError("no active stroke session (BEGIN_SESSION "
                               "first)")
        return self._session_canvas


class ParallelInpainterService:
    """The shared serving state over the devices of a data mesh. `base` is
    a TorchConditionalInpainter on the mesh's first device (weights, patch
    encoder, configuration, draws); stamps run through a
    ParallelStampEngine a device, in batches of at most `max_batch`
    (default: the data axis), split into contiguous shares, one a device,
    a partial batch at its own size (the JAX package pads it to a power of
    2 so that jit traces few shapes; the port's kernels take any batch).
    Each distinct device has one worker thread, which runs all of its
    device's work (shares and session requests): the launch counters are
    exact under several workers (_cuda.LaunchCounter), and each device has
    its own replica, engine and workspaces. With one device the batches
    run on its worker, as the JAX dispatcher's one executor worker."""

    def __init__(self, base, mesh, window_ms: float = 3.0,
                 max_batch: int | None = None):
        from ..parallel.serving import ParallelStampEngine

        self.base = base
        self.mesh = mesh
        self.devices = [torch.device(d) for d in
                        (mesh.devices or [base.device] * mesh.data)]
        if self.devices[0] != base.device:
            raise ValueError(f"the base model is on {base.device}, the "
                             f"mesh's first device is {self.devices[0]}")
        max_batch = max_batch or mesh.data
        if max_batch % mesh.data:
            raise ValueError(f"max_batch {max_batch} must be a multiple of "
                             f"the mesh data axis {mesh.data}")
        self.max_batch = max_batch
        self._lock = threading.Lock()
        self._replicas = {base.device: base}
        self.engines = {base.device: ParallelStampEngine(base)}
        self.engine = self.engines[base.device]
        self.workers = {}
        for dev in self.devices:
            if dev not in self.workers:
                self.workers[dev] = ThreadPoolExecutor(
                    max_workers=1, thread_name_prefix=f"device-{dev}")
        self.worker = self.workers[base.device]
        batches = (self.worker if len(self.devices) == 1 else
                   ThreadPoolExecutor(max_workers=1,
                                      thread_name_prefix="batches"))
        self.dispatcher = _BatchDispatcher(self._run_batch, max_batch,
                                           window_ms, batches)
        self._counter = 0
        self._session_rr = 0
        # batches run, by their number of requests
        self.batch_sizes = Counter()

    def new_session(self) -> SessionModel:
        return SessionModel(self)

    def batch_counts(self) -> dict:
        """{requests in a batch: batches run} so far."""
        return dict(sorted(self.batch_sizes.copy().items()))

    def batch_waits(self) -> dict:
        """{"batches": taken so far, "ms": how long they waited for peers
        in all}."""
        with self.dispatcher._cond:
            return dict(self.dispatcher.waited)

    def next_counter(self) -> int:
        with self._lock:
            self._counter += 1
            return self._counter

    def acquire_session_slot(self) -> int:
        """The slot of the mesh (an index of `devices`, which may repeat a
        device) for a new stroke session, round-robin."""
        with self._lock:
            slot = self._session_rr % len(self.devices)
            self._session_rr += 1
        return slot


    def params_on(self, device):
        """The model replica on `device`: one a device, shared by every
        session pinned there and every share run there (the base model on
        its own device), built at its first use under the lock, so two
        painters landing on one card never build two. It serves the base
        model's configuration (its operating point)."""
        device = torch.device(device)
        with self._lock:
            model = self._replicas.get(device)
            if model is None:
                from ..parallel.serving import ParallelStampEngine

                model = self._replicas[device] = self.base.replica_on(device)
                self.engines[device] = ParallelStampEngine(model)
            model.config = self.base.config
            return model

    def run(self, fn, *args):
        """fn(*args) on the base device's worker; its result, or its
        exception raised here."""
        return self.run_on(self.base.device, fn, *args)

    def run_on(self, device, fn, *args):
        """fn(*args) on the worker of `device`."""
        return self.workers[torch.device(device)].submit(fn, *args).result()

    def submit(self, session: SessionModel, canvas_u8, settings):
        """One NEW_STAMP of `session`, batched: the composited (H, W, 3)
        uint8."""
        canvas_u8 = np.asarray(canvas_u8)
        if canvas_u8.dtype != np.uint8:
            canvas_u8 = (np.clip(canvas_u8, 0, 1) * 255).astype(np.uint8)
        res = int(canvas_u8.shape[0])
        steps, cfg_w, tg_w, tg_steps, pad = self.base._settings(settings)
        payload = dict(canvas=canvas_u8, image=session.image,
                       brush=session._brush, cond=session._cond,
                       uncond=session._uncond, counter=self.next_counter(),
                       cfg_weight=cfg_w, tg_weight=tg_w, tg_steps=tg_steps,
                       context_pad=pad)
        return self.dispatcher.submit((res, steps), payload, session)

    def shares(self, n: int) -> list:
        """[(device, lo, hi)]: a batch of n requests in contiguous shares
        of at most ceil(n / devices), one a device in mesh order."""
        per = -(-n // len(self.devices))
        return [(dev, lo, min(n, lo + per)) for dev, lo in
                zip(self.devices, range(0, n, per))]

    def _run_batch(self, key, payloads):
        """One batch over the mesh: each share on its device's worker, all
        at once; returns the composited stamps in order."""
        self.batch_sizes[len(payloads)] += 1
        shares = self.shares(len(payloads))
        if len(self.devices) == 1:  # on the device's own worker already
            return self._run_share(self.devices[0], key, payloads)
        futures = [self.workers[dev].submit(self._run_share, dev, key,
                                            payloads[lo:hi])
                   for dev, lo, hi in shares]
        return [out for f in futures for out in f.result()]

    def _brush_at(self, payload, res: int, device):
        """A request's brush as a (1, res, res, 3) tensor on `device`."""
        if res == payload["brush"].shape[1]:
            return payload["brush"].to(device)
        img = crop_resize_square(payload["image"], res).astype(np.float32)
        return torch.from_numpy(img[None]).to(device)

    def _run_share(self, device, key, payloads):
        """A share on `device`'s model, each request's draws at its
        counter; returns the composited stamps."""
        res, steps = key
        model = self.params_on(device)
        d = [model.draws(p["counter"], res, steps) for p in payloads]
        stack = lambda f: torch.cat([f(p).to(device) for p in payloads])
        step_noise = None
        if d[0][2] is not None:
            step_noise = torch.stack([s[:, 0] for _, _, s in d])
        _, comp = self.engines[device].stamp_batch(
            np.stack([p["canvas"] for p in payloads]),
            stack(lambda p: self._brush_at(p, res, device)),
            stack(lambda p: p["cond"]),
            stack(lambda p: p["uncond"]),
            torch.stack([e for e, _, _ in d]),
            torch.cat([i for _, i, _ in d]),
            [p["cfg_weight"] for p in payloads],
            [p["tg_weight"] for p in payloads],
            [p["tg_steps"] for p in payloads],
            [p["context_pad"] for p in payloads],
            steps, step_noise)
        return list(comp.cpu().numpy())


def make_parallel_service(resolution: int, mesh_spec: str,
                          checkpoint_dir: str | None = None,
                          window_ms: float = 3.0, tiny: bool = False,
                          max_batch: int | None = None, config=None,
                          dtype_overrides=None, device="cuda", model=None,
                          devices=None):
    """The service of a CLI mesh spec ('data=N'), as the JAX package builds
    it: the mesh's checks (parallel/mesh.py make_data_mesh, over `devices`
    where given, else every device of `device`'s kind), the base model (or
    `model`, already built) on the mesh's first device, max_batch a
    multiple of the data axis. `config` and `dtype_overrides` carry the
    operating point (--scheduler, --deep-cache-interval, --f32-final-step,
    --f32-components) into the batched stamps."""
    from ..parallel.mesh import make_data_mesh

    mesh = make_data_mesh(mesh_spec, device if model is None
                          else model.device, devices)
    if model is None:
        from ..pipeline.torch_model import TorchConditionalInpainter

        model = TorchConditionalInpainter(
            resolution, config=config, device=mesh.devices[0], tiny=tiny,
            checkpoint_dir=checkpoint_dir, dtype_overrides=dtype_overrides)
    return ParallelInpainterService(model, mesh, window_ms=window_ms,
                                    max_batch=max_batch)
