"""Batched stamps of the port (`--mesh data=1 --max-batch N`) against the JAX
package's single-chip request batching, at the tiny configs, fp32.

- Three requests with mixed cfg / tg / tg_steps / context_pad and two
  brushes through the port's ParallelStampEngine.stamp_batch, held against
  the JAX package's make_parallel_service(RES, "data=1", tiny=True,
  max_batch=4)._run_batch on the same weights (the JAX tree converted),
  cond/uncond and draws (each request's VAE and initial-latent draws
  recomputed from the JAX base key folded with its counter; the JAX batch
  pads to its 4-bucket, the port's runs at 3): within 1 u8 level
  everywhere and at least 99% of pixels exact, as test_torch_port_stamp.py
  holds one stamp. The JAX batch runs its safe twin (Pallas cannot lower
  the vmap), the port its default legs' plain versions.
- Each batched request against itself alone (the service's batch of one
  at the same counter): within 1 u8 level (the CPU convolutions may sum
  in another order at another batch), and the painted region byte-equal
  to the canvas, as the JAX package's test_single_chip_batched_parity.
- At B = 1 the batched stamp is the stamp: stamp.batched()[0] equals
  stamp() byte for byte, and the service's batch of one equals the model's
  own generate_u8 at the same request counter byte for byte.
- A partial batch runs at its own size (no padding), the DeepCache /
  f32-final-step / --f32-components flags carried into the batch (each
  batched request against itself alone, EulerA's per-step draws and
  PNDM's model calls too), the dispatcher (scatters, flushes a lone
  request after its window, a full batch and the remainder at once,
  gathers what arrives while the device is busy and waits its window
  once the device is free, hands an exception to every waiter), the
  counter under threads, run.py's refusals, and the K1/K5 launch split
  over the batch where the grid's y dimension would overflow.
"""

import threading
import time

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.core.config import PipelineConfig
from diffusiontexturepainting_torch.ops import gn_conv
from diffusiontexturepainting_torch.parallel.mesh import (
    DataMesh,
    make_data_mesh,
    parse_mesh_spec,
)
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter,
)
from diffusiontexturepainting_torch.serving import parallel_model as pm
from diffusiontexturepainting_torch.serving.run import build_server
from diffusiontexturepainting_torch.weights.from_jax import (
    state_dict_from_jax,
)

torch.set_num_threads(2)

RES, STEPS = 64, 2
# (cfg_weight, tg_weight, tg_steps, context_pad, brush) of three requests
MIXED = [(2.0, 1.0, 2, 8, 0), (3.5, 0.5, 1, 30, 1), (1.0, 0.0, 0, 0, 0)]


def canvas_of(rng, rows):
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:rows, :, :3] = rng.integers(0, 256, (rows, RES, 3),
                                        dtype=np.uint8)
    canvas[:rows, :, 3] = 255
    return canvas


def service(max_batch=4, config=None, window_ms=3.0, **kw):
    return pm.make_parallel_service(RES, "data=1", tiny=True,
                                    max_batch=max_batch, config=config,
                                    window_ms=window_ms, device="cpu", **kw)


def payloads(svc, settings=MIXED, seed=5, first=100):
    """One payload a request, two brushes (sessions) among them."""
    rng = np.random.default_rng(seed)
    sessions = [svc.new_session() for _ in range(2)]
    for s in sessions:
        s.set_brush(rng.random((RES, RES, 3)).astype(np.float32))
    out = []
    for i, (cfg, tgw, tgs, pad, brush) in enumerate(settings):
        s = sessions[brush]
        out.append(dict(canvas=canvas_of(rng, 16 + 8 * i), image=s.image,
                        brush=s._brush, cond=s._cond, uncond=s._uncond,
                        counter=first + i, cfg_weight=cfg, tg_weight=tgw,
                        tg_steps=tgs, context_pad=pad))
    return out


def assert_u8_close(got, want, exact_share=0.99):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= exact_share


# --- against the JAX package ---


@pytest.fixture(scope="module")
def jax_side():
    from diffusiontexturepainting_tpu.serving.parallel_model import (
        make_parallel_service,
    )

    return make_parallel_service(RES, "data=1", tiny=True, max_batch=4)


def test_batched_stamp_matches_the_jax_batch(jax_side):
    """Tolerance: 1 u8 level everywhere, 99% of pixels exact."""
    import jax
    import jax.numpy as jnp

    jsvc = jax_side
    weights = {name: state_dict_from_jax(name, jsvc.base.params[name])
               for name in ("unet", "vae_encoder", "vae_decoder",
                            "patch_encoder")}
    port = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                     weights=weights)
    engine = pm.make_parallel_service(RES, "data=1", model=port,
                                      max_batch=4).engine
    rng = np.random.default_rng(5)
    brushes = [rng.random((RES, RES, 3)).astype(np.float32)
               for _ in range(2)]
    tokens = [jsvc.base._encode_brush(jsvc.base.params["patch_encoder"],
                                      b[None]) for b in brushes]
    reqs = []
    for i, (cfg, tgw, tgs, pad, b) in enumerate(MIXED):
        cond, uncond = (np.asarray(t) for t in tokens[b])
        reqs.append(dict(canvas=canvas_of(rng, 16 + 8 * i),
                         brush=brushes[b], cond=cond, uncond=uncond,
                         counter=np.uint32(100 + i),
                         cfg_weight=np.float32(cfg),
                         tg_weight=np.float32(tgw),
                         tg_steps=np.int32(tgs), context_pad=np.int32(pad)))
    want = jsvc._run_batch((RES, STEPS), reqs)

    lat = RES // 8
    enc, init = [], []
    for p in reqs:
        rng_p = jax.random.fold_in(jsvc.base._base_key, p["counter"])
        _, enc_rng, lat_rng, _ = jax.random.split(rng_p, 4)
        enc.append(np.asarray(jax.random.normal(enc_rng, (2, lat, lat, 4),
                                                jnp.float32)))
        init.append(np.asarray(jax.random.normal(lat_rng, (1, lat, lat, 4),
                                                 jnp.float32))[0])
    stack = lambda k: np.stack([p[k] for p in reqs])
    raw, comp = engine.stamp_batch(
        stack("canvas"), stack("brush"), stack("cond")[:, 0],
        stack("uncond")[:, 0], np.stack(enc), np.stack(init),
        stack("cfg_weight"), stack("tg_weight"), stack("tg_steps"),
        stack("context_pad"), STEPS)
    assert raw.shape == comp.shape == (3, RES, RES, 3)
    for i in range(3):
        assert_u8_close(comp[i].numpy(), np.asarray(want[i]))


# --- the port against itself ---


@pytest.fixture(scope="module")
def svc():
    return service()


def test_each_batched_request_matches_itself_alone(svc):
    """Each request of a 3-request batch within 1 u8 level of its batch of
    one at the same counter, its painted rows byte-equal to the canvas."""
    reqs = payloads(svc)
    batched = svc._run_batch((RES, STEPS), reqs)
    assert len(batched) == 3
    for i, p in enumerate(reqs):
        solo = svc._run_batch((RES, STEPS), [p])[0]
        assert_u8_close(batched[i], solo, exact_share=0.9)
        rows = 16 + 8 * i
        np.testing.assert_array_equal(batched[i][:rows],
                                      p["canvas"][:rows, :, :3])


def test_batch_of_one_is_the_stamp(svc):
    """Byte-equal: stamp.batched()[0] and stamp() at B = 1; the service's
    batch of one and the model's generate_u8 at the same counter."""
    base = svc.base
    p = payloads(svc, settings=[MIXED[1]], first=7)[0]
    fn = svc.engine.stamp_fn(STEPS)
    enc, init, _ = base.draws(7, RES, STEPS)
    args = (torch.from_numpy(p["canvas"][None]), p["brush"], p["cond"],
            p["uncond"], enc, init, p["cfg_weight"], p["tg_weight"],
            p["tg_steps"], p["context_pad"])
    raw, comp = fn(*args)
    braw, bcomp = fn.batched(*args)
    assert torch.equal(raw, braw[0]) and torch.equal(comp, bcomp[0])
    got = svc._run_batch((RES, STEPS), [p])[0]
    assert np.array_equal(got, comp.numpy())
    model = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                      weights=base.state_dicts())
    model.set_brush(p["image"])
    model.request_counter = 6
    want = model.generate_u8(p["canvas"], steps=STEPS, cfg_weight=3.5,
                             tg_weight=0.5, tg_steps=1, context_pad=30)
    assert np.array_equal(got, want)


@pytest.mark.parametrize("max_batch,n", [(4, 3), (4, 1), (3, 2), (8, 5)])
def test_a_partial_batch_runs_at_its_size(svc, max_batch, n, monkeypatch):
    """No padding: the batched stamp sees the batch's own requests, each
    at its own counter, and the batch is counted by its size."""
    s = pm.ParallelInpainterService(svc.base, svc.mesh, max_batch=max_batch)
    seen = []

    def stamp_batch(canvases, *args):
        seen.append((len(canvases), len(args[-3])))
        out = torch.zeros((len(canvases), RES, RES, 3), dtype=torch.uint8)
        return out, out

    monkeypatch.setattr(s.engine, "stamp_batch", stamp_batch)
    reqs = payloads(s, settings=(MIXED * 3)[:n])
    assert len(s._run_batch((RES, STEPS), reqs)) == n
    assert seen == [(n, n)] and s.batch_counts() == {n: 1}


def test_max_batch_must_align_with_the_data_axis(svc):
    mesh = DataMesh(spec="data=2", data=2)
    with pytest.raises(ValueError, match="multiple of"):
        pm.ParallelInpainterService(svc.base, mesh, max_batch=3)
    assert pm.ParallelInpainterService(svc.base, mesh).max_batch == 2


@pytest.mark.parametrize("config,steps", [
    (dict(f32_final_step=True, deep_cache_interval=2,
          deep_cache_min_steps=2), 2),
    (dict(deep_cache_interval="FSSF"), 4),
    (dict(scheduler="EulerA"), 3),
    (dict(scheduler="PNDM"), 2),
], ids=["dc2+f32final", "FSSF", "EulerA", "PNDM"])
def test_operating_points_carry_into_the_batch(config, steps):
    """The model's operating point is the batch's: its stamp function (the
    schedule of full, shallow and final calls), EulerA's per-step draws
    batched; each request within 1 u8 level of itself alone."""
    s = service(max_batch=2, config=PipelineConfig(**config),
                dtype_overrides={"vae_decoder": torch.float32})
    assert next(s.base.vae_decoder.parameters()).dtype == torch.float32
    fn = s.engine.stamp_fn(steps)
    assert fn is s.base._stamp_fn(steps)
    if config.get("f32_final_step"):
        assert fn.schedule == ("full", "final")
    if config.get("deep_cache_interval") == "FSSF":
        assert fn.schedule == ("full", "shallow", "shallow", "full")
    reqs = payloads(s, settings=MIXED[:2])
    batched = s._run_batch((RES, steps), reqs)
    for i, p in enumerate(reqs):
        assert_u8_close(batched[i], s._run_batch((RES, steps), [p])[0],
                        exact_share=0.9)


# --- the dispatcher ---


def _gather(dispatcher, items):
    """Submit each (key, payload) from its own thread; the results."""
    out = [None] * len(items)

    def go(i, key, payload):
        try:
            out[i] = dispatcher.submit(key, payload)
        except Exception as e:  # noqa: BLE001 - the test reads it
            out[i] = e

    threads = [threading.Thread(target=go, args=(i, *kp))
               for i, kp in enumerate(items)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return out


def test_dispatcher_batches_by_key_and_scatters():
    """Keys batch apart; each waiter gets its own result, in order."""
    calls = []

    def run_batch(key, payloads):
        calls.append((key, list(payloads)))
        return [p * 10 for p in payloads]

    d = pm._BatchDispatcher(run_batch, batch_size=4, window_ms=200.0)
    outs = _gather(d, [(("a",), 1), (("a",), 2), (("b",), 3)])
    assert outs == [10, 20, 30]
    assert {k for k, _ in calls} == {("a",), ("b",)}
    assert sorted(len(p) for _, p in calls) == [1, 2]


def test_dispatcher_flushes_a_lone_request_after_its_window():
    d = pm._BatchDispatcher(lambda k, ps: [p + 1 for p in ps],
                            batch_size=4, window_ms=50.0)
    tic = time.perf_counter()
    assert d.submit(("k",), 1) == 2
    assert 0.04 <= time.perf_counter() - tic < 5.0


def _blocked_executor():
    """(executor, release): a one-worker executor held busy until
    release() is called."""
    from concurrent.futures import ThreadPoolExecutor

    gate = threading.Event()
    ex = ThreadPoolExecutor(max_workers=1)
    ex.submit(gate.wait)
    return ex, gate.set


def _queued(d, key, n):
    """Wait until `n` requests of `key` are queued on `d`."""
    deadline = time.monotonic() + 30
    while len(d._queues.get(key, ())) < n:
        assert time.monotonic() < deadline
        time.sleep(0.001)


def test_dispatcher_flushes_a_full_batch_and_the_remainder_at_once():
    """A window far longer than the test: four waiters of one key, batch 4,
    run at once. Five queued while the device is busy: four run, and the
    fifth right after, with no window of its own (it has waited)."""
    sizes = []

    def run_batch(key, payloads):
        sizes.append(len(payloads))
        return list(payloads)

    d = pm._BatchDispatcher(run_batch, batch_size=4, window_ms=60_000.0)
    tic = time.perf_counter()
    assert _gather(d, [(("k",), i) for i in range(4)]) == [0, 1, 2, 3]
    assert sizes == [4]
    ex, release = _blocked_executor()
    d = pm._BatchDispatcher(run_batch, batch_size=4, window_ms=60_000.0,
                            executor=ex)
    out = []
    t = threading.Thread(target=lambda: out.extend(
        _gather(d, [(("k",), i) for i in range(5)])))
    t.start()
    _queued(d, ("k",), 5)
    release()
    t.join(timeout=20)
    assert sorted(out) == [0, 1, 2, 3, 4]
    assert sizes == [4, 4, 1] and time.perf_counter() - tic < 20


def test_dispatcher_gathers_what_arrives_while_the_device_is_busy():
    """Window 0: three requests queued behind a busy device run as one
    batch once it is free."""
    sizes = []
    ex, release = _blocked_executor()
    d = pm._BatchDispatcher(lambda k, ps: sizes.append(len(ps)) or list(ps),
                            batch_size=4, window_ms=0.0, executor=ex)
    out = []
    t = threading.Thread(target=lambda: out.extend(
        _gather(d, [(("k",), i) for i in range(3)])))
    t.start()
    _queued(d, ("k",), 3)
    release()
    t.join(timeout=20)
    assert sorted(out) == [0, 1, 2] and sizes == [3]


def _painters(d, names, stamps, think_s=0.0):
    """Each painter in a thread of its own sends `stamps` requests of key
    ("k",) as their owner, the next `think_s` after each reply."""
    def paint(name):
        for i in range(stamps):
            d.submit(("k",), f"{name}{i}", name)
            time.sleep(think_s)

    threads = [threading.Thread(target=paint, args=(n,)) for n in names]
    for t in threads:
        t.start()
        time.sleep(0.05)  # they arrive apart, outside one window
    for t in threads:
        t.join(timeout=60)


def _sizes_of(window_ms, return_ms, owners=True):
    sizes = []

    def run_batch(key, payloads):
        sizes.append(len(payloads))
        time.sleep(0.1)
        return list(payloads)

    d = pm._BatchDispatcher(run_batch, batch_size=4, window_ms=window_ms)
    d.return_ms = return_ms
    if not owners:
        submit = d.submit
        d.submit = lambda key, payload, owner: submit(key, payload)
    _painters(d, "ab", 4, think_s=0.02)
    return sizes, d


def test_dispatcher_batches_painters_that_drift_apart():
    """Two painters arriving apart, each sending its next request 20 ms
    after its reply, with a 1 ms window: a batch taken when the device is
    free waits up to return_ms for the painter of the last batch, so after
    the first stamp they share every batch. Without owners (the window
    alone) they take turns."""
    sizes, _ = _sizes_of(1.0, 2_000.0)
    assert sizes[0] == 1 and sizes[1:] == [2, 2, 2, 1], sizes
    alone, _ = _sizes_of(1.0, 2_000.0, owners=False)
    assert alone == [1] * 8


def test_dispatcher_does_not_hold_a_lone_painter():
    """A lone painter's own request is queued when its batch is taken:
    it waits the window only, never return_ms."""
    d = pm._BatchDispatcher(lambda k, ps: list(ps), batch_size=4,
                            window_ms=1.0)
    d.return_ms = 60_000.0
    tic = time.perf_counter()
    for i in range(5):
        assert d.submit(("k",), i, "a") == i
    assert time.perf_counter() - tic < 5.0
    assert d.waited["batches"] == 5


def test_dispatcher_hands_an_exception_to_every_waiter():
    def run_batch(key, payloads):
        raise RuntimeError("device lost")

    d = pm._BatchDispatcher(run_batch, batch_size=3, window_ms=100.0)
    outs = _gather(d, [(("k",), i) for i in range(3)])
    assert all(isinstance(o, RuntimeError) and "device lost" in str(o)
               for o in outs)


def test_service_counter_is_thread_safe():
    svc = object.__new__(pm.ParallelInpainterService)
    svc._counter = 0
    svc._lock = threading.Lock()
    counters = []
    lock = threading.Lock()

    def worker():
        got = [svc.next_counter() for _ in range(200)]
        with lock:
            counters.extend(got)

    threads = [threading.Thread(target=worker) for _ in range(8)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert sorted(counters) == list(range(1, 8 * 200 + 1))


# --- the mesh and run.py ---


def test_mesh_spec():
    assert parse_mesh_spec("data=1", 1) == {"data": 1}
    assert parse_mesh_spec("model=3", 2) == {"model": 3}
    for bad in ("data", "data=x", "data=0", "=2"):
        with pytest.raises(ValueError):
            parse_mesh_spec(bad, 1)
    assert make_data_mesh("data=1", "cpu") == DataMesh("data=1", 1,
                                                      ("cpu",))


@pytest.mark.parametrize("argv,match", [
    (["--mock", "--mesh", "data=1"], "--mock cannot combine with --mesh"),
    (["--max-batch", "4"], "--max-batch requires --mesh"),
    (["--mesh", "model=3"], "mesh model=3 but only 1 devices"),
    (["--mesh", "data=2"], "only 1 devices"),
    (["--mesh", "data=1,pipe=2"], "unsupported mesh axes for serving"),
    (["--mesh", "data=1,model=3"], "--mesh model=N cannot combine with"),
    (["--mesh", "data=1", "--profile-dir", "x"], "--profile-dir"),
])
def test_run_refuses(argv, match):
    with pytest.raises(ValueError, match=match):
        build_server(argv + ["--device", "cpu", "--tiny", "--no-warmup",
                             "--port", "0"])


def test_run_serves_the_mesh():
    server = build_server(["--mesh", "data=1", "--max-batch", "4",
                           "--batch-window-ms", "7", "--device", "cpu",
                           "--tiny", "--resolution", str(RES),
                           "--no-warmup", "--host", "127.0.0.1", "--port",
                           "0"])
    try:
        s = server.service
        assert s.max_batch == 4 and s.mesh == DataMesh("data=1", 1,
                                                       ("cpu",))
        assert s.dispatcher.window_ms == 7.0 and s.base is server.model
        assert "mesh[data=1]" in server.model_info
    finally:
        server.socket.close()


# --- the grid limit ---


def test_batch_runs():
    per_image = lambda n: n * 8192  # 1024^2 / 128-pixel tiles
    assert _cuda.batch_runs(7, per_image) == [(0, 7)]
    assert _cuda.batch_runs(8, per_image) == [(0, 4), (4, 8)]
    runs = _cuda.batch_runs(32, per_image)
    assert runs[0][0] == 0 and runs[-1][1] == 32
    assert all(b - a in (6, 7) for a, b in runs) and len(runs) == 5
    with pytest.raises(ValueError):
        _cuda.batch_runs(2, lambda n: n * 70000)


class _Fake:
    """What the wrapper reads of a CUDA tensor, on a machine without one."""

    def __init__(self, shape, dtype, ptr=1 << 20):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.device = torch.device("cuda", 0)
        self.ptr = ptr
        st, acc = [], 1
        for n in reversed(self.shape):
            st.append(acc)
            acc *= n
        self._stride = tuple(reversed(st))

    def stride(self, dim=None):
        return self._stride if dim is None else self._stride[dim]

    def element_size(self):
        return {torch.bfloat16: 2, torch.float32: 4}[self.dtype]

    def is_contiguous(self):
        return True

    def data_ptr(self):
        return self.ptr

    def dim(self):
        return len(self.shape)

    def __getitem__(self, index):
        return self

    def view(self, *shape):
        return _Fake(shape, self.dtype, self.ptr)


def test_k5_splits_its_batch_where_the_grid_overflows(monkeypatch):
    """The encoder's full-resolution K5 call of a batch of 4 at 1024^2
    (batch 8: 65536 tiles of 128 pixels, one past the grid's y limit) runs
    as two launches of 4 images, each pointer at its run's first image and
    each run's own statistics, counted as two launches, one of them a
    split; a batch of 7 runs as one launch, as before."""
    calls = []

    def function(source, symbol, argtypes):
        def call(*args):
            assert len(args) == len(argtypes)
            calls.append((symbol, args))
            return 0
        return call

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty", lambda shape, dtype=None, **_: _Fake(
        (shape,) if isinstance(shape, int) else shape, dtype))
    monkeypatch.setattr(torch, "cat", lambda ts, dim=0: _Fake(
        (sum(t.shape[0] for t in ts),) + tuple(ts[0].shape[1:]),
        ts[0].dtype))
    C, H = 128, 1024
    counter = gn_conv.gn_conv_stream_launches
    for B, runs in ((8, 2), (7, 1)):
        x = _Fake((B, H, H, C), torch.bfloat16, ptr=1 << 40)
        r = _Fake((B, H, H, C), torch.bfloat16, ptr=1 << 41)
        w = _Fake((3, 3, C, C), torch.bfloat16)
        b = _Fake((C,), torch.bfloat16)
        a = _Fake((B, C), torch.float32, ptr=1 << 42)
        c = _Fake((B, C), torch.float32, ptr=1 << 43)
        calls.clear()
        before = (counter.launches, counter.split)
        out, stats = gn_conv.gn_conv_stream(x, a, c, w, b, r, True)
        assert out.shape == (B, H, H, C) and stats.shape == (B, 2, C)
        assert [s for s, _ in calls] == ["dtp_gn_conv3x3_sm90"] * runs
        assert (counter.launches, counter.split) == (before[0] + runs,
                                                     before[1] + runs - 1)
        per = B // runs
        for k, (_, args) in enumerate(calls):
            assert args[8] == per  # the run's images
            assert args[0] == (1 << 40) + k * per * H * H * C * 2  # x
            assert args[1] == (1 << 42) + k * per * C * 4  # a
            assert args[5] == (1 << 41) + k * per * H * H * C * 2  # residual
