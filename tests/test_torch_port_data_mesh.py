"""`--mesh data=N` in the port (serving/parallel_model.py over a data mesh,
parallel/mesh.py) on the CPU at the tiny configs, fp32, with an explicit
device list ("cpu", "cpu").

- A `data=2` batch of 4 requests runs as two shares of 2, each byte-equal
  to the `data=1` service's batch of the same two requests at the same
  counters.
- The same batch against the JAX package's make_parallel_service(RES,
  "data=2") batch on a two-device host mesh, the same weights, brush
  tokens and the JAX program's own draws: within 1 u8 level everywhere and
  at least 99% of pixels exact, as tests/test_torch_port_batched.py holds
  the data=1 batch.
- Three sessions pinned round-robin to slots 0, 1, 0; one model replica a
  distinct device (the sessions' UNet weights at one address); a stroke
  on each; build_server with an explicit two-device list; the refusals.
- What several workers share stays exact: the launch counters under
  threads (and a thread's diverted launches, as a capture diverts them)
  and the ieee_fp32 settings when threads overlap in it.
"""

import threading

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.parallel.mesh import (
    DataMesh,
    make_data_mesh,
    make_serving_mesh,
    parse_mesh_spec,
)
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
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
CPU2 = ("cpu", "cpu")
# (cfg_weight, tg_weight, tg_steps, context_pad, brush) of four requests
MIXED = [(2.0, 1.0, 2, 8, 0), (3.5, 0.5, 1, 30, 1), (1.0, 0.0, 0, 0, 0),
         (2.5, 1.5, 2, 16, 1)]


def canvas_of(rng, rows):
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:rows, :, :3] = rng.integers(0, 256, (rows, RES, 3),
                                        dtype=np.uint8)
    canvas[:rows, :, 3] = 255
    return canvas


def service(spec, devices=None, model=None, max_batch=4):
    return pm.make_parallel_service(RES, spec, tiny=True, max_batch=max_batch,
                                    device="cpu", devices=devices,
                                    model=model)


def payloads(svc, seed=5, first=100):
    rng = np.random.default_rng(seed)
    sessions = [svc.new_session() for _ in range(2)]
    for s in sessions:
        s.set_brush(rng.random((RES, RES, 3)).astype(np.float32))
    return [dict(canvas=canvas_of(rng, 16 + 8 * i), image=s.image,
                 brush=s._brush, cond=s._cond, uncond=s._uncond,
                 counter=first + i, cfg_weight=cfg, tg_weight=tgw,
                 tg_steps=tgs, context_pad=pad)
            for i, (cfg, tgw, tgs, pad, b) in enumerate(MIXED)
            for s in [sessions[b]]]


@pytest.fixture(scope="module")
def base():
    return TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                     verbose_timing=False)


def test_shares_are_byte_equal_to_the_one_device_batch(base):
    two = service("data=2", CPU2, model=base)
    one = service("data=1", model=base)
    assert two.mesh == DataMesh("data=2", 2, CPU2)
    assert two.shares(4) == [(torch.device("cpu"), 0, 2),
                             (torch.device("cpu"), 2, 4)]
    reqs = payloads(two)
    got = two._run_batch((RES, STEPS), reqs)
    want = (one._run_batch((RES, STEPS), reqs[:2])
            + one._run_batch((RES, STEPS), reqs[2:]))
    assert len(got) == 4
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    assert two.batch_counts() == {4: 1}


@pytest.mark.parametrize("n,want", [
    (1, [(0, 1)]), (2, [(0, 1), (1, 2)]), (3, [(0, 2), (2, 3)]),
    (5, [(0, 3), (3, 5)])])
def test_a_batch_splits_into_contiguous_shares(base, n, want):
    two = service("data=2", CPU2, model=base, max_batch=6)
    assert [(lo, hi) for _, lo, hi in two.shares(n)] == want


def test_data_batch_matches_the_jax_data_mesh():
    """Tolerance: 1 u8 level everywhere, 99% of pixels exact."""
    from diffusiontexturepainting_tpu.serving.parallel_model import (
        make_parallel_service,
    )

    assert len(jax.devices()) >= 2
    jsvc = make_parallel_service(RES, "data=2", tiny=True, max_batch=4)
    assert jsvc.mesh.devices.size == 2
    weights = {name: state_dict_from_jax(name, jsvc.base.params[name])
               for name in ("unet", "vae_encoder", "vae_decoder",
                            "patch_encoder")}
    port = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                     weights=weights, verbose_timing=False)
    lat = RES // 8

    def draws(counter, res, steps=None):
        rng = jax.random.fold_in(jsvc.base._base_key, np.uint32(counter))
        _, enc_rng, lat_rng, _ = jax.random.split(rng, 4)
        enc = jax.random.normal(enc_rng, (2, lat, lat, 4), jnp.float32)
        init = jax.random.normal(lat_rng, (1, lat, lat, 4), jnp.float32)
        return (torch.from_numpy(np.array(enc)),
                torch.from_numpy(np.array(init)), None)

    port.draws = draws
    svc = service("data=2", CPU2, model=port)
    rng = np.random.default_rng(5)
    brushes = [rng.random((RES, RES, 3)).astype(np.float32)
               for _ in range(2)]
    tokens = [jsvc.base._encode_brush(jsvc.base.params["patch_encoder"],
                                      b[None]) for b in brushes]
    jreqs, reqs = [], []
    for i, (cfg, tgw, tgs, pad, b) in enumerate(MIXED):
        cond, uncond = (np.array(t) for t in tokens[b])
        canvas = canvas_of(rng, 16 + 8 * i)
        jreqs.append(dict(canvas=canvas, brush=brushes[b], cond=cond,
                          uncond=uncond, counter=np.uint32(100 + i),
                          cfg_weight=np.float32(cfg),
                          tg_weight=np.float32(tgw),
                          tg_steps=np.int32(tgs),
                          context_pad=np.int32(pad)))
        reqs.append(dict(canvas=canvas, image=brushes[b],
                         brush=torch.from_numpy(brushes[b][None]),
                         cond=torch.from_numpy(cond),
                         uncond=torch.from_numpy(uncond), counter=100 + i,
                         cfg_weight=cfg, tg_weight=tgw, tg_steps=tgs,
                         context_pad=pad))
    want = jsvc._run_batch((RES, STEPS), jreqs)
    got = svc._run_batch((RES, STEPS), reqs)
    for g, w in zip(got, want):
        w = np.asarray(w)
        assert g.shape == w.shape and g.dtype == w.dtype == np.uint8
        diff = np.abs(g.astype(int) - w.astype(int))
        assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


def test_sessions_pin_round_robin_to_one_replica_a_device(base):
    svc = service("data=2", CPU2, model=base)
    sessions = [svc.new_session() for _ in range(3)]
    for s in sessions:
        s.begin_session(np.zeros((RES, 2 * RES, 4), np.uint8))
    assert [s.slot for s in sessions] == [0, 1, 0]
    models = {id(svc.params_on(s.device)) for s in sessions}
    assert models == {id(base)} and len(svc._replicas) == 1
    ptrs = {next(svc.params_on(s.device).unet.parameters()).data_ptr()
            for s in sessions}
    assert len(ptrs) == 1
    sessions[1].stamp_at(0, 0, return_pixels=False, steps=STEPS)
    sessions[2].stamp_at(RES, 0, return_pixels=False, steps=STEPS)
    assert sessions[1].fetch_canvas()[..., 3].sum() > 0
    assert sessions[0].fetch_canvas()[..., 3].sum() == 0
    assert len(sessions[1].stamp_counters) == 1


def test_run_serves_a_data_mesh_on_an_explicit_device_list():
    server = build_server(["--mesh", "data=2", "--device", "cpu", "--tiny",
                           "--resolution", str(RES), "--no-warmup",
                           "--session-canvas", f"{2 * RES}x{RES}",
                           "--host", "127.0.0.1", "--port", "0"],
                          devices=list(CPU2))
    try:
        s = server.service
        assert s.mesh == DataMesh("data=2", 2, CPU2)
        assert s.max_batch == 2 and s.base is server.model
        assert "mesh[data=2]" in server.model_info
        # one warm session a device, the counter put back
        assert s._session_rr == 2 and s._counter == 0
        assert "session" in server.startup
    finally:
        server.socket.close()


@pytest.mark.parametrize("spec,devices,match", [
    ("data=3", CPU2, "mesh data=3 but only 2 devices"),
    ("data=2", None, "mesh data=2 but only 1 devices"),
    ("data=1,pipe=2", CPU2, "unsupported mesh axes for serving"),
])
def test_data_mesh_refusals(spec, devices, match):
    with pytest.raises(ValueError, match=match):
        make_serving_mesh(spec, "cpu", devices)


def test_a_data_mesh_takes_the_first_devices():
    assert make_data_mesh("data=2", "cpu", ["cpu"] * 3).devices == CPU2
    assert make_data_mesh("data=1", "cpu").devices == ("cpu",)
    assert parse_mesh_spec("pipe=2", 4) == {"pipe": 2, "data": 4}
    assert parse_mesh_spec("model=3", 4) == {"model": 3}


# --- what the workers share ---


def test_launch_counts_stay_exact_under_threads():
    counter = _cuda.LaunchCounter("test_threads")
    try:
        def launch():
            for _ in range(2000):
                counter.record(("k",), torch.bfloat16)

        threads = [threading.Thread(target=launch) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert counter.launches == 16000
        assert counter.shapes == {("k",): 16000}
        assert counter.dtypes == {"bfloat16": 16000}
    finally:
        _cuda.LaunchCounter.all.remove(counter)


def test_a_diverted_thread_counts_apart():
    """A thread inside diverted() (a capture) counts into its record;
    another thread's launches meanwhile count on the counter."""
    counter = _cuda.LaunchCounter("test_diverted")
    try:
        inside, go = threading.Event(), threading.Event()

        def other():
            inside.wait()
            counter.record(("other",))
            go.set()

        t = threading.Thread(target=other)
        t.start()
        with _cuda.LaunchCounter.diverted() as got:
            counter.record(("mine",), split=True)
            inside.set()
            go.wait()
        t.join()
        assert got[counter][:2] == [1, 1] and got[counter][2] == {
            ("mine",): 1}
        assert counter.launches == 1 and counter.shapes == {("other",): 1}
        counter.add(tuple(got[counter]))
        assert counter.launches == 2 and counter.split == 1
    finally:
        _cuda.LaunchCounter.all.remove(counter)


def test_ieee_fp32_holds_while_threads_overlap():
    """The first thread in sets the settings, the last one out puts them
    back, whatever the order they leave in."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        a_in, b_in, a_out = (threading.Event() for _ in range(3))
        seen = []

        def a():
            with t_inpaint.ieee_fp32():
                a_in.set()
                b_in.wait()
            a_out.set()

        def b():
            a_in.wait()
            with t_inpaint.ieee_fp32():
                b_in.set()
                a_out.wait()
                seen.append((torch.backends.cudnn.allow_tf32,
                             torch.get_float32_matmul_precision()))

        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert seen == [(False, "highest")]
        assert torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])
