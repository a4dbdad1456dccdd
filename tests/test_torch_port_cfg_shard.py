"""`--mesh model=3` in the port (parallel/cfg_shard.py, the model's
cfg_mesh) against the JAX package's CFG-branch sharding, on the CPU at the
tiny configs, fp32.

- The port's model on the devices ("cpu",) * 3 against the JAX
  TPUConditionalInpainter(tiny, cfg_mesh=make_cfg_mesh(3)) on three of the
  conftest's host devices, the same weights (the JAX tree converted), the
  same brush tokens and the JAX program's own draws: within 1 u8 level
  everywhere and at least 99% of pixels exact, as test_torch_port_stamp.py
  holds one stamp; the same at DeepCache interval 2.
- Against the port unsharded within 1 u8 level (the JAX test's own bound,
  tests/test_parallel.py): a stamp, a stroke session of two STAMP_ATs,
  DeepCache interval 2 and the f32 final step, each through the sharded
  UNet (its branch programs named in the engine).
- One UNet replica a distinct device: three repeats of the CPU hold the
  model's own UNet once.
- Every refusal of the JAX package's: too few devices, model other than 3,
  model with another axis, --max-batch with model; and build_server
  serving `--mesh model=3` on an explicit device list.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from diffusiontexturepainting_torch.core.config import PipelineConfig
from diffusiontexturepainting_torch.parallel.mesh import (
    CfgMesh,
    make_cfg_mesh,
    make_serving_mesh,
)
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter,
)
from diffusiontexturepainting_torch.serving.run import build_server
from diffusiontexturepainting_torch.weights.from_jax import (
    state_dict_from_jax,
)

torch.set_num_threads(2)

RES = 64
CPU3 = ("cpu", "cpu", "cpu")
SETTINGS = dict(steps=2, cfg_weight=2.0, tg_weight=1.0, tg_steps=2,
                context_pad=8)
COMPONENTS = ("unet", "vae_encoder", "vae_decoder", "patch_encoder")


def canvas_u8():
    rng = np.random.default_rng(0)
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[: RES // 2, :, :3] = rng.integers(0, 256, (RES // 2, RES, 3))
    canvas[: RES // 2, :, 3] = 255
    return canvas


def brush():
    return np.random.default_rng(1).random((RES, RES, 3)).astype(np.float32)


@pytest.fixture(scope="module")
def jax_model():
    from diffusiontexturepainting_tpu.parallel.cfg_shard import (
        make_cfg_mesh as j_make_cfg_mesh,
    )
    from diffusiontexturepainting_tpu.pipeline.tpu_model import (
        TPUConditionalInpainter,
    )

    assert len(jax.devices()) >= 3
    model = TPUConditionalInpainter(RES, tiny=True, warmup=False,
                                    verbose_timing=False,
                                    cfg_mesh=j_make_cfg_mesh(3))
    model.set_brush(brush())
    return model


def with_jax_draws(model, jmodel):
    """`model` drawing what the JAX stamp program draws at each counter
    (fold_in of the counter, then the VAE-sample and initial-latent keys,
    JAX pipeline/inpaint.py), and holding the JAX model's brush tokens."""
    lat = RES // 8

    def draws(counter, res, steps=None):
        rng = jax.random.fold_in(jmodel._base_key, np.uint32(counter))
        _, enc_rng, lat_rng, _ = jax.random.split(rng, 4)
        enc = jax.random.normal(enc_rng, (2, lat, lat, 4), jnp.float32)
        init = jax.random.normal(lat_rng, (1, lat, lat, 4), jnp.float32)
        return (torch.from_numpy(np.array(enc)),
                torch.from_numpy(np.array(init)), None)

    model.draws = draws
    model.image = jmodel.image
    model._brush = torch.from_numpy(np.array(jmodel._brush_dev))
    model._cond = torch.from_numpy(np.array(jmodel._cond))
    model._uncond = torch.from_numpy(np.array(jmodel._uncond))
    return model


@pytest.fixture(scope="module")
def weights(jax_model):
    return {name: state_dict_from_jax(name, jax_model.params[name])
            for name in COMPONENTS}


def port(weights, mesh=True, config=None):
    return TorchConditionalInpainter(
        RES, device="cpu", tiny=True, weights=weights, config=config,
        verbose_timing=False,
        cfg_mesh=make_cfg_mesh(3, CPU3, "cpu") if mesh else None)


@pytest.fixture(scope="module")
def sharded(weights):
    return port(weights)


@pytest.fixture(scope="module")
def plain(weights):
    return port(weights, mesh=False)


def assert_u8_close(got, want, exact_share=0.99):
    assert got.shape == want.shape and got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - np.asarray(want).astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= exact_share


def stamp(model, counter=11, **settings):
    if hasattr(model, "_request_counter"):
        model._request_counter = counter
    else:
        model.request_counter = counter
    return np.asarray(model.generate_u8(canvas_u8(),
                                        **{**SETTINGS, **settings}))


def kinds(model) -> set:
    """The kinds of branch program the model's engines ran."""
    return {key[1] for e in model.cfg_unets.engines.values()
            for key in e.programs if key[0] == "cfg"}


def test_cfg_stamp_matches_the_jax_cfg_stamp(jax_model, weights):
    """Tolerance: 1 u8 level everywhere, 99% of pixels exact."""
    model = with_jax_draws(port(weights), jax_model)
    assert_u8_close(stamp(model), stamp(jax_model))
    assert "exact" in kinds(model)


def test_cfg_deep_cache_matches_the_jax_cfg_stamp(jax_model, weights):
    jax_model.set_deep_cache(2, min_steps=2)
    try:
        want = stamp(jax_model, steps=4)
    finally:
        jax_model.set_deep_cache(1)
    model = with_jax_draws(port(weights), jax_model)
    model.set_deep_cache(2, min_steps=2)
    assert_u8_close(stamp(model, steps=4), want)
    assert {"full", "shallow"} <= kinds(model)


def test_cfg_stamp_within_one_level_of_the_unsharded(sharded, plain):
    for m in (sharded, plain):
        m.set_brush(brush())
    got, want = stamp(sharded, 5), stamp(plain, 5)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_cfg_session_stroke(weights):
    """Two STAMP_ATs of a stroke session through the sharded UNet, the
    fetched canvas within 1 level of the unsharded model's."""
    out = []
    for model in (port(weights), port(weights, mesh=False)):
        model.set_brush(brush())
        model.request_counter = 20
        model.begin_session(np.zeros((RES, 2 * RES, 4), np.uint8))
        model.stamp_at(0, 0, return_pixels=False, **SETTINGS)
        crop = model.stamp_at(RES // 2, 0, return_pixels=True, **SETTINGS)
        out.append((crop, model.fetch_canvas()))
        model.end_session()
    (crop, canvas), (crop0, canvas0) = out
    assert canvas[..., 3].sum() > 0
    assert np.abs(crop.astype(int) - crop0.astype(int)).max() <= 1
    assert np.abs(canvas.astype(int) - canvas0.astype(int)).max() <= 1


@pytest.mark.parametrize("config,steps,want_kinds", [
    (dict(deep_cache_interval=2, deep_cache_min_steps=2), 4,
     {"full", "shallow"}),
    (dict(f32_final_step=True), 2, {"exact", "final"}),
    (dict(f32_final_step=True, deep_cache_interval=2,
          deep_cache_min_steps=2), 3, {"full", "shallow", "final"}),
], ids=["deep_cache_2", "f32_final", "deep_cache_2+f32_final"])
def test_cfg_operating_points_within_one_level(weights, config, steps,
                                               want_kinds):
    config = PipelineConfig(**config)
    got, want = (stamp(port(weights, mesh, config), 7, steps=steps)
                 for mesh in (True, False))
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1
    model = port(weights, True, config)
    stamp(model, 7, steps=steps)
    assert kinds(model) >= want_kinds


def test_one_replica_a_distinct_device(sharded):
    unets = sharded.cfg_unets
    assert len(unets.replicas) == 1 and len(unets.engines) == 1
    assert unets.replicas[torch.device("cpu")][0] is sharded.unet
    assert unets.engines[torch.device("cpu")] is sharded.engine
    assert sharded.cfg_mesh == CfgMesh("model=3", CPU3)


@pytest.mark.parametrize("spec,devices,max_batch,match", [
    ("model=3", ["cpu"], None, "mesh model=3 but only 1 devices"),
    ("model=4", ["cpu"] * 2, None, "mesh model=4 but only 2 devices"),
    ("model=2", CPU3, None, "needs mesh axis 'model'=3"),
    ("model=4", ["cpu"] * 4, None, "needs mesh axis 'model'=3"),
    ("data=1,model=3", CPU3, None, "--mesh model=N cannot combine with"),
    ("model=3", CPU3, 4, "--max-batch applies to --mesh data=N"),
])
def test_mesh_refusals(spec, devices, max_batch, match):
    with pytest.raises(ValueError, match=match):
        make_serving_mesh(spec, "cpu", devices, max_batch)


def test_make_cfg_mesh_takes_the_first_three():
    assert make_cfg_mesh(3, ["cpu"] * 5, "cpu").devices == CPU3
    assert make_serving_mesh("model=3", "cpu", CPU3) == CfgMesh(
        "model=3", CPU3)


@pytest.mark.parametrize("argv,match", [
    (["--mesh", "model=3"], "mesh model=3 but only 1 devices"),
    (["--mesh", "model=3", "--max-batch", "2"], "--max-batch applies"),
    (["--mesh", "model=2,data=1"], "cannot combine"),
])
def test_run_refuses_the_model_axis(argv, match):
    with pytest.raises(ValueError, match=match):
        build_server(argv + ["--device", "cpu", "--tiny", "--no-warmup",
                             "--port", "0"])


def test_run_serves_the_model_axis():
    server = build_server(["--mesh", "model=3", "--device", "cpu", "--tiny",
                           "--resolution", str(RES), "--no-warmup",
                           "--host", "127.0.0.1", "--port", "0"],
                          devices=CPU3)
    try:
        assert server.service is None
        assert server.model.cfg_mesh == CfgMesh("model=3", CPU3)
        assert "cfg-sharded[model=3]" in server.model_info
    finally:
        server.socket.close()
