"""Checkpoints in the JAX package's npz format on both sides
(diffusiontexturepainting_torch/weights/loader.py against
diffusiontexturepainting_tpu/weights/loader.py), at the tiny configs on
the CPU, fp32.

- A checkpoint the JAX package writes from its seeded init loads into the
  port with every weight equal, and the port's stamp on it matches the JAX
  stamp on the same params (injected draws; within 1 u8 level, at least
  99% of pixels exact, as tests/test_torch_port_stamp.py).
- A checkpoint the port writes loads in the JAX load_pipeline_params
  (validate=True) with every weight equal.
- A missing component falls back to the seeded random weights, with a
  warning; a truncated, mis-shaped or mis-named npz raises ValueError and
  leaves the served weights as they were.
- reload_params gives the model a fresh build from the same checkpoint
  gives: every parameter and buffer (the slotted q/k/v, the upsamplers'
  folded taps, the decoder's padded head rebuilt), the brush's tokens and
  the stamp bytes, equal.
"""

import logging
import os
import shutil

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.weights import loader as t_loader
from diffusiontexturepainting_torch.weights.from_jax import (
    jax_tree_from_state_dict,
    state_dict_from_jax,
)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import patch_encoder as j_pe
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from diffusiontexturepainting_tpu.weights import loader as j_loader
from tests.test_torch_port_modules import flat, jax_init
from tests.test_torch_port_stamp import assert_u8_close, jax_draws

torch.set_num_threads(2)

RES, STEPS = 64, 4
COMPONENTS = ("unet", "vae_encoder", "vae_decoder", "patch_encoder")


def jax_modules():
    pcfg = j_config.tiny_patch_encoder_config()
    return (j_unet.UNet2DCondition(j_config.tiny_unet_config()),
            j_vae.VAEEncoder(j_config.tiny_vae_config()),
            j_vae.VAEDecoder(j_config.tiny_vae_config()),
            j_pe.ConditionPatchEncoder(pcfg))


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """(directory, params): the JAX package's tiny seeded init, saved by
    its own save_pipeline_params."""
    ju, je, jd, jp = jax_modules()
    lat = RES // 8
    pcfg = j_config.tiny_patch_encoder_config()
    params = {
        "unet": jax_init(ju, jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(je, jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": jax_init(jd, jnp.zeros((1, lat, lat, 4)), seed=3),
        "patch_encoder": jax_init(
            jp, jnp.zeros((1, pcfg.total_patches, pcfg.clip.image_size,
                           pcfg.clip.image_size, 3)),
            return_uncond_vector=True, seed=4),
    }
    path = str(tmp_path_factory.mktemp("jax_ckpt"))
    j_loader.save_pipeline_params(path, params)
    return path, params


def twin(**kwargs):
    return TorchConditionalInpainter(
        RES, config=t_config.safe_twin_config(), device="cpu", tiny=True,
        **kwargs)


def assert_state_dicts_equal(a, b):
    for name in COMPONENTS:
        assert set(a[name]) == set(b[name]), name
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)


def test_jax_checkpoint_loads_into_port(jax_checkpoint):
    path, params = jax_checkpoint
    model = twin(checkpoint_dir=path)
    want = {name: state_dict_from_jax(name, params[name])
            for name in COMPONENTS}
    assert_state_dicts_equal(model.state_dicts(), want)


def test_port_stamp_on_jax_checkpoint_matches_jax(jax_checkpoint):
    """The loaded model's DDIM stamp against the JAX stamp program on the
    params it loaded from the same directory, the same draws."""
    path, _ = jax_checkpoint
    ju, je, jd, jp = jax_modules()
    params = j_loader.load_pipeline_params(path, ju, je, jd, jp,
                                           validate=True)
    models = j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: je.apply({"params": p}, x),
        vae_decode_apply=lambda p, z: jd.apply({"params": p}, z),
        params=None, vae_scaling=0.18215)
    jax_stamp = jax.jit(j_inpaint.make_stamp_fn(models, "DDIM", STEPS))
    model = twin(checkpoint_dir=path)
    rng = np.random.default_rng(2)
    canvas = np.zeros((1, RES, RES, 4), np.uint8)
    canvas[:, :24, :, :3] = rng.integers(0, 256, (1, 24, RES, 3))
    canvas[:, :24, :, 3] = 255
    brush = rng.random((1, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    key, counter = jax.random.PRNGKey(3), 4
    want = jax_stamp(params, jnp.asarray(canvas), jnp.asarray(brush),
                     jnp.asarray(cond), jnp.asarray(uncond), key,
                     np.uint32(counter), np.float32(2.0), np.float32(1.0),
                     np.int32(STEPS), np.int32(150))
    enc, init = jax_draws(key, counter)
    got = model._stamp_fn(STEPS)(
        *(torch.from_numpy(a) for a in (canvas, brush, cond, uncond, enc,
                                        init)), 2.0, 1.0, STEPS, 150)
    assert_u8_close(got, want)


def test_port_checkpoint_loads_in_jax(tmp_path):
    model = twin(weights_seed=3)
    nbytes = t_loader.save_pipeline_params(str(tmp_path), model.state_dicts())
    assert nbytes == 4 * sum(p.numel() for name in COMPONENTS
                             for p in getattr(model, name).state_dict()
                             .values())
    assert sorted(os.listdir(tmp_path)) == sorted(f"{n}.npz"
                                                  for n in COMPONENTS)
    loaded = j_loader.load_pipeline_params(str(tmp_path), *jax_modules(),
                                           validate=True)
    got = {name: state_dict_from_jax(name, loaded[name])
           for name in COMPONENTS}
    assert_state_dicts_equal(got, model.state_dicts())
    for name in COMPONENTS:  # float32 arrays, the JAX loader's paths
        for v in flat(loaded[name]).values():
            assert v.dtype == np.float32


@pytest.mark.parametrize("name", COMPONENTS)
def test_inverse_rename_round_trips(jax_checkpoint, name):
    """jax_tree_from_state_dict(state_dict_from_jax(tree)) == tree."""
    tree = jax_checkpoint[1][name]
    back = flat(jax_tree_from_state_dict(name,
                                         state_dict_from_jax(name, tree)))
    want = flat(tree)
    assert set(back) == set(want)
    for k in want:
        np.testing.assert_array_equal(back[k], want[k], err_msg=k)


def test_save_refuses_without_space(tmp_path, monkeypatch):
    model = twin()
    free = shutil.disk_usage(tmp_path)
    monkeypatch.setattr(t_loader.shutil, "disk_usage",
                        lambda p: free._replace(free=10))
    with pytest.raises(OSError, match="does not fit"):
        t_loader.save_pipeline_params(str(tmp_path), model.state_dicts())
    assert os.listdir(tmp_path) == []


def test_missing_component_falls_back_and_logs(jax_checkpoint, tmp_path,
                                               caplog):
    path, params = jax_checkpoint
    shutil.copy(os.path.join(path, "vae_decoder.npz"), tmp_path)
    with caplog.at_level(logging.WARNING):
        model = twin(checkpoint_dir=str(tmp_path))
    for name in ("unet", "vae_encoder", "patch_encoder"):
        assert any(name in r.getMessage() and "random init" in r.getMessage()
                   for r in caplog.records), name
    random_model = twin()
    got, rand = model.state_dicts(), random_model.state_dicts()
    want = dict(rand, vae_decoder=state_dict_from_jax(
        "vae_decoder", params["vae_decoder"]))
    assert_state_dicts_equal(got, want)


def _corrupt(src_dir, dst_dir, how):
    """A copy of the checkpoint with its unet.npz truncated, one array
    mis-shaped, or one key renamed."""
    for name in COMPONENTS:
        shutil.copy(os.path.join(src_dir, f"{name}.npz"), dst_dir)
    target = os.path.join(dst_dir, "unet.npz")
    if how == "truncated":
        size = os.path.getsize(target)
        with open(target, "r+b") as f:
            f.truncate(size // 2)
        return
    with np.load(target) as data:
        arrays = {k: data[k] for k in data.files}
    key = sorted(arrays)[0]
    if how == "misshaped":
        arrays[key] = np.zeros(arrays[key].shape + (2,), np.float32)
    else:
        arrays[key + "_renamed"] = arrays.pop(key)
    np.savez(target, **arrays)


@pytest.mark.parametrize("how,match", [
    ("truncated", "unet.*unreadable"),
    ("misshaped", "unet:.*shape"),
    ("renamed", "checkpoint mismatch for unet: missing="),
])
def test_bad_checkpoint_raises_and_keeps_weights(jax_checkpoint, tmp_path,
                                                 how, match):
    path, _ = jax_checkpoint
    _corrupt(path, str(tmp_path), how)
    with pytest.raises(ValueError, match=match):
        twin(checkpoint_dir=str(tmp_path))
    model = twin(weights_seed=5)
    before = {n: {k: v.clone() for k, v in sd.items()}
              for n, sd in model.state_dicts().items()}
    cond = model._cond.clone()
    with pytest.raises(ValueError, match=match):
        model.reload_params(str(tmp_path))
    assert_state_dicts_equal(model.state_dicts(), before)
    assert torch.equal(model._cond, cond)


def test_reload_equals_fresh_build(tmp_path):
    """A slotted-config model seeded otherwise, reloaded, against a fresh
    build from the checkpoint: parameters, derived buffers, brush tokens
    and stamp bytes, equal."""
    cfg = t_config.slotted_config()
    src = TorchConditionalInpainter(RES, config=cfg, device="cpu", tiny=True)
    t_loader.save_pipeline_params(str(tmp_path), src.state_dicts())
    reloaded = TorchConditionalInpainter(RES, config=cfg, device="cpu",
                                         tiny=True, weights_seed=9)
    brush = np.random.default_rng(0).integers(0, 256, (90, 70, 3),
                                              dtype=np.uint8)
    reloaded.set_brush(brush)
    stale = {k: v.clone() for k, v in reloaded.unet.named_buffers()}
    reloaded.reload_params(str(tmp_path))
    fresh = TorchConditionalInpainter(RES, config=cfg, device="cpu",
                                      tiny=True,
                                      checkpoint_dir=str(tmp_path))
    fresh.set_brush(brush)
    derived = set()
    for name in COMPONENTS:
        a, b = getattr(reloaded, name), getattr(fresh, name)
        for (ka, va), (kb, vb) in zip(
                list(a.named_parameters()) + list(a.named_buffers()),
                list(b.named_parameters()) + list(b.named_buffers())):
            assert ka == kb and torch.equal(va, vb), (name, ka)
        derived |= {k.rsplit(".", 1)[-1] for k, _ in a.named_buffers()}
    # each kind of derived buffer was compared
    assert {"qkv_slotted", "taps", "conv_out_w8"} <= derived, derived
    assert any(not torch.equal(v, dict(reloaded.unet.named_buffers())[k])
               for k, v in stale.items())
    assert torch.equal(reloaded._cond, fresh._cond)
    assert torch.equal(reloaded._uncond, fresh._uncond)
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:20, :, :3], canvas[:20, :, 3] = 90, 255
    reloaded.request_counter = fresh.request_counter = 6
    np.testing.assert_array_equal(reloaded.generate_u8(canvas, steps=STEPS),
                                  fresh.generate_u8(canvas, steps=STEPS))


@pytest.mark.parametrize("name", COMPONENTS)
def test_inverse_rename_at_full_width(name):
    """Every parameter name of the full SD-1.5-width port module maps to a
    path of the JAX module's full-width parameter tree, and the paths
    cover the tree (shapes from jax.eval_shape and the meta device: nothing
    is computed or allocated)."""
    from diffusiontexturepainting_torch.weights.from_jax import jax_path
    from diffusiontexturepainting_torch.weights.random_init import (
        build_pipeline)
    from diffusiontexturepainting_tpu.weights.random_init import (
        pipeline_param_shapes)

    ju = j_unet.UNet2DCondition(j_config.UNetConfig())
    je = j_vae.VAEEncoder(j_config.VAEConfig())
    jd = j_vae.VAEDecoder(j_config.VAEConfig())
    jp = j_pe.ConditionPatchEncoder(j_config.PatchEncoderConfig())
    shapes = j_loader.flatten_params(
        pipeline_param_shapes(ju, je, jd, jp)[name])
    module = build_pipeline(t_config.UNetConfig(), t_config.VAEConfig(),
                            t_config.PatchEncoderConfig(), "meta",
                            torch.float32)[name]
    sd = module.state_dict()
    norms = {k.rsplit(".", 1)[0] for k, v in sd.items()
             if k.endswith(".weight") and v.dim() == 1}
    paths = {}
    for k, v in sd.items():
        path = jax_path(name, k, "." in k and k.rsplit(".", 1)[0] in norms)
        want = tuple(shapes[path].shape)
        got = tuple(v.shape)
        if path.endswith("kernel") and len(got) == 2:
            got = got[::-1]
        assert got == want, (k, path)
        paths[path] = k
    assert set(paths) == set(shapes)
