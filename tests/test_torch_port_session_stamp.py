"""Stroke-session stamps of the port (pipeline/session.py session_stamp
and session_erase over the default, fused configuration) against the JAX
package's session programs (make_session_stamp_fn, make_session_erase_fn)
at the tiny configs, with the same weights, canvases and, as in
test_torch_port_stamp.py, JAX's random draws recomputed and injected.

fp32 on both sides. Each composited crop is within 1 level of JAX's
everywhere and exact on at least 99% of its pixels; the canvases are equal
outside the stamped windows and as close as the crops inside them.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_torch.pipeline import session as t_session
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from diffusiontexturepainting_tpu.pipeline import session as j_session
from tests.test_torch_port_modules import jax_init, port_with
from tests.test_torch_port_stamp import assert_u8_close, jax_draws

torch.set_num_threads(2)

RES, STEPS, SCALE = 64, 4, 0.18215
HEIGHT, WIDTH = 80, 112
SETTINGS = dict(cfg=2.0, tg=1.0, tg_steps=STEPS, pad=150)
KEY = jax.random.PRNGKey(42)


def _fused_unet_cfg(config):
    p = config.PipelineConfig()
    return dataclasses.replace(config.tiny_unet_config(),
                               fused_resnet=p.fused_unet_resnet,
                               fused_ff=p.fused_unet_ff,
                               fused_norm=p.fused_unet_norm)


@pytest.fixture(scope="module")
def sides():
    """(JAX session stamp program, its params, the port's stamp function,
    brush/cond/uncond as numpy)."""
    jcfg, vcfg = _fused_unet_cfg(j_config), j_config.tiny_vae_config()
    ju = j_unet.UNet2DCondition(jcfg)
    lat = RES // 8
    params = {
        "unet": jax_init(ju, jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(j_vae.VAEEncoder(vcfg),
                                jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": jax_init(j_vae.VAEDecoder(vcfg),
                                jnp.zeros((1, lat, lat, 4)), seed=3),
    }
    models = j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: j_vae.fused_encode(p, x, vcfg,
                                                         jnp.float32),
        vae_decode_apply=lambda p, z: j_vae.fused_decode(p, z, vcfg,
                                                         jnp.float32),
        params=None, vae_scaling=SCALE)
    jax_fn = jax.jit(j_session.make_session_stamp_fn(models, "DDIM", STEPS))
    tv = t_config.tiny_vae_config()
    port_stamp = t_inpaint.make_stamp_fn(
        port_with(UNet2DCondition(_fused_unet_cfg(t_config)), "unet",
                  params["unet"]),
        port_with(VAEEncoder(tv, fused=True), "vae_encoder",
                  params["vae_encoder"]),
        port_with(VAEDecoder(tv, fused=True), "vae_decoder",
                  params["vae_decoder"]),
        STEPS, SCALE)
    rng = np.random.default_rng(0)
    brush = rng.random((1, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    return jax_fn, params, port_stamp, (brush, cond, uncond)


def _canvas():
    """A painted band on top, a painted patch, the rest empty."""
    rng = np.random.default_rng(1)
    canvas = np.zeros((HEIGHT, WIDTH, 4), np.uint8)
    canvas[:24, :, :3] = rng.integers(0, 256, (24, WIDTH, 3))
    canvas[:24, :, 3] = 255
    canvas[50:70, 60:100, :3] = 200
    canvas[50:70, 60:100, 3] = 255
    return canvas


def _jax_stamp(sides, canvas, counter, x0, y0, margin):
    jax_fn, params, _, (brush, cond, uncond) = sides
    s = SETTINGS
    new_canvas, comp = jax_fn(
        params, jnp.asarray(canvas), jnp.asarray(brush), jnp.asarray(cond),
        jnp.asarray(uncond), KEY, np.uint32(counter), np.int32(x0),
        np.int32(y0), np.float32(s["cfg"]), np.float32(s["tg"]),
        np.int32(s["tg_steps"]), np.int32(s["pad"]), np.int32(margin))
    return np.asarray(new_canvas), np.asarray(comp)


def _port_stamp(sides, canvas_t, counter, x0, y0, margin):
    _, _, port_stamp, (brush, cond, uncond) = sides
    enc, init = jax_draws(KEY, counter)
    s = SETTINGS
    return t_session.session_stamp(
        port_stamp, canvas_t, torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), x0, y0, s["cfg"],
        s["tg"], s["tg_steps"], s["pad"], margin)


def _assert_canvases_close(got, want, windows):
    """Equal outside every stamped window; inside, as the crops."""
    outside = np.ones(want.shape[:2], bool)
    for x0, y0 in windows:
        x, y = t_session.clamped_corner(x0, y0, RES, WIDTH, HEIGHT)
        outside[y:y + RES, x:x + RES] = False
    np.testing.assert_array_equal(got[outside], want[outside])
    diff = np.abs(got.astype(int) - want.astype(int))
    assert diff.max() <= 1
    assert (diff == 0).mean() >= 0.99


def test_session_stamp_chain_matches_jax(sides):
    """Three chained stamps into one resident canvas: a plain stamp, an
    overpainting one over its window, and one whose corner clamps (x past
    the right edge, y above the top)."""
    canvas_j = _canvas()
    canvas_t = torch.from_numpy(_canvas())
    margin = t_session.overpaint_margin(RES)
    assert margin == 9
    plan = [(7, 0, 0, 0), (8, 30, 10, margin), (9, 500, -40, 0)]
    with torch.inference_mode():
        for counter, x0, y0, m in plan:
            canvas_j, comp_j = _jax_stamp(sides, canvas_j, counter, x0, y0,
                                          m)
            comp_t = _port_stamp(sides, canvas_t, counter, x0, y0, m)
            assert_u8_close((comp_t,), (comp_j,))
    _assert_canvases_close(canvas_t.numpy(), canvas_j,
                           [(x0, y0) for _, x0, y0, _ in plan])
    # the clamped window sits at the canvas's top-right corner
    assert t_session.clamped_corner(500, -40, RES, WIDTH, HEIGHT) == (48, 0)


def test_session_stamp_writes_the_host_oracle(sides):
    """session_stamp's canvas write is host_stamp_update of its own
    composited crop (the port's oracle, used on the card), overpaint
    clearing the crop's centre before the stamp."""
    canvas = _canvas()
    canvas_t = torch.from_numpy(canvas.copy())
    margin = t_session.overpaint_margin(RES)
    with torch.inference_mode():
        comp = _port_stamp(sides, canvas_t, 11, 40, 12, margin).numpy()
    np.testing.assert_array_equal(
        canvas_t.numpy(), t_session.host_stamp_update(canvas, comp, 40, 12))
    # the crop the stamp saw: centre cleared, RGB and alpha
    crop = canvas[12:12 + RES, 40:40 + RES].copy()
    crop[margin:RES - margin, margin:RES - margin] = 0
    _, _, port_stamp, (brush, cond, uncond) = sides
    enc, init = jax_draws(KEY, 11)
    s = SETTINGS
    _, want = port_stamp(torch.from_numpy(crop)[None],
                         torch.from_numpy(brush), torch.from_numpy(cond),
                         torch.from_numpy(uncond), torch.from_numpy(enc),
                         torch.from_numpy(init), s["cfg"], s["tg"],
                         s["tg_steps"], s["pad"])
    np.testing.assert_array_equal(comp, want.numpy())


@pytest.mark.parametrize("x0,y0", [(10, 5), (-9, 100), (48, 16)])
def test_session_erase_matches_jax(x0, y0):
    """The erase circle zeroes RGBA in place at the clamped corner; the
    returned crop is the window's RGB after it."""
    canvas = np.random.default_rng(2).integers(0, 256, (HEIGHT, WIDTH, 4),
                                               dtype=np.uint8)
    want_canvas, want_crop = jax.jit(j_session.make_session_erase_fn(RES))(
        jnp.asarray(canvas), np.int32(x0), np.int32(y0))
    canvas_t = torch.from_numpy(canvas.copy())
    crop = t_session.session_erase(canvas_t,
                                   t_session.erase_keep(RES, "cpu"), x0, y0)
    np.testing.assert_array_equal(canvas_t.numpy(), np.asarray(want_canvas))
    np.testing.assert_array_equal(crop.numpy(), np.asarray(want_crop))
