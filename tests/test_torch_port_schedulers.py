"""The port's five schedulers (diffusiontexturepainting_torch/schedulers)
against the JAX package's, under the registry's seven names.

- Tables: the same float64 numpy construction rounded to float32 (np.interp
  and scipy.integrate.quad on the same inputs): equal bit for bit.
- Steps: seeded model outputs, samples and noise through every iteration
  with the state carried, float32 torch against float32 jnp: within atol
  1e-6, rtol 1e-6 (LMS and PNDM sum their histories in a tensordot each,
  whose order may differ).
- Whole tiny stamps (64^2, a few steps, fp32) for DPM++, EulerA, LMS and
  PNDM against jax.jit(make_stamp_fn(models, name, steps)), JAX's draws
  recomputed and injected (EulerA's per-step noise included): within 1 u8
  level everywhere, at least 99% of pixels exact.
- DDIM through the scheduler-generic loop: the same latents bit for bit as
  the loop before it (kept below as `_index_ddim_stamp`), so the default
  stamp's bytes do not move.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch import schedulers as t_sched
from diffusiontexturepainting_torch.models.vae import sample_latents
from diffusiontexturepainting_torch.ops.morphology import add_extra_context
from diffusiontexturepainting_torch.ops.resize import nearest_downsample
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_tpu import schedulers as j_sched
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from tests.test_torch_port_stamp import (  # noqa: F401 - the fixture
    RES,
    SCALE,
    assert_u8_close,
    both_sides,
)

torch.set_num_threads(2)

NAMES = ("DDIM", "DPM", "DPM++", "EulerA", "PNDM", "LMSD", "LMS")
# the JAX constructors' other options the port keeps
VARIANTS = [
    ("DPM++", dict(solver_order=3)),
    ("DPM++", dict(solver_type="heun")),
    ("DPM++", dict(solver_order=3, solver_type="heun")),
    ("DPM", dict(algorithm_type="dpmsolver")),
    ("DPM", dict(algorithm_type="dpmsolver", solver_type="heun",
                 solver_order=3)),
    ("DPM++", dict(prediction_type="v_prediction")),
    ("DPM", dict(algorithm_type="dpmsolver",
                 prediction_type="v_prediction")),
    ("EulerA", dict(prediction_type="v_prediction")),
    ("LMS", dict(prediction_type="v_prediction")),
    ("PNDM", dict(prediction_type="v_prediction")),
]


def test_registry_matches_jax():
    assert t_sched.available_schedulers() == j_sched.available_schedulers()
    assert sorted(NAMES) == t_sched.available_schedulers()
    for name in NAMES:
        assert (type(t_sched.make_scheduler(name)).__name__
                == type(j_sched.make_scheduler(name)).__name__)
    with pytest.raises(ValueError, match="available"):
        t_sched.make_scheduler("Heun")


@pytest.mark.parametrize("steps", [1, 4, 20, 50])
@pytest.mark.parametrize("name", NAMES)
def test_tables_match_jax(name, steps):
    """Every row of scan_rows(), the iteration count, the noise scale and
    stochasticity: equal."""
    ours = t_sched.make_scheduler(name).set_timesteps(steps)
    ref = j_sched.make_scheduler(name).set_timesteps(steps)
    want = ref.scan_rows()
    got = ours.scan_rows()
    assert set(got) == set(want)
    for key, val in want.items():
        assert got[key].dtype == val.dtype, key
        np.testing.assert_array_equal(got[key], val, err_msg=key)
    assert ours.num_iterations() == ref.num_iterations()
    assert ours.init_noise_sigma == ref.init_noise_sigma
    assert ours.stochastic == ref.stochastic
    assert len(ours.rows()) == ours.num_iterations()


@pytest.mark.parametrize("name,kwargs", VARIANTS)
def test_variant_tables_match_jax(name, kwargs):
    ours = t_sched.make_scheduler(name, **kwargs).set_timesteps(7)
    ref = j_sched.make_scheduler(name, **kwargs).set_timesteps(7)
    for key, val in ref.scan_rows().items():
        np.testing.assert_array_equal(ours.scan_rows()[key], val,
                                      err_msg=key)


def _trajectories(name, steps, kwargs=None, shape=(1, 4, 5, 4)):
    """Both schedulers over every iteration on the same seeded inputs."""
    kwargs = kwargs or {}
    ours = t_sched.make_scheduler(name, **kwargs).set_timesteps(steps)
    ref = j_sched.make_scheduler(name, **kwargs).set_timesteps(steps)
    n = ref.num_iterations()
    rng = np.random.default_rng(steps)
    x0 = (rng.standard_normal(shape) * ref.init_noise_sigma).astype(
        np.float32)
    eps = rng.standard_normal((n,) + shape).astype(np.float32)
    noise = rng.standard_normal((n,) + shape).astype(np.float32)
    rows = ref.scan_rows()
    xt, xj = torch.from_numpy(x0), jnp.asarray(x0)
    st, sj = ours.init_state(xt), ref.init_state(shape)
    out = []
    for i, our_row in enumerate(ours.rows()):
        row = {k: jnp.asarray(v[i]) for k, v in rows.items()}
        nz = noise[i] if ref.stochastic else None
        # the UNet input scaling too
        np.testing.assert_array_equal(
            ours.scale_model_input(xt, our_row).numpy(),
            np.asarray(ref.scale_model_input(xj, row)))
        xt, st = ours.step(torch.from_numpy(eps[i]), xt, our_row, st,
                           None if nz is None else torch.from_numpy(nz))
        xj, sj = ref.step(jnp.asarray(eps[i]), xj, row, sj,
                          None if nz is None else jnp.asarray(nz))
        out.append((xt.numpy(), np.asarray(xj)))
        for key in sj:
            np.testing.assert_allclose(st[key].numpy(), np.asarray(sj[key]),
                                       rtol=1e-6, atol=1e-6, err_msg=key)
    return out


@pytest.mark.parametrize("steps", [4, 20])
@pytest.mark.parametrize("name", NAMES)
def test_steps_match_jax(name, steps):
    for got, want in _trajectories(name, steps):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("name,kwargs", VARIANTS)
def test_variant_steps_match_jax(name, kwargs):
    for got, want in _trajectories(name, 6, kwargs):
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def jax_draws(key, counter, n_iters, lat=RES // 8):
    """The JAX stamp program's draws (pipeline/inpaint.py:158, 179, 193,
    201, 233): the VAE noise, the initial latents and the per-step noise
    of a stochastic scheduler."""
    rng = jax.random.fold_in(key, counter)
    _, enc_rng, lat_rng, step_rng = jax.random.split(rng, 4)
    enc = jax.random.normal(enc_rng, (2, lat, lat, 4), jnp.float32)
    init = jax.random.normal(lat_rng, (1, lat, lat, 4), jnp.float32)
    step = np.stack([np.asarray(jax.random.normal(k, (1, lat, lat, 4),
                                                  jnp.float32))
                     for k in jax.random.split(step_rng, n_iters)])
    return np.array(enc), np.array(init), step


def _stamp_inputs(seed):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((1, RES, RES, 4), np.uint8)
    canvas[:, :20, :, :3] = rng.integers(0, 256, (1, 20, RES, 3))
    canvas[:, :20, :, 3] = 255
    canvas[:, 40:50, 30:60, :3] = 200
    canvas[:, 40:50, 30:60, 3] = 255
    brush = rng.random((1, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((1, 14, 32)).astype(np.float32)
    return canvas, brush, cond, uncond


@pytest.mark.parametrize("name,steps", [("DPM++", 5), ("EulerA", 5),
                                        ("LMS", 5), ("PNDM", 4)])
def test_stamp_matches_jax(both_sides, name, steps):
    params, models, port_models, _, _ = both_sides
    jax_stamp = jax.jit(j_inpaint.make_stamp_fn(models, name, steps))
    port_stamp = t_inpaint.make_stamp_fn(*port_models, steps, SCALE, name)
    n_iters = port_stamp.scheduler.num_iterations()
    assert n_iters == steps + (name == "PNDM")
    canvas, brush, cond, uncond = _stamp_inputs(3)
    key, counter = jax.random.PRNGKey(7), 5
    # texture guidance over the first three model calls only
    cfg, tg, tg_steps, pad = 2.5, 1.0, 3, 150
    want = jax_stamp(
        params, jnp.asarray(canvas), jnp.asarray(brush), jnp.asarray(cond),
        jnp.asarray(uncond), key, np.uint32(counter), np.float32(cfg),
        np.float32(tg), np.int32(tg_steps), np.int32(pad))
    enc, init, step = jax_draws(key, counter, n_iters)
    got = port_stamp(
        torch.from_numpy(canvas), torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), cfg, tg, tg_steps,
        pad, torch.from_numpy(step) if name == "EulerA" else None)
    assert_u8_close(got, want)


def test_stochastic_stamp_needs_its_noise(both_sides):
    port_stamp = t_inpaint.make_stamp_fn(*both_sides[2], 2, SCALE, "EulerA")
    canvas, brush, cond, uncond = _stamp_inputs(4)
    enc, init, _ = jax_draws(jax.random.PRNGKey(0), 0, 2)
    with pytest.raises(ValueError, match="step_noise"):
        port_stamp(*(torch.from_numpy(a) for a in (
            canvas, brush, cond, uncond, enc, init)), 2.0, 1.0, 2, 150)


def _index_ddim_stamp(unet, vae_encoder, vae_decoder, num_steps,
                      vae_scaling):
    """The DDIM stamp loop as it was before the schedulers' row interface:
    the float32 eta = 0 coefficients indexed by step (a copy, to hold the
    generic loop to it)."""
    sched = t_sched.make_scheduler("DDIM").set_timesteps(num_steps)
    timesteps = sched.scan_rows()["timestep"]
    one = np.float32(1.0)
    sqrt_beta = np.sqrt(one - sched.alpha_prod)
    sqrt_alpha = np.sqrt(sched.alpha_prod)
    sqrt_alpha_prev = np.sqrt(sched.alpha_prod_prev)
    sqrt_dir = np.sqrt(one - sched.alpha_prod_prev)

    @torch.inference_mode()
    def stamp(canvas_u8, brush, cond, uncond, enc_noise, init_latents,
              cfg_weight, tg_weight, tg_steps, context_pad):
        canvas = canvas_u8.float() / 255.0
        images = canvas[..., :3] * 2.0 - 1.0
        mask = canvas[..., 3:4]
        masked_images = images * mask
        ctx_masked, ctx_mask = add_extra_context(
            brush.float() * 2.0 - 1.0, masked_images, mask, context_pad)
        m_lat = nearest_downsample(1.0 - mask, 8)
        cm_lat = nearest_downsample(1.0 - ctx_mask, 8)
        mask_lat = torch.cat([m_lat, m_lat, cm_lat], dim=0)
        moments = vae_encoder(torch.cat([masked_images, ctx_masked], dim=0))
        lat = sample_latents(moments, enc_noise) * vae_scaling
        masked_latents = torch.cat([lat[:1], lat[:1], lat[1:]], dim=0)
        embeddings = torch.cat([uncond.float(), cond.float(), cond.float()],
                               dim=0)
        latents = init_latents.float() * 1.0
        for i in range(num_steps):
            tg_scale = float(tg_weight) if i < int(tg_steps) else 0.0
            unet_in = torch.cat([torch.cat([latents] * 3, dim=0), mask_lat,
                                 masked_latents], dim=-1)
            t = torch.full((3,), float(timesteps[i]), device=latents.device)
            eps_u, eps_c, eps_tg = unet(unet_in, t, embeddings).chunk(3)
            eps = (eps_u + float(cfg_weight) * (eps_c - eps_u)
                   + tg_scale * (eps_tg - eps_c))
            pred_x0 = (latents - float(sqrt_beta[i]) * eps) \
                / float(sqrt_alpha[i])
            pred_dir = float(sqrt_dir[i]) * eps
            latents = float(sqrt_alpha_prev[i]) * pred_x0 + pred_dir
        return latents

    return stamp


@pytest.mark.parametrize("steps", [4, 20])
def test_ddim_generic_loop_is_bit_equal(both_sides, steps):
    """The final latents (what the VAE decodes) of the generic loop and
    the index loop, bit for bit; hence equal u8 stamps."""
    port_models = both_sides[2]
    decoded = []

    class Recorder(torch.nn.Module):
        def forward(self, z):
            decoded.append(z.clone())
            return port_models[2](z)

    new = t_inpaint.make_stamp_fn(port_models[0], port_models[1], Recorder(),
                                  steps, SCALE)
    old = _index_ddim_stamp(*port_models, steps, SCALE)
    canvas, brush, cond, uncond = _stamp_inputs(5)
    enc, init, _ = jax_draws(jax.random.PRNGKey(1), 2, 1)
    args = [torch.from_numpy(a) for a in (canvas, brush, cond, uncond, enc,
                                          init)]
    new(*args, 2.0, 1.0, steps // 2, 150)
    want = old(*args, 2.0, 1.0, steps // 2, 150)
    assert torch.equal(decoded[0], want / SCALE)
