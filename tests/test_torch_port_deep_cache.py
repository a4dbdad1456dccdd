"""DeepCache in the port: the UNet's forward_full / forward_shallow, the
stamp's full/shallow schedule by interval and by pattern, session stamps,
and the serving model's rules, against the JAX package at the tiny configs.

- forward_full and forward_shallow against the JAX methods on the same
  weights and inputs, module and fused legs, fp32: within the module tests'
  tolerance (atol and rtol 2e-4, tests/test_torch_port_modules.py);
  forward equals forward_full()[0] bit for bit, and a shallow eval on the
  cache of a full eval at the same input equals the full eval bit for bit.
- Whole stamps (default configuration: fused UNet and VAE) against
  jax.jit(make_stamp_fn(models, name, steps, deep_cache_interval=...)),
  JAX's draws recomputed and injected as in test_torch_port_stamp.py:
  within 1 u8 level everywhere and at least 99% of pixels exact. DDIM at 4
  steps at intervals 2 and 3 and the patterns FSSF and FSFF, PNDM at 4
  steps (5 model calls) with FSFSF, EulerA at interval 2 and 8 steps.
- A session stamp with DeepCache against the JAX session program, the same
  tolerance; on the port's model, a STAMP_AT's crop equals generate_u8's
  stamp at the same request counter byte for byte.
- The model's rules, mirrored from tests/test_deep_cache.py: the
  deep_cache_min_steps gate for intervals, a pattern bypassing it and
  applying at its own scheduler iteration count only, the schedule's
  errors; and the parser refusing intervals below 1 (the JAX package's
  parse_deep_cache_spec accepts them, ROADMAP.md "Faults in the reference
  the port must not copy").
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
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.ops.conv3x3 import conv_impl
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from diffusiontexturepainting_tpu.pipeline import session as j_session
from tests.test_torch_port_modules import (
    assert_close,
    jax_init,
    port_with,
    rand,
)
from tests.test_torch_port_schedulers import jax_draws
from tests.test_torch_port_stamp import assert_u8_close

torch.set_num_threads(2)

RES, SCALE = 64, 0.18215
KEY = jax.random.PRNGKey(11)
FUSED = dict(fused_resnet=True, fused_ff=True, fused_norm=True)
SAFE = dict(fused_resnet=False, fused_ff=False, fused_norm=False,
            fused_attn=False)


def _unet_cfg(config, **legs):
    return dataclasses.replace(config.tiny_unet_config(), **legs)


# --- the UNet's two forwards ---


@pytest.mark.parametrize("legs", ["module", "fused"])
def test_forward_full_and_shallow_match_jax(sides, legs):
    tree = sides[0]["unet"]
    sample, ctx = rand((3, 8, 8, 9), 0), rand((3, 14, 32), 1)
    t = np.array([981.0, 500.0, 1.0], np.float32)
    kw = FUSED if legs == "fused" else {}
    ju = j_unet.UNet2DCondition(_unet_cfg(j_config, **kw))
    js, jt, jc = jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx)
    eps_j, cache_j = ju.apply({"params": tree}, js, jt, jc,
                              method=j_unet.UNet2DCondition.forward_full)
    # a cache unlike the full eval's, so the shallow eval is its own test
    other = np.asarray(cache_j) * 0.5 + rand(cache_j.shape, 3) * 0.1
    shallow_j = ju.apply({"params": tree}, js, jt, jc, jnp.asarray(other),
                         method=j_unet.UNet2DCondition.forward_shallow)

    pm = port_with(UNet2DCondition(_unet_cfg(t_config, **kw)), "unet", tree)
    ps, pt, pc = (torch.from_numpy(a) for a in (sample, t, ctx))
    with torch.no_grad():
        eps, cache = pm.forward_full(ps, pt, pc)
        shallow = pm.forward_shallow(ps, pt, pc, torch.from_numpy(other))
        plain = pm(ps, pt, pc)
        again = pm.forward_shallow(ps, pt, pc, cache)
    assert cache.shape == (3, 8, 8, 64)  # entering the outermost up level
    assert_close(eps, eps_j)
    assert_close(cache, cache_j)
    assert_close(shallow, shallow_j)
    assert torch.equal(plain, eps)
    assert torch.equal(again, eps)


# --- whole stamps ---


def _jax_models():
    """The JAX StampModels of the default configuration (fused UNet and
    VAE), with the DeepCache forwards and the f32 final UNet (the safe
    legs in f32 under conv_impl("xla"), as tpu_model.py builds them)."""
    ju = j_unet.UNet2DCondition(_unet_cfg(j_config, **FUSED))
    final = j_unet.UNet2DCondition(_unet_cfg(j_config, **SAFE),
                                   dtype=jnp.float32)
    vcfg = j_config.tiny_vae_config()
    U = j_unet.UNet2DCondition

    def unet_final_apply(p, s, t, c):
        with conv_impl("xla"):
            return final.apply({"params": p}, s, t, c)

    return j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: j_vae.fused_encode(p, x, vcfg,
                                                         jnp.float32),
        vae_decode_apply=lambda p, z: j_vae.fused_decode(p, z, vcfg,
                                                         jnp.float32),
        params=None, vae_scaling=SCALE,
        unet_full_apply=lambda p, s, t, c: ju.apply(
            {"params": p}, s, t, c, method=U.forward_full),
        unet_shallow_apply=lambda p, s, t, c, cache: ju.apply(
            {"params": p}, s, t, c, cache, method=U.forward_shallow),
        unet_final_apply=unet_final_apply)


@pytest.fixture(scope="module")
def sides():
    """(JAX params, JAX StampModels, the port's (unet, vae_encoder,
    vae_decoder) and its f32 final UNet), all on the same weights."""
    lat = RES // 8
    vcfg = j_config.tiny_vae_config()
    params = {
        "unet": jax_init(j_unet.UNet2DCondition(j_config.tiny_unet_config()),
                         jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(j_vae.VAEEncoder(vcfg),
                                jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": jax_init(j_vae.VAEDecoder(vcfg),
                                jnp.zeros((1, lat, lat, 4)), seed=3),
    }
    tv = t_config.tiny_vae_config()
    port = (port_with(UNet2DCondition(_unet_cfg(t_config, **FUSED)), "unet",
                      params["unet"]),
            port_with(VAEEncoder(tv, fused=True), "vae_encoder",
                      params["vae_encoder"]),
            port_with(VAEDecoder(tv, fused=True), "vae_decoder",
                      params["vae_decoder"]))
    final = port_with(UNet2DCondition(_unet_cfg(t_config, **SAFE)), "unet",
                      params["unet"])
    return params, _jax_models(), port, final


def stamp_inputs(seed):
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


def run_both(sides, name, steps, spec, final_step_f32=False, seed=3,
             counter=5):
    """The JAX stamp and the port's on the same inputs and draws; returns
    (port's (raw, comp), JAX's, the port's stamp function)."""
    params, models, port, final = sides
    jax_stamp = jax.jit(j_inpaint.make_stamp_fn(
        models, name, steps, deep_cache_interval=spec,
        final_step_f32=final_step_f32))
    port_stamp = t_inpaint.make_stamp_fn(
        *port, steps, SCALE, name, deep_cache_interval=spec,
        final_step_f32=final_step_f32, unet_final=final)
    n_iters = port_stamp.scheduler.num_iterations()
    canvas, brush, cond, uncond = stamp_inputs(seed)
    cfg, tg, tg_steps, pad = 2.0, 1.0, 3, 150
    want = jax_stamp(
        params, jnp.asarray(canvas), jnp.asarray(brush), jnp.asarray(cond),
        jnp.asarray(uncond), KEY, np.uint32(counter), np.float32(cfg),
        np.float32(tg), np.int32(tg_steps), np.int32(pad))
    enc, init, step = jax_draws(KEY, counter, n_iters)
    got = port_stamp(
        torch.from_numpy(canvas), torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), cfg, tg, tg_steps,
        pad, torch.from_numpy(step) if name == "EulerA" else None)
    return got, want, port_stamp


@pytest.mark.parametrize("name,steps,spec,schedule", [
    ("DDIM", 4, 2, "FSFS"),
    ("DDIM", 4, 3, "FSSF"),
    ("DDIM", 4, "FSSF", "FSSF"),
    ("DDIM", 4, "FSFF", "FSFF"),
    ("PNDM", 4, "FSFSF", "FSFSF"),
    ("EulerA", 8, 2, "FSFSFSFS"),
])
def test_deep_cache_stamp_matches_jax(sides, name, steps, spec, schedule):
    got, want, port_stamp = run_both(sides, name, steps, spec)
    assert "".join(k[0].upper() for k in port_stamp.schedule) == schedule
    assert_u8_close(got, want)


def test_deep_cache_stamp_differs_from_exact(sides):
    """The shallow calls change the stamp (the cache is used)."""
    _, _, port, _ = sides
    canvas, brush, cond, uncond = stamp_inputs(3)
    enc, init, _ = jax_draws(KEY, 5, 4)
    outs = [t_inpaint.make_stamp_fn(*port, 4, SCALE, "DDIM",
                                    deep_cache_interval=spec)(
        torch.from_numpy(canvas), torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), 2.0, 1.0, 3, 150)[0]
        for spec in (1, "FSSF")]
    assert not torch.equal(*outs)


@pytest.mark.parametrize("spec,n_iters,final,want", [
    (1, 3, False, ("exact",) * 3),
    (1, 3, True, ("exact", "exact", "final")),
    (2, 5, False, ("full", "shallow", "full", "shallow", "full")),
    (2, 4, True, ("full", "shallow", "full", "final")),
    (4, 4, False, ("full", "shallow", "shallow", "shallow")),
    ("fssf", 4, True, ("full", "shallow", "shallow", "final")),
])
def test_model_call_schedule(spec, n_iters, final, want):
    assert t_inpaint.model_call_schedule(spec, n_iters, final) == want


@pytest.mark.parametrize("spec,n_iters,final,match", [
    ("SFFF", 4, False, "must start with 'F'"),
    ("FS", 4, False, "length"),
    ("FXFX", 4, False, "only 'F'/'S'"),
    ("FSFS", 4, True, "final step to be"),
    (0, 4, False, ">= 1"),
])
def test_model_call_schedule_refusals(spec, n_iters, final, match):
    """The JAX package's errors (_cache_flags, make_stamp_fn :132-147)."""
    with pytest.raises(ValueError, match=match):
        t_inpaint.model_call_schedule(spec, n_iters, final)


def test_final_step_needs_its_unet(sides):
    with pytest.raises(ValueError, match="unet_final"):
        t_inpaint.make_stamp_fn(*sides[2], 4, SCALE, "DDIM",
                                final_step_f32=True)


# --- sessions ---


def test_session_stamp_with_deep_cache_matches_jax(sides):
    params, models, port, _ = sides
    height, width, steps = 80, 112, 4
    jax_fn = jax.jit(j_session.make_session_stamp_fn(
        models, "DDIM", steps, deep_cache_interval="FSSF"))
    port_stamp = t_inpaint.make_stamp_fn(*port, steps, SCALE, "DDIM",
                                         deep_cache_interval="FSSF")
    _, brush, cond, uncond = stamp_inputs(6)
    canvas = np.zeros((height, width, 4), np.uint8)
    canvas[:24, :, :3] = np.random.default_rng(1).integers(
        0, 256, (24, width, 3))
    canvas[:24, :, 3] = 255
    counter, x0, y0 = 9, 30, 10
    new_j, comp_j = jax_fn(
        params, jnp.asarray(canvas), jnp.asarray(brush), jnp.asarray(cond),
        jnp.asarray(uncond), KEY, np.uint32(counter), np.int32(x0),
        np.int32(y0), np.float32(2.0), np.float32(1.0), np.int32(steps),
        np.int32(150), np.int32(0))
    enc, init, _ = jax_draws(KEY, counter, steps)
    canvas_t = torch.from_numpy(canvas.copy())
    comp = t_session.session_stamp(
        port_stamp, canvas_t, torch.from_numpy(brush),
        torch.from_numpy(cond), torch.from_numpy(uncond),
        torch.from_numpy(enc), torch.from_numpy(init), x0, y0, 2.0, 1.0,
        steps, 150, 0)
    assert_u8_close((comp,), (np.asarray(comp_j),))
    diff = np.abs(canvas_t.numpy().astype(int) - np.asarray(new_j))
    assert diff.max() <= 1 and (diff == 0).mean() >= 0.99


@pytest.fixture(scope="module")
def cached_model():
    return TorchConditionalInpainter(
        RES, device="cpu", tiny=True,
        config=t_config.PipelineConfig(deep_cache_interval=2,
                                       deep_cache_min_steps=4))


def test_session_stamp_follows_the_operating_point(cached_model):
    """A STAMP_AT runs the per-request path's schedule and draws: its crop
    equals generate_u8's stamp at the same request counter."""
    m = cached_model
    m.set_deep_cache("FSSF", min_steps=4)
    try:
        canvas = np.zeros((RES, RES, 4), np.uint8)
        canvas[:20, :, :3] = 90
        canvas[:20, :, 3] = 255
        m.request_counter = 20
        want = m.generate_u8(canvas, steps=4)
        m.begin_session(canvas)
        m.request_counter = 20
        got = m.stamp_at(0, 0, steps=4)
        m.end_session()
        np.testing.assert_array_equal(got, want)
        assert ("DDIM", 4, "FSSF", False) in m._stamp_fns
    finally:
        m.set_deep_cache(2, min_steps=4)


# --- the serving model's rules (tests/test_deep_cache.py) ---


def test_deep_cache_below_min_steps_disabled(cached_model):
    assert cached_model._cache_interval(2) == 1
    assert cached_model._cache_interval(4) == 2
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:16, :, 3] = 255
    cached_model.generate_u8(canvas, steps=2)
    assert ("DDIM", 2, 1, False) in cached_model._stamp_fns


def test_pattern_semantics(cached_model):
    """All-'F' is the exact stamp, 'FSFS' the interval-2 stamp (bit for
    bit: the same calls in the same order), 'FSSF' another schedule."""
    m = cached_model
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:16, :, :3] = 40
    canvas[:16, :, 3] = 255

    def run(spec):
        m.set_deep_cache(spec, min_steps=4)
        m.request_counter = 7
        return m.generate_u8(canvas, steps=4)

    try:
        exact, interval2 = run(1), run(2)
        np.testing.assert_array_equal(run("FFFF"), exact)
        np.testing.assert_array_equal(run("FSFS"), interval2)
        assert np.abs(run("FSSF").astype(int) - exact).max() > 0
    finally:
        m.set_deep_cache(2, min_steps=4)


def test_pattern_bypasses_min_steps(cached_model):
    m = cached_model
    try:
        m.set_deep_cache("FSFS", min_steps=8)
        assert m._cache_interval(4) == "FSFS"
        assert m._cache_interval(5) == 1  # another step count runs exact
        m.set_deep_cache(2, min_steps=8)
        assert m._cache_interval(4) == 1  # the gate holds for intervals
    finally:
        m.set_deep_cache(2, min_steps=4)


def test_pattern_matches_scheduler_iterations():
    """PNDM runs steps + 1 model calls: a 4-call pattern does not apply at
    4 steps, a 5-call one does."""
    m = TorchConditionalInpainter(
        RES, device="cpu", tiny=True,
        config=t_config.PipelineConfig(scheduler="PNDM",
                                       deep_cache_interval="FSSF"))
    assert m._cache_interval(4) == 1
    m.set_deep_cache("fssfs")
    assert m._cache_interval(4) == "FSSFS"
    assert m._stamp_fn(4).schedule == ("full", "shallow", "shallow",
                                       "full", "shallow")


@pytest.mark.parametrize("value", [0, -1, "0", "-1", "SFF", "FX", ""])
def test_parser_refuses_what_the_jax_parser_accepts_or_refuses(value):
    """The port refuses intervals below 1, which the JAX parser returns
    as they are (a fault the port must not copy), and the malformed
    patterns both refuse."""
    with pytest.raises(ValueError):
        t_config.parse_deep_cache_spec(value)
    if isinstance(value, int) or value.lstrip("-").isdigit():
        assert j_inpaint.parse_deep_cache_spec(value) == int(value)


def test_parser_accepts_what_the_jax_parser_accepts():
    for value in (1, 2, "3", "FSSF", "fsfs"):
        assert (t_config.parse_deep_cache_spec(value)
                == j_inpaint.parse_deep_cache_spec(value))


def test_model_refuses_intervals_below_one(cached_model):
    with pytest.raises(ValueError, match=">= 1"):
        TorchConditionalInpainter(
            RES, device="cpu", tiny=True,
            config=t_config.PipelineConfig(deep_cache_interval=0))
    with pytest.raises(ValueError, match=">= 1"):
        cached_model.set_deep_cache(-1)
    assert cached_model.config.deep_cache_interval == 2


# --- chip_smoke.py's launch counts, derived from the schedule ---


def _fake_model(name="default", res_dtype=torch.bfloat16, spec=1,
                final=False, scheduler="DDIM", unet_dtype=None):
    """What chip_smoke.expected_launches reads of a full-width model: the
    configurations, the components' dtypes and the stamp's schedule."""
    import types

    from diffusiontexturepainting_torch.schedulers import make_scheduler

    cfg = dataclasses.replace(t_config.pipeline_config(name),
                              scheduler=scheduler, deep_cache_interval=spec,
                              f32_final_step=final)
    ucfg = dataclasses.replace(
        t_config.UNetConfig(), fused_resnet=cfg.fused_unet_resnet,
        fused_ff=cfg.fused_unet_ff, fused_norm=cfg.fused_unet_norm,
        fused_attn=cfg.fused_unet_attn)

    def comp(c, dt):
        return types.SimpleNamespace(
            cfg=c, parameters=lambda: iter([torch.zeros(1, dtype=dt)]))

    def stamp_fn(steps):
        n = make_scheduler(scheduler).set_timesteps(steps).num_iterations()
        return types.SimpleNamespace(schedule=t_inpaint.model_call_schedule(
            spec, n, final))

    return types.SimpleNamespace(
        config=cfg, dtype=res_dtype, _stamp_fn=stamp_fn,
        unet=comp(ucfg, unet_dtype or res_dtype),
        vae_encoder=comp(t_config.VAEConfig(), res_dtype),
        vae_decoder=comp(t_config.VAEConfig(), res_dtype),
        final_unet=comp(dataclasses.replace(ucfg, **SAFE), torch.float32))


K = ("gn_conv_resident", "ff_geglu", "spatial_moments", "upsample2x_conv3x3",
     "flash_attention", "conv3x3", "gn_conv_stream", "upconv_stream",
     "downsample_conv3x3_stats")


@pytest.mark.parametrize("kw,res,steps,dtype,want", [
    # exact paths: PERF.md section 5's table, counted on the card
    (dict(), 256, 20, None, (1120, 320, 684, 60, 102, 0, 50, 3, 3)),
    (dict(name="safe_twin"), 256, 4, None, (0, 0, 0, 15, 22, 224, 0, 0, 0)),
    (dict(scheduler="PNDM"), 256, 20, None,
     (1176, 336, 718, 63, 107, 0, 50, 3, 3)),
    # DeepCache: 10 full and 10 shallow evals; 2 and 2 at 512^2
    (dict(spec=2), 256, 20, None, (690, 210, 424, 30, 102, 0, 50, 3, 3)),
    (dict(spec="FSSF"), 512, 4, None, (138, 42, 88, 6, 32, 0, 50, 3, 3)),
    # the f32 final step: 19 bf16 evals, one fp32 eval of the safe legs
    (dict(final=True), 256, 20, "bfloat16",
     (1064, 304, 650, 57, 97, 0, 50, 3, 3)),
    (dict(final=True), 256, 20, "float32", (0, 0, 0, 3, 5, 44, 0, 0, 0)),
    (dict(spec=2, final=True), 256, 20, "float32",
     (0, 0, 0, 3, 5, 44, 0, 0, 0)),
    # --f32-components unet: the UNet's kernels on their fp32 twins
    (dict(unet_dtype=torch.float32), 256, 4, "float32",
     (224, 64, 136, 12, 20, 0, 0, 0, 0)),
])
def test_smoke_counts_follow_the_schedule(kw, res, steps, dtype, want):
    import chip_smoke

    got = chip_smoke.expected_per_stamp(_fake_model(**kw), res, steps,
                                        dtype=dtype)
    assert tuple(got[k] for k in K) == want


@pytest.mark.parametrize("kind", ["full", "shallow"])
def test_smoke_eval_counts_match_the_modules_run(kind):
    """unet_eval_launches's structure against the modules a tiny fused UNet
    runs in forward_full / forward_shallow (forward hooks): resnets with
    and without a skip, transformers, upsamplers, self-attentions by
    length."""
    import collections

    import chip_smoke
    from diffusiontexturepainting_torch.models import layers

    cfg = _unet_cfg(t_config, **FUSED)
    unet = UNet2DCondition(cfg).eval()
    seen = collections.Counter()

    def hook(module, args, kwargs, out):
        if isinstance(module, layers.ResnetBlock):
            seen["skip" if kwargs.get("skip") is not None else "plain"] += 1
        elif isinstance(module, layers.Transformer2D):
            seen["transformers"] += 1
        elif isinstance(module, layers.Upsample):
            seen["upsample"] += 1

    for m in unet.modules():
        m.register_forward_hook(hook, with_kwargs=True)
    x, t, ctx = torch.zeros((3, 8, 8, 9)), torch.zeros(3), torch.zeros(
        (3, 14, 32))
    with torch.no_grad():
        _, cache = unet.forward_full(x, t, ctx)
        seen.clear()
        if kind == "full":
            unet.forward_full(x, t, ctx)
        else:
            unet.forward_shallow(x, t, ctx, cache)
    got = chip_smoke.unet_eval_launches(cfg, 8, torch.float32, kind)
    assert got["gn_conv_resident"] == 2 * seen["plain"] + 3 * seen["skip"]
    assert got["spatial_moments"] == seen["plain"] + 2 * seen["skip"]
    assert got["ff_geglu"] == seen["transformers"]
    assert got.get("upsample2x_conv3x3", 0) == seen["upsample"]
