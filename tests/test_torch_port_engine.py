"""The port's engine (core/engine.py): a stamp program per operating point,
captured as a CUDA graph on the card and run eagerly on its buffers here.

On the CPU, at the tiny configs, fp32, 4 DDIM steps:
- a program gives the direct stamp function's bytes, and agrees with the
  JAX package's Engine.stamp_fn (built with persistent_cache=False) within
  test_torch_port_stamp.py's tolerance, JAX's draws injected;
- one program fed three requests (cfg, tg_weight, tg_steps, pad, brush and
  counter changed) returns each request's own bytes, under DDIM and EulerA;
- the B = 1 body, its settings device tensors, equals the host-float body
  it replaced byte for byte;
- a B = 3 program with per-request settings equals stamp.batched;
- a model's session stamps, served through the engine, equal
  host_stamp_update of each eager stamp;
- load_state_dict rebuilds the upsamplers' taps, the slotted q/k/v and the
  VAE head's padded weight in place: the same data_ptr, the new values;
- TorchConditionalInpainter.warmup returns the JAX engine's keys.
The tests marked `cuda` skip here; on the card (`--noconftest`: the card has
no JAX, which this file imports only inside its CPU tests) they hold a
graph's replays against eager calls and the launch counters on a replay.
"""

import dataclasses

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.core.engine import Engine, Stamp
from diffusiontexturepainting_torch.models.layers import Attention, Upsample
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import (
    VAEDecoder,
    VAEEncoder,
    sample_latents,
)
from diffusiontexturepainting_torch.ops.gn_conv import pad_cout
from diffusiontexturepainting_torch.ops.morphology import add_extra_context
from diffusiontexturepainting_torch.ops.resize import nearest_downsample
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_torch.pipeline import session as t_session
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter,
)
from diffusiontexturepainting_torch.schedulers import make_scheduler
from diffusiontexturepainting_torch.weights.random_init import (
    random_state_dict,
)

torch.set_num_threads(2)

RES, STEPS, SCALE = 64, 4, 0.18215
LAT = RES // 8
# (cfg, tg_weight, tg_steps, context_pad) of three requests in a row
REQUESTS = [(2.0, 1.0, STEPS, 150), (3.5, 0.5, 2, 9), (1.25, 0.0, 0, 1)]


@pytest.fixture(scope="module")
def sides():
    """(JAX params, JAX StampModels, the port's (unet, encoder, decoder)),
    the same seeded weights on both sides."""
    import jax.numpy as jnp

    from diffusiontexturepainting_tpu.core import config as j_config
    from diffusiontexturepainting_tpu.models import unet as j_unet
    from diffusiontexturepainting_tpu.models import vae as j_vae
    from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
    from tests.test_torch_port_modules import jax_init, port_with

    ju = j_unet.UNet2DCondition(j_config.tiny_unet_config())
    vcfg = j_config.tiny_vae_config()
    je, jd = j_vae.VAEEncoder(vcfg), j_vae.VAEDecoder(vcfg)
    params = {
        "unet": jax_init(ju, jnp.zeros((1, LAT, LAT, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(je, jnp.zeros((1, RES, RES, 3)), seed=2),
        "vae_decoder": jax_init(jd, jnp.zeros((1, LAT, LAT, 4)), seed=3),
    }
    models = j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: je.apply({"params": p}, x),
        vae_decode_apply=lambda p, z: jd.apply({"params": p}, z),
        params=None, vae_scaling=SCALE)
    tv = t_config.tiny_vae_config()
    port = (
        port_with(UNet2DCondition(t_config.tiny_unet_config()), "unet",
                  params["unet"]),
        port_with(VAEEncoder(tv), "vae_encoder", params["vae_encoder"]),
        port_with(VAEDecoder(tv), "vae_decoder", params["vae_decoder"]))
    return params, models, port


@pytest.fixture(scope="module")
def jax_engine(sides):
    from diffusiontexturepainting_tpu.core.engine import Engine as JaxEngine

    return JaxEngine(sides[1], "DDIM", persistent_cache=False)


def canvas_u8(seed=0):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((1, RES, RES, 4), np.uint8)
    canvas[:, :20, :, :3] = rng.integers(0, 256, (1, 20, RES, 3))
    canvas[:, :20, :, 3] = 255
    canvas[:, 40:50, 30:60, :3] = 200
    canvas[:, 40:50, 30:60, 3] = 255
    return canvas


def request(seed, scheduler="DDIM", batch=1):
    """Seeded (canvas, brush, cond, uncond, enc_noise, init_latents,
    step_noise) tensors of `batch` requests; step_noise for EulerA."""
    rng = np.random.default_rng(seed)
    canvas = np.concatenate([canvas_u8(seed + b) for b in range(batch)])
    brush = rng.random((batch, RES, RES, 3)).astype(np.float32)
    cond = rng.standard_normal((batch, 14, 32)).astype(np.float32)
    uncond = rng.standard_normal((batch, 14, 32)).astype(np.float32)
    enc = rng.standard_normal((2 * batch, LAT, LAT, 4)).astype(np.float32)
    init = rng.standard_normal((batch, LAT, LAT, 4)).astype(np.float32)
    step = None
    if scheduler == "EulerA":
        step = torch.from_numpy(rng.standard_normal(
            (STEPS, batch, LAT, LAT, 4)).astype(np.float32))
    return [torch.from_numpy(a) for a in (canvas, brush, cond, uncond, enc,
                                          init)] + [step]


def served(port, scheduler="DDIM"):
    """(the eager stamp function, the engine's Stamp around it)."""
    fn = t_inpaint.make_stamp_fn(*port, STEPS, SCALE, scheduler)
    return fn, Stamp(Engine("cpu"), fn, (scheduler, STEPS, 1, False))


def stamp_args(req, settings):
    *tensors, step = req
    return (*tensors, *settings, step)


def test_program_equals_the_direct_stamp(sides):
    fn, stamp = served(sides[2])
    args = stamp_args(request(0), REQUESTS[0])
    for got, want in zip(stamp(*args), fn(*args)):
        assert torch.equal(got, want)
    assert list(stamp.engine.programs) == [("DDIM", RES, STEPS, 1, False, 1)]


def test_program_matches_the_jax_engine(sides, jax_engine):
    import jax
    import jax.numpy as jnp

    from tests.test_torch_port_stamp import assert_u8_close, jax_draws

    params = sides[0]
    _, stamp = served(sides[2])
    canvas, brush, cond, uncond, *_ = request(3)
    key, counter = jax.random.PRNGKey(42), 7
    cfg, tg, tg_steps, pad = REQUESTS[1]
    want = jax_engine.stamp_fn(RES, STEPS)(
        params, jnp.asarray(canvas.numpy()), jnp.asarray(brush.numpy()),
        jnp.asarray(cond.numpy()), jnp.asarray(uncond.numpy()), key,
        np.uint32(counter), np.float32(cfg), np.float32(tg),
        np.int32(tg_steps), np.int32(pad))
    enc, init = jax_draws(key, counter)
    got = stamp(canvas, brush, cond, uncond, torch.from_numpy(enc),
                torch.from_numpy(init), cfg, tg, tg_steps, pad)
    assert_u8_close(got, want)


@pytest.mark.parametrize("scheduler", ["DDIM", "EulerA"])
def test_three_requests_through_one_program(sides, scheduler):
    """cfg, tg_weight, tg_steps, pad, brush and draws (the counter) change
    between the calls; each result is its own request's, and every call
    ran the one program."""
    fn, stamp = served(sides[2], scheduler)
    outs = []
    for k, settings in enumerate(REQUESTS):
        args = stamp_args(request(10 + k, scheduler), settings)
        got = stamp(*args)
        want = fn(*args)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), k
        outs.append(got[1])
    assert len(stamp.engine.programs) == 1
    assert not torch.equal(outs[0], outs[1])


def host_float_stamp(port, canvas_u8, brush, cond, uncond, enc_noise,
                     init_latents, cfg, tg, tg_steps, pad, step_noise=None):
    """The B = 1 stamp as the port computed it before its settings became
    device tensors: cfg and each call's texture-guidance scale host floats,
    the context pad a host integer (index_select bounds), DDIM."""
    unet, vae_encoder, vae_decoder = port
    scheduler = make_scheduler("DDIM").set_timesteps(STEPS)
    with torch.inference_mode():
        canvas = canvas_u8.float() / 255.0
        images = canvas[..., :3] * 2.0 - 1.0
        mask = canvas[..., 3:4]
        masked_images = images * mask
        ctx_masked, ctx_mask = add_extra_context(
            brush.float() * 2.0 - 1.0, masked_images, mask, int(pad))
        m_lat = nearest_downsample(1.0 - mask, 8)
        cm_lat = nearest_downsample(1.0 - ctx_mask, 8)
        mask_lat = torch.cat([m_lat, m_lat, cm_lat], dim=0)
        moments = vae_encoder(torch.cat([masked_images, ctx_masked], dim=0))
        lat = sample_latents(moments, enc_noise) * SCALE
        masked_latents = torch.cat([lat[:1], lat[:1], lat[1:]], dim=0)
        embeddings = torch.cat([uncond.float(), cond.float(), cond.float()],
                               dim=0)
        latents = init_latents.float() * scheduler.init_noise_sigma
        state = scheduler.init_state(latents)
        for i, row in enumerate(scheduler.rows()):
            lat_in = scheduler.scale_model_input(
                torch.cat([latents] * 3, dim=0), row)
            unet_in = torch.cat([lat_in, mask_lat, masked_latents], dim=-1)
            t = torch.full((3,), float(row["timestep"]))
            eps_u, eps_c, eps_tg = unet(unet_in, t, embeddings).chunk(3)
            scale = float(np.float32(tg)) if i < int(tg_steps) else 0.0
            eps = (eps_u + float(np.float32(cfg)) * (eps_c - eps_u)
                   + scale * (eps_tg - eps_c))
            latents, state = scheduler.step(eps, latents, row, state, None)
        result = torch.clamp(vae_decoder(latents / SCALE) / 2.0 + 0.5, 0.0,
                             1.0)
        composited = canvas[..., :3] * mask + result * (1.0 - mask)
        return (t_inpaint._to_u8(result)[0],
                t_inpaint._to_u8(composited)[0])


@pytest.mark.parametrize("settings", REQUESTS)
def test_tensor_settings_body_equals_the_host_float_body(sides, settings):
    fn, stamp = served(sides[2])
    args = stamp_args(request(20), settings)
    want = host_float_stamp(sides[2], *args)
    for got in (fn(*args), stamp(*args)):
        assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_batch_of_three_program_equals_batched(sides):
    fn, stamp = served(sides[2])
    req = request(30, batch=3)
    settings = [list(v) for v in zip(*REQUESTS)]
    got = stamp.batched(*stamp_args(req, settings))
    want = fn.batched(*stamp_args(req, settings))
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert list(stamp.engine.programs) == [("DDIM", RES, STEPS, 1, False, 3)]
    # a request of the batch is not its neighbour's
    assert not torch.equal(got[1][0], got[1][1])


@pytest.fixture(scope="module")
def model():
    return TorchConditionalInpainter(RES, device="cpu", tiny=True)


def test_session_stamps_through_the_engine_equal_host_stamp_update(model):
    """Stamps into a resident 112x80 canvas (one overpainting, one clamped,
    settings changing) through the engine's program; the fetched canvas
    equals the host oracle: each stamp's crop through the eager stamp
    function at its request counter, written by host_stamp_update."""
    rng = np.random.default_rng(5)
    canvas = rng.integers(0, 256, (80, 112, 4), dtype=np.uint8)
    canvas[..., 3] = np.where(canvas[..., 3] > 128, 255, 0)
    stamps = [(0, 0, False, REQUESTS[0]), (30, 10, True, REQUESTS[1]),
              (100, 70, False, REQUESTS[2])]
    model.begin_session(canvas)
    try:
        counters = []
        for x0, y0, overpaint, (cfg, tg, tg_steps, pad) in stamps:
            counters.append(model.request_counter + 1)
            assert model.stamp_at(x0, y0, return_pixels=False,
                                  overpaint=overpaint, steps=STEPS,
                                  cfg_weight=cfg, tg_weight=tg,
                                  tg_steps=tg_steps, context_pad=pad) is None
        got = model.fetch_canvas()
    finally:
        model.end_session()
    eager = model._stamp_fn(STEPS).eager
    want = canvas.copy()
    for (x0, y0, overpaint, settings), counter in zip(stamps, counters):
        x, y = t_session.clamped_corner(x0, y0, RES, 112, 80)
        crop = want[y:y + RES, x:x + RES].copy()
        if overpaint:
            m = t_session.overpaint_margin(RES)
            crop[m:RES - m, m:RES - m] = 0
        enc, init, step = model.draws(counter, RES, STEPS)
        _, comp = eager(torch.from_numpy(crop)[None], model._brush,
                        model._cond, model._uncond, enc, init,
                        *(float(v) for v in settings[:2]),
                        *(int(v) for v in settings[2:]), step)
        want = t_session.host_stamp_update(want, comp.numpy(), x0, y0)
    np.testing.assert_array_equal(got, want)
    key = ("DDIM", RES, STEPS, 1, False, 1)
    assert key in model.engine.programs


def _derived(unet, decoder):
    """The derived tensors a stamp reads: every Upsample's taps, every
    slotted attention's q/k/v and output weights, the VAE head's padded
    weight and bias."""
    out = {}
    for name, m in unet.named_modules():
        if isinstance(m, Upsample):
            out[f"{name}.taps"] = m.taps
        if isinstance(m, Attention) and m.slotted:
            for k in ("qkv_slotted", "out_slotted", "qkv_bias_slotted"):
                if hasattr(m, k):
                    out[f"{name}.{k}"] = getattr(m, k)
    for name, m in decoder.named_modules():
        if getattr(m, "conv_out_w8", None) is not None:
            out[f"{name}.conv_out_w8"] = m.conv_out_w8
            out[f"{name}.conv_out_b8"] = m.conv_out_b8
    return out


def test_load_rebuilds_derived_weights_in_place():
    ucfg = dataclasses.replace(t_config.tiny_unet_config(), fused_attn=True)
    unet = UNet2DCondition(ucfg).eval()
    decoder = VAEDecoder(t_config.tiny_vae_config(), fused=True).eval()
    before = _derived(unet, decoder)
    assert any(k.endswith(".taps") for k in before)
    assert any(k.endswith("qkv_slotted") for k in before)
    assert any(k.endswith("conv_out_w8") for k in before)
    ptrs = {k: t.data_ptr() for k, t in before.items()}
    olds = {k: t.clone() for k, t in before.items()}
    gen = torch.Generator().manual_seed(7)
    for module in (unet, decoder):
        sd = random_state_dict(module, gen)
        # random_state_dict zeroes biases: give them values too
        for k, v in sd.items():
            if k.endswith("bias"):
                v.normal_(0.0, 0.1, generator=gen)
        module.load_state_dict(sd)
    after = _derived(unet, decoder)
    assert {k: t.data_ptr() for k, t in after.items()} == ptrs
    for name, m in unet.named_modules():
        if isinstance(m, Upsample):
            assert torch.equal(m.taps, m._fold())
        if isinstance(m, Attention) and m.slotted:
            for k, v in m._slot_weights().items():
                assert torch.equal(getattr(m, k), v)
    for name, m in decoder.named_modules():
        if getattr(m, "conv_out_w8", None) is not None:
            w8, b8 = pad_cout(m.conv_out.weight, m.conv_out.bias)
            assert torch.equal(m.conv_out_w8, w8)
            assert torch.equal(m.conv_out_b8, b8)
    assert all(not torch.equal(after[k], olds[k]) for k in after)


def test_warmup_returns_the_jax_engines_keys(sides, jax_engine, model):
    """The JAX engine keys a point (res, steps, DeepCache spec); the port's
    model keys a point as it was given: the same key where the point names
    its spec, the JAX key without the spec where it does not."""
    import jax.numpy as jnp

    params = sides[0]
    want = jax_engine.warmup(params, (14, 32), [(RES, STEPS)], RES,
                             uncond_dtype=jnp.float32)
    assert list(want) == [(RES, STEPS, 1)]
    counter = model.request_counter
    got = model.warmup([(RES, STEPS, 1), (RES, STEPS)])
    assert list(got) == [(RES, STEPS, 1), (RES, STEPS)]
    assert (RES, STEPS, 1) in want and (RES, STEPS, 1)[:2] == (RES, STEPS)
    assert all(s > 0 for s in got.values())
    assert model.request_counter == counter
    # no graphs on the CPU: nothing captured
    assert model.warmup_captures == {} and model.engine.captures == {}


# --- on the card ---


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.Generator(device="cuda").manual_seed(0)


def _conv_program(engine):
    from diffusiontexturepainting_torch.ops.conv3x3 import conv3x3

    return engine.program(("conv",), lambda x, w, b: (conv3x3(x, w, b),))


def _conv_inputs(gen, scale):
    x = torch.randn((2, 16, 16, 64), generator=gen, device="cuda") * scale
    w = torch.randn((3, 3, 64, 64), generator=gen, device="cuda") / 24
    b = torch.randn((64,), generator=gen, device="cuda")
    return x.bfloat16(), w.bfloat16(), b.bfloat16()


@pytest.mark.cuda
def test_graph_replays_equal_eager_calls_on_the_card():
    """K7 captured in a program: three inputs in a row, each replay
    bit-equal to the eager wrapper on the same input."""
    from diffusiontexturepainting_torch.ops.conv3x3 import conv3x3

    gen = _card()
    prog = _conv_program(Engine("cuda"))
    for scale in (1.0, 0.5, 3.0):
        args = _conv_inputs(gen, scale)
        (got,) = prog(*args)
        assert torch.equal(got, conv3x3(*args))
    assert prog.graph is not None and prog.replays == 3


@pytest.mark.cuda
def test_replay_counts_its_launches_on_the_card():
    """The capture and its eager pass count nothing; each replay adds what
    one call counts (launches, shapes, dtypes)."""
    from diffusiontexturepainting_torch.ops.conv3x3 import conv3x3_launches

    gen = _card()
    prog = _conv_program(Engine("cuda"))
    args = _conv_inputs(gen, 1.0)
    conv3x3_launches.reset()
    prog(*args)
    once = conv3x3_launches.snapshot()
    assert once[0] == 1 and sum(once[3].values()) == 1
    prog(*args)
    assert conv3x3_launches.launches == 2
    assert conv3x3_launches.dtypes == {"bfloat16": 2}
    assert sum(conv3x3_launches.shapes.values()) == 2
