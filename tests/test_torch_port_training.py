"""The port's train step (diffusiontexturepainting_torch/training/trainer.py)
against the JAX package's make_train_step, at the tiny configs on the CPU.

Both sides get the same weights (the JAX seeded init, converted), the same
LoRA factors (the JAX init, renamed), the same batch and the JAX step's own
draws (split(fold_in(PRNGKey(seed), step), 5): the two posterior samples'
noise, the noise, the offset noise, the timesteps), injected into the port.
Three option sets, one jitted JAX step each: epsilon; v-prediction with
min-SNR 5, noise offset 0.1 and a mixed drop_cond; a 2-step linear warm-up
with 2-step gradient accumulation. In fp32 each gives, within rtol 1e-4 and
atol 1e-6: the loss and the pre-clip grad_norm of four micro-steps, the
first micro-step's gradients of the LoRA factors and of the patch-encoder
head (read off the JAX optimizer state: Adam's mu / (1 - b1) scaled back
by the clip, or MultiSteps' accumulated mean after one micro-step, which
is the gradient). The trainables after the four micro-steps agree within
the same tolerance except where Adam divides a gradient by its own root
mean square: an element whose gradient is near zero (within a few fp32
roundings of the sums that make it) takes an update of size up to lr
whatever its rounding, so those elements are held to STEP_ATOL_LR * lr
instead, and their share to MAX_LOOSE_SHARE. In bf16 the first loss agrees with the
JAX bf16 loss within BF16_LOSS_RTOL.

The optimizer alone is also held against optax's chain on small trees
(eager, no models): clip on and off, the warm-up's lr 0 at the first
update, MultiSteps' mean and its emitting step. And the trainer's scope,
ops.conv3x3.conv_impl("plain"): every wrapper takes its plain version for
a non-CPU tensor inside it and its kernel route outside, per thread.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import optax
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.patch_encoder import (
    ConditionPatchEncoder)
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEEncoder
from diffusiontexturepainting_torch.ops import attention as t_attn
from diffusiontexturepainting_torch.ops import conv3x3 as t_conv
from diffusiontexturepainting_torch.ops import gn_conv as t_gn
from diffusiontexturepainting_torch.training import trainer as t_trainer
from diffusiontexturepainting_torch.weights.from_jax import (
    lora_from_jax,
    state_dict_from_jax,
)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import patch_encoder as j_pe
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.training import trainer as j_trainer
from tests.test_torch_port_modules import jax_init

torch.set_num_threads(2)

RES, B, SEED, STEPS = 64, 2, 5, 4
RTOL, ATOL = 1e-4, 1e-6
# bf16 on both sides rounds activations and weights differently (XLA's
# fused bf16 ops against PyTorch's per-op rounding); the loss is a mean
# over many elements, so it stays close
BF16_LOSS_RTOL = 1e-2
# the trainables after the micro-steps: elements outside (RTOL, ATOL) at
# most this share of all, each within this many learning rates
MAX_LOOSE_SHARE = 5e-3
STEP_ATOL_LR = 0.5

OPTIONS = {
    "epsilon": dict(cfg={}, drop=(0.0, 0.0)),
    "v_snr_offset": dict(cfg=dict(prediction_type="v_prediction",
                                  snr_gamma=5.0, noise_offset=0.1),
                         drop=(1.0, 0.0)),
    "warmup_accum": dict(cfg=dict(lr_warmup_steps=2,
                                  gradient_accumulation_steps=2),
                         drop=(0.0, 1.0)),
}


def jax_modules(dtype=jnp.float32):
    return (j_unet.UNet2DCondition(j_config.tiny_unet_config(), dtype=dtype),
            j_vae.VAEEncoder(j_config.tiny_vae_config(), dtype=dtype),
            j_pe.ConditionPatchEncoder(j_config.tiny_patch_encoder_config(),
                                       dtype=dtype))


@pytest.fixture(scope="module")
def params():
    ju, je, jp = jax_modules()
    pcfg = j_config.tiny_patch_encoder_config()
    lat = RES // 8
    return {
        "unet": jax_init(ju, jnp.zeros((1, lat, lat, 9)), jnp.float32(0.0),
                         jnp.zeros((1, 14, 32)), seed=1),
        "vae_encoder": jax_init(je, jnp.zeros((1, RES, RES, 3)), seed=2),
        "patch_encoder": jax_init(
            jp, jnp.zeros((1, pcfg.total_patches, pcfg.clip.image_size,
                           pcfg.clip.image_size, 3)),
            return_uncond_vector=True, seed=4),
    }


def make_batch(drop):
    rng = np.random.default_rng(7)
    image = rng.uniform(-1, 1, (B, RES, RES, 3)).astype(np.float32)
    mask = (rng.random((B, RES, RES, 1)) < 0.4).astype(np.float32)
    s = j_config.tiny_patch_encoder_config().clip.image_size
    return {"image": image, "mask": mask,
            "masked_image": image * (1.0 - mask),
            "cond_patches": rng.standard_normal((B, 14, s, s, 3))
            .astype(np.float32),
            "drop_cond": np.asarray(drop, np.float32)}


def jax_draws(step):
    """The JAX loss's draws at micro-step `step` (trainer.py:117, 183)."""
    rng = jax.random.fold_in(jax.random.PRNGKey(SEED), step)
    r_lat, r_noise, r_off, r_t, r_mask = jax.random.split(rng, 5)
    shape = (B, RES // 8, RES // 8, 4)
    draws = {
        "latent_noise": jax.random.normal(r_lat, shape, jnp.float32),
        "noise": jax.random.normal(r_noise, shape, jnp.float32),
        "offset_noise": jax.random.normal(r_off, (B, 1, 1, 4), jnp.float32),
        "timesteps": jax.random.randint(r_t, (B,), 0, 1000),
        "masked_latent_noise": jax.random.normal(r_mask, shape, jnp.float32),
    }
    return {k: torch.from_numpy(np.array(v)) for k, v in draws.items()}


def jax_grads(cfg, state, grad_norm):
    """The first micro-step's gradients from the JAX optimizer state."""
    if cfg.gradient_accumulation_steps > 1:
        return state.opt_state.acc_grads  # the mean of one micro-step
    mu = state.opt_state[1][0].mu  # (clip, (adam, decay, lr))
    scale = max(1.0, float(grad_norm) / cfg.max_grad_norm)
    return jax.tree_util.tree_map(
        lambda m: np.asarray(m) / (1 - cfg.adam_beta1) * scale, mu)


@pytest.fixture(scope="module", params=list(OPTIONS))
def jax_run(request, params):
    """(cfg, batch, per-step (loss, grad_norm), first-step grads, final
    trainables) of the JAX make_train_step, jitted once."""
    opts = OPTIONS[request.param]
    cfg = j_trainer.TrainConfig(resolution=RES, seed=SEED, **opts["cfg"])
    batch = make_batch(opts["drop"])
    ju, je, jp = jax_modules()
    head, clip = j_trainer.split_patch_encoder_params(params["patch_encoder"])
    frozen = {"unet": params["unet"], "vae_encoder": params["vae_encoder"],
              "clip": clip}
    state = j_trainer.create_train_state(cfg, params["unet"],
                                         params["patch_encoder"],
                                         lora_seed=0)
    lora0 = jax.tree_util.tree_map(np.array, state.trainable["lora"])
    step = jax.jit(j_trainer.make_train_step(cfg, ju, je, jp))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    metrics, grads = [], None
    for i in range(STEPS):
        state, m = step(state, frozen, jbatch, jax.random.PRNGKey(SEED))
        metrics.append((float(m["loss"]), float(m["grad_norm"])))
        if i == 0:
            grads = jax_grads(cfg, state, m["grad_norm"])
    final = jax.tree_util.tree_map(np.array, state.trainable)
    return dict(name=request.param, cfg=cfg, batch=batch, lora0=lora0,
                metrics=metrics, grads=grads, final=final)


def port_trainer(params, cfg, lora0, dtype=torch.float32):
    sds = {name: state_dict_from_jax(name, params[name])
           for name in ("unet", "vae_encoder", "patch_encoder")}
    models = {"unet": UNet2DCondition(t_config.tiny_unet_config()),
              "vae_encoder": VAEEncoder(t_config.tiny_vae_config()),
              "patch_encoder": ConditionPatchEncoder(
                  t_config.tiny_patch_encoder_config())}
    for name, m in models.items():
        m.load_state_dict(sds[name])
        m.to(dtype).eval()
    tcfg = t_trainer.TrainConfig(**dataclasses.asdict(cfg))
    return t_trainer.Trainer(tcfg, models, sds, "cpu", dtype,
                             lora=lora_from_jax(lora0))


def port_grads_as_jax(grads):
    """The port's flat gradients -> {"lora": {jax name: {down, up}},
    "patch_encoder": {torch name: tensor}} for comparison."""
    lora = {}
    for key, g in grads.items():
        if key.startswith("lora/"):
            _, name, part = key.split("/")
            lora.setdefault(name, {})[part] = g
    head = {k[len("patch_encoder/"):]: g for k, g in grads.items()
            if k.startswith("patch_encoder/")}
    return lora, head


def assert_trees_close(port_lora, port_head, jax_tree, what):
    want_lora = lora_from_jax(jax_tree["lora"])
    assert set(port_lora) == set(want_lora)
    for name, f in want_lora.items():
        for part in ("down", "up"):
            np.testing.assert_allclose(
                port_lora[name][part].detach().numpy(), f[part].numpy(),
                rtol=RTOL, atol=ATOL, err_msg=f"{what} lora {name} {part}")
    want_head = state_dict_from_jax("patch_encoder",
                                    jax_tree["patch_encoder"])
    assert set(port_head) == set(want_head)
    for k, v in want_head.items():
        np.testing.assert_allclose(port_head[k].detach().numpy(), v.numpy(),
                                   rtol=RTOL, atol=ATOL,
                                   err_msg=f"{what} head {k}")


def assert_trainables_close(trainer, jax_tree, cfg, what):
    want = {}
    for name, f in lora_from_jax(jax_tree["lora"]).items():
        for part in ("down", "up"):
            want[f"lora/{name}/{part}"] = f[part].numpy()
    for k, v in state_dict_from_jax("patch_encoder",
                                    jax_tree["patch_encoder"]).items():
        want[f"patch_encoder/{k}"] = v.numpy()
    assert set(want) == set(trainer.params)
    loose = total = 0
    for k, w in want.items():
        got = trainer.params[k].detach().numpy()
        diff = np.abs(got - w)
        loose += int((diff > ATOL + RTOL * np.abs(w)).sum())
        total += w.size
        assert diff.max() <= STEP_ATOL_LR * cfg.learning_rate, (what, k,
                                                                diff.max())
    assert loose <= MAX_LOOSE_SHARE * total, (what, loose, total)


def test_train_steps_match_jax(jax_run, params):
    """Loss and grad_norm of each micro-step, the first micro-step's
    gradients, the trainables after four micro-steps."""
    run = jax_run
    trainer = port_trainer(params, run["cfg"], run["lora0"])
    batch = {k: torch.from_numpy(v) for k, v in run["batch"].items()}
    _, grads = trainer.value_and_grad(batch, jax_draws(0))
    lora, head = port_grads_as_jax(grads)
    assert_trees_close(lora, head, {"lora": run["grads"]["lora"],
                                    "patch_encoder":
                                        run["grads"]["patch_encoder"]},
                       f"{run['name']} gradient")
    for i in range(STEPS):
        m = trainer.train_step(batch, jax_draws(i))
        np.testing.assert_allclose(
            [float(m["loss"]), float(m["grad_norm"])], run["metrics"][i],
            rtol=RTOL, atol=ATOL, err_msg=f"{run['name']} step {i}")
    assert_trainables_close(trainer, run["final"], run["cfg"],
                            f"{run['name']} after {STEPS} micro-steps")
    if run["cfg"].lr_warmup_steps:
        assert trainer.optimizer.state["lr_count"] == STEPS // 2
        assert trainer.optimizer.state["gradient_step"] == STEPS // 2


def test_train_step_launches_nothing_and_restores_scope(params):
    """The step runs in the plain scope, which it leaves as it found it;
    no wrapper counts a launch."""
    cfg = j_trainer.TrainConfig(resolution=RES, seed=SEED)
    lora0 = jax.tree_util.tree_map(
        np.array, j_trainer.create_train_state(
            cfg, params["unet"], params["patch_encoder"]).trainable["lora"])
    trainer = port_trainer(params, cfg, lora0)
    batch = {k: torch.from_numpy(v)
             for k, v in make_batch((0.0, 0.0)).items()}
    seen = []
    orig = t_trainer.Trainer.loss

    def spy(self, b, d):
        seen.append(t_conv.current_impl())
        return orig(self, b, d)

    t_trainer.Trainer.loss = spy
    try:
        before = t_conv.conv3x3_launches.launches
        m = trainer.train_step(batch)
    finally:
        t_trainer.Trainer.loss = orig
    assert seen == ["plain"] and t_conv.current_impl() is None
    assert t_conv.conv3x3_launches.launches == before
    assert np.isfinite(float(m["loss"])) and np.isfinite(
        float(m["grad_norm"]))


def test_bf16_loss_near_jax(params):
    """One bf16 loss (frozen towers cast once, merged projections and the
    head cast each step) against the JAX bf16 make_loss_fn on the same
    draws."""
    cfg = j_trainer.TrainConfig(resolution=RES, seed=SEED)
    ju, je, jp = jax_modules(jnp.bfloat16)
    state = j_trainer.create_train_state(cfg, params["unet"],
                                         params["patch_encoder"])
    head, clip = j_trainer.split_patch_encoder_params(params["patch_encoder"])
    frozen = {"unet": params["unet"], "vae_encoder": params["vae_encoder"],
              "clip": clip}
    batch = make_batch((1.0, 0.0))
    loss_fn = j_trainer.make_loss_fn(cfg, ju, je, jp)
    from diffusiontexturepainting_tpu.ops.conv3x3 import conv_impl

    def f(trainable, batch, rng):
        with conv_impl("xla"):
            return loss_fn(trainable, frozen, batch, rng)

    want = float(jax.jit(f)(state.trainable,
                            {k: jnp.asarray(v) for k, v in batch.items()},
                            jax.random.fold_in(jax.random.PRNGKey(SEED), 0)))
    lora0 = jax.tree_util.tree_map(np.array, state.trainable["lora"])
    trainer = port_trainer(params, cfg, lora0, torch.bfloat16)
    with torch.no_grad(), t_conv.conv_impl("plain"):
        got = float(trainer.loss({k: torch.from_numpy(v)
                                  for k, v in batch.items()}, jax_draws(0)))
    assert abs(got - want) <= BF16_LOSS_RTOL * abs(want), (got, want)


# --- the optimizer against optax, eager on small trees ---


def _tree(rng, scale):
    return {"a": (rng.standard_normal((3, 4)) * scale).astype(np.float32),
            "b": (rng.standard_normal((5,)) * scale).astype(np.float32)}


@pytest.mark.parametrize("opts", [
    dict(),  # gradients above the clip
    dict(max_grad_norm=100.0),  # below it
    dict(lr_warmup_steps=3),
    dict(gradient_accumulation_steps=3, lr_warmup_steps=2),
])
def test_optimizer_matches_optax(opts):
    cfg = j_trainer.TrainConfig(learning_rate=1e-2, **opts)
    rng = np.random.default_rng(0)
    p0 = _tree(rng, 1.0)
    tx = j_trainer.make_optimizer(cfg)
    jp = {k: jnp.asarray(v) for k, v in p0.items()}
    js = tx.init(jp)
    tp = {k: torch.from_numpy(v.copy()) for k, v in p0.items()}
    opt = t_trainer.Optimizer(t_trainer.TrainConfig(**dataclasses.asdict(
        cfg)), tp)
    for i in range(7):
        g = _tree(rng, 3.0)
        u, js = tx.update({k: jnp.asarray(v) for k, v in g.items()}, js, jp)
        jp = optax.apply_updates(jp, u)
        opt.step(tp, {k: torch.from_numpy(v) for k, v in g.items()})
        for k in p0:
            np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                       rtol=1e-6, atol=1e-7,
                                       err_msg=f"{opts} step {i} {k}")
        if i == 0 and cfg.lr_warmup_steps and \
                cfg.gradient_accumulation_steps == 1:
            for k in p0:  # lr 0 at the first update
                np.testing.assert_array_equal(tp[k].numpy(), p0[k])


# --- the trainer's scope: conv_impl("plain") ---


def _meta(*shape):
    return torch.empty(shape, device="meta")


SCOPED_CALLS = {
    "conv3x3": lambda: t_conv.conv3x3(_meta(1, 8, 8, 16), _meta(3, 3, 16, 8),
                                      _meta(8)),
    "upsample2x_conv3x3": lambda: t_conv.upsample2x_conv3x3(
        _meta(1, 4, 4, 16), _meta(3, 3, 16, 8), _meta(8), _meta(16, 16, 8)),
    "conv3x3_inpad": lambda: t_conv.conv3x3_inpad(
        _meta(1, 8, 8, 16), _meta(3, 3, 16, 8), _meta(8)),
    "gn_silu_conv3x3": lambda: t_conv.gn_silu_conv3x3(
        _meta(1, 8, 8, 16), _meta(16), _meta(16), _meta(3, 3, 16, 8),
        _meta(8), num_groups=4),
    "attention": lambda: t_attn.attention(_meta(1, 1024, 64),
                                          _meta(1, 1024, 64),
                                          _meta(1, 1024, 64), 2),
    "gn_conv_resident": lambda: t_gn.gn_conv_resident(
        _meta(1, 8, 8, 16), _meta(1, 16), _meta(1, 16), _meta(3, 3, 16, 8),
        _meta(8))[0],
    "upconv_stream": lambda: t_gn.upconv_stream(
        _meta(1, 4, 4, 16), _meta(3, 3, 16, 8), _meta(8),
        _meta(16, 16, 8))[0],
    "downconv_stream": lambda: t_gn.downconv_stream(
        _meta(1, 8, 8, 16), _meta(3, 3, 16, 8), _meta(8))[0],
}


@pytest.mark.parametrize("name", list(SCOPED_CALLS))
def test_plain_scope_routes_every_wrapper(name):
    """A tensor on neither the CPU nor a CUDA device stands in for a CUDA
    one: outside the scope the wrapper takes its kernel route (and refuses
    the device), inside it the plain version runs and counts nothing."""
    call = SCOPED_CALLS[name]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call()
    before = [c.launches for c in chip_counters()]
    with t_conv.conv_impl("plain"):
        out = call()
    assert out.device.type == "meta"
    assert [c.launches for c in chip_counters()] == before
    with pytest.raises(ValueError, match="CPU or CUDA"):
        call()


def chip_counters():
    return [t_conv.conv3x3_launches, t_conv.upsample_launches,
            t_conv.conv3x3_inpad_launches, t_conv.gn_silu_conv3x3_launches,
            t_attn.flash_launches, t_gn.gn_conv_resident_launches,
            t_gn.upconv_stream_launches, t_gn.downconv_stream_launches]


def test_plain_scope_attention_is_xla_attention_on_cpu():
    """Inside the scope a long self-attention is plain_attention (the JAX
    xla_attention, scores scaled in fp32); outside it the CPU takes the
    flash route's plain version, q pre-scaled and rounded."""
    gen = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(1, 1024, 64, generator=gen) for _ in range(3))
    with t_conv.conv_impl("plain"):
        inside = t_attn.attention(q, k, v, 2)
    assert torch.equal(inside, t_attn.plain_attention(q, k, v, 2))
    assert torch.equal(t_attn.attention(q, k, v, 2),
                       t_attn.plain_attention_streaming(q, k, v, 2))


@pytest.mark.parametrize("entry", ["stamp", "set_brush"])
def test_plain_scope_refuses_served_entry_points(entry):
    """A served stamp or brush encode inside the trainer's scope raises
    before it reaches a model: serving never swaps its kernels for the
    plain versions."""
    import types

    from diffusiontexturepainting_torch.pipeline.inpaint import make_stamp_fn
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    if entry == "stamp":
        stamp = make_stamp_fn(None, None, None, 4)
        call = lambda: stamp(*[None] * 10)  # noqa: E731
    else:
        call = lambda: TorchConditionalInpainter.set_brush(  # noqa: E731
            types.SimpleNamespace(), None)
    with t_conv.conv_impl("plain"):
        with pytest.raises(RuntimeError, match=f"{entry}: called inside"):
            call()
    with pytest.raises(Exception) as outside:
        call()  # outside the scope the call goes on to its dummy inputs
    assert "conv_impl" not in str(outside.value)


def test_plain_scope_is_per_thread_and_nests():
    import threading

    seen = []
    with t_conv.conv_impl("plain"):
        t = threading.Thread(target=lambda: seen.append(
            t_conv.current_impl()))
        t.start()
        t.join()
        with t_conv.conv_impl(None):
            assert t_conv.current_impl() is None
        assert t_conv.current_impl() == "plain"
    assert seen == [None] and t_conv.current_impl() is None
    with pytest.raises(ValueError, match="plain"):
        with t_conv.conv_impl("xla"):
            pass
