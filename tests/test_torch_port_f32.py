"""The port's f32 operating points: the f32 final step and
--f32-components, at the tiny configs on the CPU.

- The final step's UNet (TorchConditionalInpainter.final_unet: the module
  legs in fp32 over the serving UNet's weights, upcast) against the JAX
  package's f32 safe UNet applied to the same parameters rounded to bf16
  (tpu_model.py's unet_final_apply over its bf16-cast tree), fp32: within
  the module tests' tolerance (atol and rtol 2e-4,
  tests/test_torch_port_modules.py).
- Whole stamps with final_step_f32 against jax.jit(make_stamp_fn(...,
  final_step_f32=True)) on the same weights and draws (the fixture of
  tests/test_torch_port_deep_cache.py): exact calls then the final one, an
  interval 2 at 4 steps (the last call naturally shallow, forced full) and
  FSSF: within 1 u8 level everywhere and at least 99% of pixels exact.
- The stamp's model calls: each kind reaches its callable in the
  schedule's order, the final one once, and every call runs with TF32 off
  (ieee_fp32).
- reload_params refreshes the final step's UNet: after a reload it holds
  the new weights and the stamp equals a fresh build's byte for byte.
- dtype_overrides (--f32-components): each component in its dtype, the
  fp32 ones holding the source weights and the others their bf16 rounding;
  unknown names refused; run.py's flags build that model.
"""

import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.pipeline import inpaint as t_inpaint
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.serving import run as t_run
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_torch.weights import loader as t_loader
from diffusiontexturepainting_torch.weights import random_init
from diffusiontexturepainting_torch.weights.from_jax import (
    state_dict_from_jax)
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.ops.conv3x3 import conv_impl
from tests.test_torch_port_deep_cache import (  # noqa: F401 - the fixture
    SAFE,
    run_both,
    sides,
)
from tests.test_torch_port_modules import assert_close, rand
from tests.test_torch_port_stamp import assert_u8_close

torch.set_num_threads(2)

RES = 64


def test_final_unet_matches_jax_over_bf16_params(sides):
    """The model keeps a bf16 UNet (dtype_overrides on the CPU) and its
    final_unet in fp32 over those weights upcast; JAX's f32 safe UNet on
    the bf16-cast tree computes the same eval."""
    sample, ctx = rand((3, 8, 8, 9), 0), rand((3, 14, 32), 1)
    t = np.array([981.0, 500.0, 1.0], np.float32)
    tree = sides[0]["unet"]
    model = TorchConditionalInpainter(
        RES, device="cpu", tiny=True,
        config=t_config.PipelineConfig(f32_final_step=True),
        weights={"unet": state_dict_from_jax("unet", tree)},
        dtype_overrides={"unet": torch.bfloat16})
    assert model.unet.conv_in.weight.dtype == torch.bfloat16
    final = model.final_unet
    assert all(p.dtype == torch.float32 for p in final.parameters())
    assert not (final.cfg.fused_resnet or final.cfg.fused_ff
                or final.cfg.fused_norm or final.cfg.fused_attn)
    for name, p in model.unet.state_dict().items():
        assert torch.equal(final.state_dict()[name], p.float()), name

    bf16_tree = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                       tree)
    ju = j_unet.UNet2DCondition(
        dataclasses.replace(j_config.tiny_unet_config(), **SAFE),
        dtype=jnp.float32)
    with conv_impl("xla"):
        want = jax.jit(lambda p, s, t, c: ju.apply({"params": p}, s, t, c))(
            bf16_tree, jnp.asarray(sample), jnp.asarray(t), jnp.asarray(ctx))
    with torch.no_grad():
        got = final(torch.from_numpy(sample), torch.from_numpy(t),
                    torch.from_numpy(ctx))
    assert got.dtype == torch.float32
    assert_close(got, want)


@pytest.mark.parametrize("spec,schedule", [
    (1, ("exact", "exact", "exact", "final")),
    (2, ("full", "shallow", "full", "final")),
    ("FSSF", ("full", "shallow", "shallow", "final")),
])
def test_final_step_stamp_matches_jax(sides, spec, schedule):
    got, want, port_stamp = run_both(sides, "DDIM", 4, spec,
                                     final_step_f32=True, seed=4, counter=8)
    assert port_stamp.schedule == schedule
    assert_u8_close(got, want)


class _Spy:
    """A UNet stand-in that logs each call's kind and TF32 setting."""

    def __init__(self, log, kind):
        self.log, self.kind = log, kind

    def __call__(self, sample, t, ctx, cache=None):
        self.log.append((self.kind, torch.backends.cudnn.allow_tf32,
                         torch.get_float32_matmul_precision()))
        eps = torch.zeros(sample.shape[:-1] + (4,))
        return (eps, torch.ones(1)) if self.kind == "full" else eps


@pytest.mark.parametrize("spec,final,want", [
    (1, False, "exact exact exact exact"),
    (2, True, "full shallow full final"),
    ("FSFF", True, "full shallow full final"),
    (3, False, "full shallow shallow full"),
])
def test_stamp_calls_follow_the_schedule(sides, spec, final, want):
    _, _, (_, enc_mod, dec_mod), _ = sides
    log = []
    stamp = t_inpaint.make_stamp_fn(
        _Spy(log, "exact"), enc_mod, dec_mod, 4, deep_cache_interval=spec,
        final_step_f32=final, unet_full=_Spy(log, "full"),
        unet_shallow=_Spy(log, "shallow"), unet_final=_Spy(log, "final"))
    lat = RES // 8
    saved = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        stamp(torch.zeros((1, RES, RES, 4), dtype=torch.uint8),
              torch.zeros((1, RES, RES, 3)), torch.zeros((1, 14, 32)),
              torch.zeros((1, 14, 32)), torch.zeros((2, lat, lat, 4)),
              torch.zeros((1, lat, lat, 4)), 2.0, 1.0, 4, 150)
        assert torch.backends.cudnn.allow_tf32  # put back after
    finally:
        torch.backends.cudnn.allow_tf32 = saved
    assert " ".join(kind for kind, _, _ in log) == want
    assert all(not tf32 and prec == "highest" for _, tf32, prec in log)


def test_ieee_fp32_restores_the_settings():
    saved = (torch.backends.cudnn.allow_tf32,
             torch.get_float32_matmul_precision())
    try:
        torch.backends.cudnn.allow_tf32 = True
        torch.set_float32_matmul_precision("high")
        with t_inpaint.ieee_fp32():
            assert not torch.backends.cudnn.allow_tf32
            assert torch.get_float32_matmul_precision() == "highest"
        assert torch.backends.cudnn.allow_tf32
        assert torch.get_float32_matmul_precision() == "high"
    finally:
        torch.backends.cudnn.allow_tf32 = saved[0]
        torch.set_float32_matmul_precision(saved[1])


def _canvas():
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:20, :, :3] = 120
    canvas[:20, :, 3] = 255
    return canvas


def test_reload_params_refreshes_the_final_unet(tmp_path):
    config = t_config.PipelineConfig(f32_final_step=True)
    other = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                      weights_seed=5)
    t_loader.save_pipeline_params(str(tmp_path), other.state_dicts())
    m = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                  config=config)
    before = {k: v.clone() for k, v in m.final_unet.state_dict().items()}
    m.reload_params(str(tmp_path))
    new = other.unet.state_dict()
    final = m.final_unet.state_dict()
    assert all(torch.equal(final[k], v.float()) for k, v in new.items())
    assert not all(torch.equal(before[k], final[k]) for k in new)
    fresh = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                      config=config,
                                      checkpoint_dir=str(tmp_path))
    np.testing.assert_array_equal(m.generate_u8(_canvas(), steps=3),
                                  fresh.generate_u8(_canvas(), steps=3))


def test_f32_final_step_refuses_an_s_terminated_pattern():
    """Refused at construction and at set_deep_cache, as the JAX model
    does, not in the request path."""
    with pytest.raises(ValueError, match="F'-terminated"):
        TorchConditionalInpainter(
            RES, device="cpu", tiny=True,
            config=t_config.PipelineConfig(f32_final_step=True,
                                           deep_cache_interval="FSFS"))
    m = TorchConditionalInpainter(
        RES, device="cpu", tiny=True,
        config=t_config.PipelineConfig(f32_final_step=True))
    with pytest.raises(ValueError, match="F'-terminated"):
        m.set_deep_cache("FFFS")
    assert m.config.deep_cache_interval == 1
    m.set_deep_cache("FSSF")
    assert m._stamp_fn(4).schedule[-1] == "final"


@pytest.mark.parametrize("names", [("unet",), ("vae_encoder", "vae_decoder"),
                                   ("patch_encoder",)])
def test_component_dtypes(names):
    """build_pipeline in bf16 with `names` overridden to fp32: those keep
    the source weights, the others their bf16 rounding."""
    models = random_init.build_pipeline(
        t_config.tiny_unet_config(), t_config.tiny_vae_config(),
        t_config.tiny_patch_encoder_config(), "cpu", torch.bfloat16,
        dtype_overrides={n: torch.float32 for n in names})
    source = {}
    gen = torch.Generator().manual_seed(0)
    for name, m in models.items():
        source[name] = random_init.random_state_dict(m, gen)
    random_init.load_weights(models, seed=0)
    for name, m in models.items():
        want = torch.float32 if name in names else torch.bfloat16
        sd = m.state_dict()
        for key, v in source[name].items():
            assert sd[key].dtype == want, (name, key)
            assert torch.equal(sd[key], v.to(want)), (name, key)


def test_unknown_component_refused():
    with pytest.raises(ValueError, match="unknown components"):
        random_init.build_pipeline(
            t_config.tiny_unet_config(), t_config.tiny_vae_config(),
            t_config.tiny_patch_encoder_config(), "cpu", torch.float32,
            dtype_overrides={"text_encoder": torch.float32})
    with pytest.raises(ValueError, match="unknown --f32-components"):
        t_run.parse_f32_components("unet,clip")
    with pytest.raises(SystemExit):
        t_run.make_parser().parse_args(["--f32-components", "unet,clip"])
    assert t_run.parse_f32_components(" unet , vae_decoder") == [
        "unet", "vae_decoder"]


def test_run_flags_build_the_operating_point():
    """build_server with --deep-cache-interval, --f32-final-step,
    --f32-components and a three-field warm-up point: the model's
    configuration and dtypes, the warm-up's key, and a stamp over the
    handler equal to one of a model built by hand."""
    server = t_run.build_server([
        "--host", "127.0.0.1", "--port", "0", "--device", "cpu", "--tiny",
        "--resolution", str(RES), "--deep-cache-interval", "fssf",
        "--f32-final-step", "--f32-components", "unet,patch_encoder",
        "--warmup-points", f"{RES}x4x2,{RES}x4"])
    try:
        m = server.model
        assert m.config.deep_cache_interval == "FSSF"
        assert m.config.f32_final_step
        assert m.dtype_overrides == {"unet": torch.float32,
                                     "patch_encoder": torch.float32}
        assert m.final_unet is not None
        assert set(server.startup) == {"model", f"{RES}x4x2", f"{RES}x4"}
        assert m.request_counter == 0
        assert ("DDIM", 4, 2, True) in m._stamp_fns
        assert m._stamp_fn(4).schedule == ("full", "shallow", "shallow",
                                           "final")
        raw = wire.encode_request(wire.RequestType.NEW_STAMP, _canvas(),
                                  steps=4, width=RES)
        got = wire.handle_request_bytes(m, raw)
        want = TorchConditionalInpainter(
            RES, device="cpu", tiny=True,
            config=t_config.PipelineConfig(deep_cache_interval="FSSF",
                                           f32_final_step=True))
        assert got == wire.handle_request_bytes(want, raw)
    finally:
        server.socket.close()
    for bad in (["--deep-cache-interval", "0"],
                ["--deep-cache-interval", "-2"],
                ["--deep-cache-interval", "SF"]):
        with pytest.raises(SystemExit):
            t_run.make_parser().parse_args(bad)
