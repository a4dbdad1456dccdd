"""The port's training entry point (diffusiontexturepainting_torch/training/
train.py main) on the CPU at the tiny models (--tiny --resolution 64
--train_batch_size 2), fp32, on a folder of seeded PNG textures.

- Two steps with a checkpoint, then a resume from "latest" to step 4, give
  trainables and an optimizer state bit-equal to an unbroken 4-step run
  (which also draws a validation grid every epoch: the grid touches
  neither the data stream nor the trainables); --checkpoints_total_limit
  keeps the newest.
- The export loads through the JAX package's load_pipeline_params
  (validate=True) and through the port's TorchConditionalInpainter; the
  unet carries the LoRA merged in fp32 and the patch encoder the trained
  head; a DDIM stamp the port serves from it equals the JAX stamp program
  on the same export within the stamp tests' tolerance.
- The multi-device flags raise SystemExit.
"""

import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.training import image_io, train
from diffusiontexturepainting_torch.weights.from_jax import state_dict_from_jax
from diffusiontexturepainting_tpu.core import config as j_config
from diffusiontexturepainting_tpu.models import patch_encoder as j_pe
from diffusiontexturepainting_tpu.models import unet as j_unet
from diffusiontexturepainting_tpu.models import vae as j_vae
from diffusiontexturepainting_tpu.pipeline import inpaint as j_inpaint
from diffusiontexturepainting_tpu.weights import loader as j_loader
from tests.test_torch_port_stamp import assert_u8_close, jax_draws

torch.set_num_threads(2)

RES, STEPS = 64, 4


@pytest.fixture(scope="module")
def textures(tmp_path_factory):
    d = tmp_path_factory.mktemp("textures")
    for i in range(4):
        rng = np.random.default_rng(i)
        y, x = np.mgrid[0:128, 0:128]
        a = np.stack([128 + 90 * np.sin(x / (5.0 + i) + c)
                      * np.cos(y / (8.0 + i) - c) for c in range(3)], -1)
        image_io.write_png(d / f"t{i}.png", np.clip(
            a + rng.integers(-20, 20, a.shape), 0, 255).astype(np.uint8))
    return str(d)


def argv(textures, out, *extra):
    return ["--images_path", textures, "--output_dir", str(out),
            "--device", "cpu", "--tiny", "--resolution", str(RES),
            "--train_batch_size", "2", "--checkpointing_steps", "2",
            "--log_every", "1", *extra]


def load_state(out, step):
    return torch.load(os.path.join(out, "checkpoints", str(step),
                                   train.CHECKPOINT_FILE),
                      map_location="cpu", weights_only=True)


@pytest.fixture(scope="module")
def runs(textures, tmp_path_factory):
    """(broken run dir, unbroken run dir, {run: main's step records}): 2
    steps then a resume to 4 with no validation, against 4 steps with a
    validation grid every epoch."""
    broken = tmp_path_factory.mktemp("broken")
    _, first = train.main(argv(textures, broken, "--max_train_steps", "2",
                               "--validation_epochs", "0"))
    _, second = train.main(argv(
        textures, broken, "--max_train_steps", "4", "--validation_epochs",
        "0", "--resume_from_checkpoint", "latest",
        "--checkpoints_total_limit", "1"))
    whole = tmp_path_factory.mktemp("whole")
    export, steps = train.main(argv(textures, whole, "--max_train_steps",
                                    "4"))
    assert export == os.path.join(str(whole), "export")
    return str(broken), str(whole), {"broken": first + second,
                                     "whole": steps}


def test_resume_is_bit_equal_to_an_unbroken_run(runs):
    broken, whole, _ = runs
    assert train.checkpoint_steps(os.path.join(broken, "checkpoints")) == [4]
    assert train.checkpoint_steps(os.path.join(whole, "checkpoints")) == [2, 4]
    a, b = load_state(broken, 4), load_state(whole, 4)
    assert a["step"] == b["step"] == 4
    assert set(a["params"]) == set(b["params"])
    for k in a["params"]:
        assert torch.equal(a["params"][k], b["params"][k]), k
    for k, v in a["optimizer"].items():
        if isinstance(v, dict):
            for n in v:
                assert torch.equal(v[n], b["optimizer"][k][n]), (k, n)
        else:
            assert v == b["optimizer"][k], k
    ups = {k: v for k, v in a["params"].items() if k.endswith("/up")}
    # 10 transformer blocks of the tiny UNet x 8 projections; every up
    # factor moved but the mid block's self-attention q and k: at 64 px
    # its image is one token, whose softmax is 1 whatever q and k are
    assert len(ups) == 80
    still = {k for k, v in ups.items() if not bool(v.abs().max() > 0)}
    mid = "lora/mid_block.attentions.0.transformer_blocks.0.attn1"
    assert still == {f"{mid}.to_q/up", f"{mid}.to_k/up"}


def test_main_returns_each_steps_metrics(runs):
    """main's records: one a step, in order, finite, the resumed run's
    losses and grad norms those of the unbroken run, the times rising."""
    history = runs[2]
    for run in ("broken", "whole"):
        assert [h["step"] for h in history[run]] == [1, 2, 3, 4], run
        times = [h["time"] for h in history[run]]
        assert times == sorted(times), times
        for h in history[run]:
            assert np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])
    for a, b in zip(history["broken"], history["whole"]):
        assert (a["loss"], a["grad_norm"]) == (b["loss"], b["grad_norm"])


def jax_modules():
    pcfg = j_config.tiny_patch_encoder_config()
    return (j_unet.UNet2DCondition(j_config.tiny_unet_config()),
            j_vae.VAEEncoder(j_config.tiny_vae_config()),
            j_vae.VAEDecoder(j_config.tiny_vae_config()),
            j_pe.ConditionPatchEncoder(pcfg))


def test_export_loads_in_both_packages_and_stamps_alike(runs):
    broken, whole, _ = runs
    export = os.path.join(whole, "export")
    assert sorted(os.listdir(export)) == sorted(
        f"{n}.npz" for n in ("unet", "vae_encoder", "vae_decoder",
                             "patch_encoder"))
    ju, je, jd, jp = jax_modules()
    params = j_loader.load_pipeline_params(export, ju, je, jd, jp,
                                           validate=True)
    model = TorchConditionalInpainter(
        RES, config=t_config.safe_twin_config(), device="cpu", tiny=True,
        checkpoint_dir=export)
    sds = model.state_dicts()
    for name in ("unet", "vae_encoder", "vae_decoder", "patch_encoder"):
        want = state_dict_from_jax(name, params[name])
        for k, v in want.items():
            assert torch.equal(sds[name][k], v), (name, k)
    # the trained pieces: the merged projections moved off the base, and
    # the export is the same from the resumed run
    state = load_state(whole, 4)
    head = {k.split("/", 1)[1]: v for k, v in state["params"].items()
            if k.startswith("patch_encoder/")}
    for k, v in head.items():
        assert torch.equal(sds["patch_encoder"][k], v), k
    other = TorchConditionalInpainter(
        RES, config=t_config.safe_twin_config(), device="cpu", tiny=True,
        checkpoint_dir=os.path.join(broken, "export"))
    for name, sd in other.state_dicts().items():
        for k, v in sd.items():
            assert torch.equal(v, sds[name][k]), (name, k)

    models = j_inpaint.StampModels(
        unet_apply=lambda p, s, t, c: ju.apply({"params": p}, s, t, c),
        vae_encode_apply=lambda p, x: je.apply({"params": p}, x),
        vae_decode_apply=lambda p, z: jd.apply({"params": p}, z),
        params=None, vae_scaling=0.18215)
    jax_stamp = jax.jit(j_inpaint.make_stamp_fn(models, "DDIM", STEPS))
    rng = np.random.default_rng(4)
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


def test_export_merges_the_lora_in_fp32(runs, textures, tmp_path):
    """The export's unet projections are W + up @ down of the fp32 base
    and the final factors; every other unet weight is the base's."""
    _, whole, _ = runs
    args = train.build_argparser().parse_args(argv(
        textures, whole, "--resume_from_checkpoint", "latest"))
    run = train.prepare(args)
    assert run.trainer.step == 4
    exported = state_dict_from_jax("unet", j_loader.load_component(
        os.path.join(whole, "export", "unet.npz")))
    base = run.weights["unet"]
    lora = run.trainer.lora()
    for name, f in lora.items():
        k = f"{name}.weight"
        want = base[k] + (f["up"] @ f["down"]).detach()
        assert torch.equal(exported[k], want), k
        moved = bool(f["up"].abs().max() > 0)  # see the resume test
        assert torch.equal(exported[k], base[k]) != moved, k
    for k, v in base.items():
        if k[:-len(".weight")] not in lora:
            assert torch.equal(exported[k], v), k


@pytest.mark.parametrize("flags", [
    ("--mesh_data", "2"), ("--mesh_model", "2"),
    ("--coordinator", "localhost:1234"), ("--num_processes", "2"),
    ("--process_id", "0"),
])
def test_multi_device_flags_raise(textures, tmp_path, flags):
    with pytest.raises(SystemExit, match="not ported yet"):
        train.main(argv(textures, tmp_path, "--max_train_steps", "1",
                        *flags))


def test_resolve_resume(tmp_path):
    assert train.resolve_resume(str(tmp_path), "latest") is None
    for step in (2, 10):
        os.makedirs(tmp_path / str(step))
        (tmp_path / str(step) / train.CHECKPOINT_FILE).write_bytes(b"")
    os.makedirs(tmp_path / "4")  # incomplete: no state file
    os.makedirs(tmp_path / ".tmp-6-1")
    assert train.checkpoint_steps(str(tmp_path)) == [2, 10]
    assert train.resolve_resume(str(tmp_path), "latest") == 10
    assert train.resolve_resume(str(tmp_path), "2") == 2
    assert train.resolve_resume(str(tmp_path), "4") is None
