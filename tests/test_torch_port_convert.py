"""The port's converter (diffusiontexturepainting_torch/weights/convert.py)
against the JAX package's (diffusiontexturepainting_tpu/weights/convert.py),
at small widths on the CPU, fp32. The reference's artifacts are written
from seeded port modules with chip_smoke.py's writers (torch layouts,
AutoencoderKL names old and new, image_encoder.pth with its CLIP tower in
OpenAI or Hugging Face naming, an attn-procs LoRA, a CLIPTextModel file);
nothing is downloaded.

- Each component and naming variant: the port's npz arrays equal the JAX
  converter's bit for bit, apart from the one documented
  path (the patch encoder's GELU projection, `ff/net_0` here, `ff/net_0/
  proj` there); and the port's result is the port state_dict the artifact
  was written from.
- The JAX loader (validate=True) accepts the port's converted checkpoint,
  and refuses the JAX converter's patch encoder.
- merge_lora_state_dict is the JAX merge bit for bit at scale 0.75 over
  down, mid and up attentions, attn1 and attn2, all four projections;
  within rtol 1e-6 of the training merge (models/lora.py); a file with no
  recognized key raises, an unrecognized key beside good ones warns.
- The safetensors reader, run in a process where importing safetensors
  raises, equals safetensors.numpy / safetensors.torch for F32, F16 and
  BF16, and refuses other dtypes; a whole-module pickle is refused; fp16 and
  bf16 .bin files read as float32.
- Both CLIs on one narrow set of files at the CLI's default depths (the JAX
  main in-process, the port's in a process where jax and safetensors
  cannot be imported): equal output directories.
- Models loaded from the port-converted and the JAX-converted directories
  stamp byte-equal on the same injected draws.
"""

import logging
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from diffusiontexturepainting_torch.core import config as t_config
from diffusiontexturepainting_torch.models.clip_text import CLIPTextEncoder
from diffusiontexturepainting_torch.models.lora import merge_lora
from diffusiontexturepainting_torch.models.patch_encoder import (
    ConditionPatchEncoder)
from diffusiontexturepainting_torch.models.unet import UNet2DCondition
from diffusiontexturepainting_torch.models.vae import VAEDecoder, VAEEncoder
from diffusiontexturepainting_torch.weights import convert as t_conv
from diffusiontexturepainting_torch.weights import loader as t_loader
from diffusiontexturepainting_torch.weights.from_jax import (
    jax_tree_from_state_dict)
from diffusiontexturepainting_tpu.weights import convert as j_conv
from diffusiontexturepainting_tpu.weights import loader as j_loader

torch.set_num_threads(2)

REPO = Path(__file__).resolve().parent.parent
COMPONENTS = ("unet", "vae_encoder", "vae_decoder", "patch_encoder")
SCALE = 0.75

TINY_TEXT = t_config.CLIPTextConfig(vocab_size=1000, max_length=16,
                                    hidden_size=32, intermediate_size=64,
                                    num_layers=2, num_heads=2)
# the CLI's default depths (2 layers a block, 4 blocks, 12 CLIP layers, 4
# patch-encoder layers, 12 text layers) at narrow widths
NARROW = dict(
    unet=t_config.UNetConfig(block_out_channels=(32, 32, 64, 64),
                             layers_per_block=2, cross_attention_dim=32,
                             num_attention_heads=2, norm_num_groups=8),
    vae=t_config.VAEConfig(block_out_channels=(16, 16, 32, 32),
                           layers_per_block=2, norm_num_groups=8),
    patch=t_config.PatchEncoderConfig(
        cross_attention_dim=32, num_layers=4, hid_size=32, num_heads=2,
        clip=t_config.CLIPVisionConfig(image_size=32, patch_size=8,
                                       hidden_size=32, intermediate_size=64,
                                       num_layers=12, num_heads=2)),
    text=t_config.CLIPTextConfig(vocab_size=1000, hidden_size=32,
                                 intermediate_size=64, num_layers=12,
                                 num_heads=2))


def seeded(module, seed):
    """A random N(0, 1) value for every state_dict entry of `module` (norms
    and biases too, so no layout or name slip hides behind a constant)."""
    gen = torch.Generator().manual_seed(seed)
    return {k: torch.randn(v.shape, generator=gen)
            for k, v in module.state_dict().items()}


def numpy_sd(sd):
    return {k: (v.numpy() if isinstance(v, torch.Tensor) else v)
            for k, v in sd.items()}


def port_npz(component, sd):
    """The arrays the port writes for `component`, in file order."""
    return t_loader.flatten_params(jax_tree_from_state_dict(component, sd))


def assert_arrays_equal(got, want, component):
    """Array for array, bit for bit (the JAX package writes its files in
    sorted order, the port in module order); the JAX converter's
    patch-encoder `ff/net_0/proj` read as the JAX module's `ff/net_0`."""
    want = j_loader.flatten_params(want)
    if component == "patch_encoder":
        want = {k.replace("ff/net_0/proj/", "ff/net_0/"): v
                for k, v in want.items()}
    assert sorted(got) == sorted(want)
    for k, g in got.items():
        w = np.asarray(want[k])
        assert g.dtype == w.dtype == np.float32 and g.shape == w.shape, k
        np.testing.assert_array_equal(g.view(np.uint32), w.view(np.uint32),
                                      err_msg=k)


@pytest.fixture(scope="module")
def tiny():
    """Seeded port state_dicts at the tiny configs."""
    t = t_config
    return dict(
        unet=seeded(UNet2DCondition(t.tiny_unet_config()), 0),
        vae_encoder=seeded(VAEEncoder(t.tiny_vae_config()), 1),
        vae_decoder=seeded(VAEDecoder(t.tiny_vae_config()), 2),
        patch_encoder=seeded(ConditionPatchEncoder(
            t.tiny_patch_encoder_config()), 3),
        text_encoder=seeded(CLIPTextEncoder(TINY_TEXT), 4))


def _case(tiny, case):
    """(component, reference file's state_dict, port convert fn, JAX convert
    fn, the port state_dict it must give back)."""
    component, _, variant = case.partition("-")
    sd = tiny[component]
    if component == "unet":
        return (component, cs.torch_layout(sd),
                lambda f: t_conv.convert_unet(f, 1, 4),
                lambda f: j_conv.convert_unet(f, 1, 4), sd)
    if component.startswith("vae"):
        half = component.split("_")[1]
        f = cs.autoencoder_kl(tiny["vae_encoder"], tiny["vae_decoder"],
                              old_attention=variant == "old")
        return (component, f,
                lambda f: getattr(t_conv, f"convert_vae_{half}")(f, 1, 4),
                lambda f: getattr(j_conv, f"convert_vae_{half}")(f, 1, 4),
                sd)
    if component == "patch_encoder":
        clip = None if variant == "none" else variant
        want = {k: v for k, v in sd.items()
                if clip or not k.startswith("clip.")}
        return (component, cs.image_encoder_file(sd, clip),
                lambda f: t_conv.convert_patch_encoder(f, 1, 2),
                lambda f: j_conv.convert_patch_encoder(f, 1, 2), want)
    return (component, cs.text_encoder_file(sd),
            lambda f: t_conv.convert_clip_text(f, num_layers=2),
            lambda f: j_conv.convert_clip_text(f, num_layers=2), sd)


CASES = ["unet", "vae_encoder-new", "vae_encoder-old", "vae_decoder-new",
         "vae_decoder-old", "patch_encoder-openai", "patch_encoder-hf",
         "patch_encoder-hf_layernorm", "patch_encoder-none", "text_encoder"]


@pytest.mark.parametrize("case", CASES)
def test_component_matches_jax_converter(tiny, case):
    component, f, ours, theirs, want = _case(tiny, case)
    got = ours(f)
    assert_arrays_equal(port_npz(component, got), theirs(numpy_sd(f)),
                        component)
    assert set(got) == set(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k


@pytest.mark.parametrize("naming", ["openai", "hf", "hf_layernorm"])
def test_clip_tower_matches_jax_converter(tiny, naming):
    """convert_clip_openai / convert_clip_hf on their own: the tower the
    patch encoder holds, under the JAX converter's paths."""
    f = cs.image_encoder_file(tiny["patch_encoder"], naming)
    if naming == "openai":
        got = t_conv.convert_clip_openai(f, "clip.visual", 2)
        want = j_conv.convert_clip_openai(numpy_sd(f), "clip.visual", 2)
    else:
        got = t_conv.convert_clip_hf(f, "clip.vision_model", 2)
        want = j_conv.convert_clip_hf(numpy_sd(f), "clip.vision_model", 2)
    tree = jax_tree_from_state_dict("patch_encoder",
                                    {f"clip.{k}": v for k, v in got.items()})
    assert_arrays_equal(t_loader.flatten_params(tree["clip"]), want, "clip")


def _jax_modules():
    from diffusiontexturepainting_tpu.core import config as j_config
    from diffusiontexturepainting_tpu.models import patch_encoder as j_pe
    from diffusiontexturepainting_tpu.models import unet as j_unet
    from diffusiontexturepainting_tpu.models import vae as j_vae

    return (j_unet.UNet2DCondition(j_config.tiny_unet_config()),
            j_vae.VAEEncoder(j_config.tiny_vae_config()),
            j_vae.VAEDecoder(j_config.tiny_vae_config()),
            j_pe.ConditionPatchEncoder(j_config.tiny_patch_encoder_config()))


def _tiny_files(tiny, lora):
    """The tiny artifacts (the UNet, the VAE in the old attention names,
    image_encoder.pth with an OpenAI tower) as state_dicts."""
    return dict(
        unet=cs.torch_layout(tiny["unet"]),
        vae=cs.autoencoder_kl(tiny["vae_encoder"], tiny["vae_decoder"],
                              old_attention=True),
        lora=lora,
        image_encoder=cs.image_encoder_file(tiny["patch_encoder"], "openai"))


def _write_port(directory, f):
    unet = t_conv.merge_lora_state_dict(t_conv.convert_unet(f["unet"], 1, 4),
                                        f["lora"], SCALE)
    sds = dict(unet=unet,
               vae_encoder=t_conv.convert_vae_encoder(f["vae"], 1, 4),
               vae_decoder=t_conv.convert_vae_decoder(f["vae"], 1, 4),
               patch_encoder=t_conv.convert_patch_encoder(
                   f["image_encoder"], 1, 2))
    os.makedirs(directory, exist_ok=True)
    for name, sd in sds.items():
        t_loader.save_component(t_loader.component_path(directory, name),
                                jax_tree_from_state_dict(name, sd))


def _write_jax(directory, f):
    f = {k: numpy_sd(v) for k, v in f.items()}
    unet = j_conv.merge_lora_state_dict(j_conv.convert_unet(f["unet"], 1, 4),
                                        f["lora"], SCALE)
    trees = dict(unet=unet,
                 vae_encoder=j_conv.convert_vae_encoder(f["vae"], 1, 4),
                 vae_decoder=j_conv.convert_vae_decoder(f["vae"], 1, 4),
                 patch_encoder=j_conv.convert_patch_encoder(
                     f["image_encoder"], 1, 2))
    os.makedirs(directory, exist_ok=True)
    for name, tree in trees.items():
        j_loader.save_component(os.path.join(directory, f"{name}.npz"), tree)


@pytest.fixture(scope="module")
def converted(tiny, tmp_path_factory):
    """(port-converted dir, JAX-converted dir) of the same tiny files."""
    f = _tiny_files(tiny, cs.lora_attn_procs(tiny["unet"], 4, seed=1))
    root = tmp_path_factory.mktemp("converted")
    _write_port(str(root / "port"), f)
    _write_jax(str(root / "jax"), f)
    return str(root / "port"), str(root / "jax")


def test_jax_loader_accepts_the_port_checkpoint(converted):
    """load_pipeline_params(validate=True) of the JAX package reads every
    component the port converted, the patch encoder included, with the
    arrays of the JAX converter's files; it refuses the JAX converter's
    patch encoder (its ff/net_0/proj)."""
    port_dir, jax_dir = converted
    params = j_loader.load_pipeline_params(port_dir, *_jax_modules(),
                                           validate=True)
    for name in COMPONENTS:
        want = j_loader.load_component(os.path.join(jax_dir, f"{name}.npz"))
        assert_arrays_equal(j_loader.flatten_params(params[name]), want,
                            name)
    with pytest.raises(ValueError, match="patch_encoder"):
        j_loader.load_pipeline_params(jax_dir, *_jax_modules(),
                                      validate=True)


def test_merge_lora_matches_jax_bit_for_bit(tiny):
    lora = cs.lora_attn_procs(tiny["unet"], 4, seed=2)
    names = {k.split(".processor.")[0] for k in lora}
    assert {n.split(".")[0] for n in names} == {"down_blocks", "mid_block",
                                                "up_blocks"}
    assert {n[-5:] for n in names} == {"attn1", "attn2"}
    assert {k.split(".processor.")[1].split("_lora")[0]
            for k in lora} == {"to_q", "to_k", "to_v", "to_out"}
    f = cs.torch_layout(tiny["unet"])
    got = t_conv.merge_lora_state_dict(t_conv.convert_unet(f, 1, 4), lora,
                                       SCALE)
    want = j_conv.merge_lora_state_dict(
        j_conv.convert_unet(numpy_sd(f), 1, 4), numpy_sd(lora), SCALE)
    assert_arrays_equal(port_npz("unet", got), want, "unet")
    merged = sum(not torch.equal(got[k], tiny["unet"][k]) for k in got)
    assert merged == len(lora) // 2


def test_merge_lora_agrees_with_the_training_merge(tiny):
    lora = cs.lora_attn_procs(tiny["unet"], 4, seed=3)
    got = t_conv.merge_lora_state_dict(
        t_conv.convert_unet(cs.torch_layout(tiny["unet"]), 1, 4), lora,
        SCALE)
    factors = {}
    for k, v in lora.items():
        block, rest = k.split(".processor.")
        target, factor = rest.split("_lora.")[0], rest.split(".")[1]
        name = f"{block}.{target}" + (".0" if target == "to_out" else "")
        factors.setdefault(name, {})[factor] = v
    want = merge_lora(tiny["unet"], factors, SCALE)
    assert len(want) == len(lora) // 2
    for k, w in want.items():
        np.testing.assert_allclose(got[k].numpy(), w.numpy(), rtol=1e-6,
                                   atol=0, err_msg=k)


def test_lora_file_without_a_recognized_key_raises(tiny, caplog):
    """The JAX converter merges nothing then (with warnings); the port
    refuses the file."""
    lora = {"unet.down.0.lora_A.weight": torch.ones(4, 32),
            "unet.down.0.lora_B.weight": torch.ones(32, 4)}
    unet = t_conv.convert_unet(cs.torch_layout(tiny["unet"]), 1, 4)
    with pytest.raises(ValueError, match="no LoRA key"):
        t_conv.merge_lora_state_dict(unet, lora, SCALE)
    tree = j_conv.convert_unet(numpy_sd(cs.torch_layout(tiny["unet"])), 1, 4)
    with caplog.at_level(logging.WARNING):
        j_conv.merge_lora_state_dict(tree, numpy_sd(lora), SCALE)
    assert "unrecognized LoRA key" in caplog.text
    assert_arrays_equal(port_npz("unet", unet), tree, "unet")


def test_unrecognized_lora_key_beside_good_ones_warns(tiny, caplog):
    lora = cs.lora_attn_procs(tiny["unet"], 4, seed=4)
    f = cs.torch_layout(tiny["unet"])
    want = t_conv.merge_lora_state_dict(t_conv.convert_unet(f, 1, 4), lora,
                                        SCALE)
    extra = {**lora, "text_encoder.lora.weight": torch.ones(2, 2)}
    with caplog.at_level(logging.WARNING,
                         logger="diffusiontexturepainting_torch"):
        got = t_conv.merge_lora_state_dict(t_conv.convert_unet(f, 1, 4),
                                           extra, SCALE)
    assert "unrecognized LoRA key text_encoder.lora.weight" in caplog.text
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("name", [
    "down_blocks.0.attentions.1.transformer_blocks.0.attn1.to_q",
    "mid_block.attentions.0.transformer_blocks.0.attn2.to_out",
    "up_blocks.3.attentions.2.transformer_blocks.0.attn2.to_v",
    "mid_block.attentions.1.transformer_blocks.0.attn1.to_k",
    "down_blocks.0.resnets.0.attn1.to_q",
    "text_model.encoder.layers.0.self_attn.to_q"])
def test_lora_targets_map_as_the_jax_converter_maps_them(name):
    """The port's weight for a LoRA target is the JAX converter's kernel
    path under from_jax's names; names outside the UNet's attentions raise
    KeyError on both sides."""
    from diffusiontexturepainting_torch.weights.from_jax import jax_path

    try:
        want = j_conv._torch_attn_path_to_ours(name)
    except KeyError:
        with pytest.raises(KeyError):
            t_conv._lora_target(name)
        return
    assert jax_path("unet", t_conv._lora_target(name), False) == \
        f"{want}/kernel"


# --- reading the files ---

ST_TENSORS = {
    "F32": (torch.float32, (3, 5)),
    "F16": (torch.float16, (4, 7)),
    "BF16": (torch.bfloat16, (2, 3, 4)),
}
READER = (
    "import sys\n"
    "sys.modules['safetensors'] = None\n"
    "import numpy as np\n"
    "from diffusiontexturepainting_torch.weights.convert import "
    "load_state_dict\n"
    "sd = load_state_dict(sys.argv[1])\n"
    "np.savez(sys.argv[2], **{k: v.numpy() for k, v in sd.items()})\n"
    "assert not [m for m in sys.modules if m.startswith('safetensors') "
    "and sys.modules[m] is not None]\n")


def _special(t):
    """Values that stress a reader: signed zeros, infinities, the smallest
    subnormal and the largest finite value of the dtype."""
    info = torch.finfo(t.dtype)
    flat = t.reshape(-1)
    flat[:6] = torch.tensor([0.0, -0.0, float("inf"), float("-inf"),
                             info.smallest_normal / 4, info.max],
                            dtype=torch.float32).to(t.dtype)
    return t


@pytest.fixture(scope="module")
def safetensors_read(tmp_path_factory):
    """(file, the port reader's arrays from a process where importing the
    safetensors package raises)."""
    from safetensors.torch import save_file

    gen = torch.Generator().manual_seed(0)
    sd = {k: _special((torch.randn(shape, generator=gen) * 3).to(dt))
          for k, (dt, shape) in ST_TENSORS.items()}
    sd["F16_scalar"] = torch.tensor(1.5, dtype=torch.float16)
    root = tmp_path_factory.mktemp("safetensors")
    path, out = str(root / "w.safetensors"), str(root / "read.npz")
    save_file(sd, path, metadata={"format": "pt"})
    subprocess.run([sys.executable, "-c", READER, path, out], check=True,
                   cwd=REPO, timeout=300)
    with np.load(out) as data:
        return path, {k: data[k] for k in data.files}


@pytest.mark.parametrize("kind", list(ST_TENSORS))
def test_safetensors_reader_matches_the_package(safetensors_read, kind):
    from safetensors.numpy import load_file as np_load
    from safetensors.torch import load_file as torch_load

    path, got = safetensors_read
    if kind == "BF16":
        want = torch_load(path)[kind].float().numpy()
    else:
        want = np_load(path)[kind].astype(np.float32)
        torch_want = torch_load(path)[kind].float().numpy()
        np.testing.assert_array_equal(want.view(np.uint32),
                                      torch_want.view(np.uint32))
    assert got[kind].dtype == np.float32 and got[kind].shape == want.shape
    np.testing.assert_array_equal(got[kind].view(np.uint32),
                                  want.view(np.uint32))
    if kind == "F16":
        assert got["F16_scalar"].shape == () and got["F16_scalar"] == 1.5


def test_safetensors_reader_refuses_other_dtypes(tmp_path):
    from safetensors.torch import save_file

    path = str(tmp_path / "ids.safetensors")
    save_file({"weight": torch.ones(2, 2),
               "text_model.embeddings.position_ids": torch.arange(4)[None]},
              path)
    with pytest.raises(ValueError, match="position_ids.*I64"):
        t_conv.load_state_dict(path)


def test_whole_module_pickle_is_refused(tmp_path):
    path = str(tmp_path / "image_encoder.pth")
    torch.save(torch.nn.Linear(2, 2), path)
    with pytest.raises(pickle.UnpicklingError):
        t_conv.load_state_dict(path)
    with pytest.raises(pickle.UnpicklingError):
        j_conv.load_state_dict(path)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_half_precision_bin_reads_as_float32(tmp_path, dtype):
    path = str(tmp_path / "unet.bin")
    gen = torch.Generator().manual_seed(5)
    torch.save({"conv_in.weight": torch.randn(8, 9, 3, 3, generator=gen)
                .to(dtype), "conv_in.bias": torch.randn(8).to(dtype)}, path)
    got = t_conv.load_state_dict(path)
    want = j_conv.load_state_dict(path)
    assert set(got) == set(want)
    for k, v in got.items():
        assert v.dtype == torch.float32
        np.testing.assert_array_equal(v.numpy().view(np.uint32),
                                      want[k].view(np.uint32))


# --- the command lines ---

PORT_CLI = (
    "import runpy, sys\n"
    "for m in ('jax', 'safetensors'):\n"
    "    sys.modules[m] = None\n"
    "sys.argv = ['convert'] + sys.argv[1:]\n"
    "runpy.run_module('diffusiontexturepainting_torch.weights.convert', "
    "run_name='__main__', alter_sys=True)\n"
    "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', "
    "'diffusiontexturepainting_tpu', 'safetensors') and sys.modules[m] is "
    "not None]\n"
    "assert not bad, bad\n")
CLI_OUT = ("unet", "vae_encoder", "vae_decoder", "patch_encoder",
           "text_encoder")


@pytest.fixture(scope="module")
def cli_dirs(tmp_path_factory):
    """One narrow set of the reference's files at the CLI's default depths,
    converted by the JAX main (in this process) and by the port's (in a
    process that cannot import jax or safetensors): (JAX out, port out,
    the port process's stdout)."""
    n = NARROW
    unet = seeded(UNet2DCondition(n["unet"]), 10)
    enc, dec = (seeded(VAEEncoder(n["vae"]), 11),
                seeded(VAEDecoder(n["vae"]), 12))
    patch = seeded(ConditionPatchEncoder(n["patch"]), 13)
    text = seeded(CLIPTextEncoder(n["text"]), 14)
    root = tmp_path_factory.mktemp("cli")
    src = root / "reference"
    src.mkdir()
    paths = dict(unet=src / "unet.bin", vae=src / "vae.safetensors",
                 lora=src / "pytorch_lora_weights.bin",
                 image_encoder=src / "image_encoder.pth",
                 text_encoder=src / "text_encoder.bin")
    torch.save(cs.torch_layout(unet), paths["unet"])
    cs.write_safetensors(str(paths["vae"]),
                         cs.autoencoder_kl(enc, dec, old_attention=True),
                         torch.float16)
    torch.save(cs.lora_attn_procs(unet, 4, seed=15), paths["lora"])
    torch.save(cs.image_encoder_file(patch, "openai"),
               paths["image_encoder"])
    torch.save({k: v.half() if v.is_floating_point() else v
                for k, v in cs.text_encoder_file(text).items()},
               paths["text_encoder"])
    args = ["--unet", paths["unet"], "--vae", paths["vae"], "--lora",
            paths["lora"], "--lora-scale", str(SCALE), "--image-encoder",
            paths["image_encoder"], "--text-encoder", paths["text_encoder"]]
    args = [str(a) for a in args]
    jax_out, port_out = str(root / "jax"), str(root / "port")
    j_conv.main(args + ["--out", jax_out])
    proc = subprocess.run([sys.executable, "-c", PORT_CLI, *args, "--out",
                           port_out], cwd=REPO, capture_output=True,
                          text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    return jax_out, port_out, proc.stdout


@pytest.mark.parametrize("component", CLI_OUT)
def test_cli_outputs_equal(cli_dirs, component):
    jax_out, port_out, _ = cli_dirs
    got = j_loader.load_component(os.path.join(port_out, f"{component}.npz"))
    want = j_loader.load_component(os.path.join(jax_out, f"{component}.npz"))
    assert_arrays_equal(j_loader.flatten_params(got), want, component)


def test_cli_writes_the_same_files_and_reports_them(cli_dirs):
    jax_out, port_out, stdout = cli_dirs
    assert sorted(os.listdir(port_out)) == sorted(os.listdir(jax_out)) == \
        sorted(f"{c}.npz" for c in CLI_OUT)
    for c in CLI_OUT:
        assert f"converted {c}: " in stdout
    assert f"wrote checkpoint components to {port_out}" in stdout


def test_converted_directories_stamp_byte_equal(converted):
    """Models loaded from the port-converted and the JAX-converted
    directories (the JAX one's patch encoder read through its ff/net_0/proj
    name): the same weights, brush tokens and stamp bytes on the same
    injected draws."""
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)

    models = [TorchConditionalInpainter(64, device="cpu", tiny=True,
                                        checkpoint_dir=d) for d in converted]
    a, b = (m.state_dicts() for m in models)
    for name in COMPONENTS:
        assert set(a[name]) == set(b[name])
        for k in a[name]:
            assert torch.equal(a[name][k], b[name][k]), (name, k)
    rng = np.random.default_rng(6)
    canvas = np.zeros((1, 64, 64, 4), np.uint8)
    canvas[:, :24, :, :3] = rng.integers(0, 256, (1, 24, 64, 3))
    canvas[:, :24, :, 3] = 255
    brush = rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
    enc = torch.from_numpy(rng.standard_normal((2, 8, 8, 4), np.float32))
    init = torch.from_numpy(rng.standard_normal((1, 8, 8, 4), np.float32))
    outs = []
    for m in models:
        _, brush_t, cond, uncond = m.encode_brush(brush)
        outs.append(m._stamp_fn(4)(torch.from_numpy(canvas), brush_t, cond,
                                   uncond, enc, init, 2.0, 1.0, 4, 150))
    for x, y in zip(*outs):
        assert torch.equal(x, y)
