"""Checkpoints in the JAX package's format, read and written by the port.

Port of diffusiontexturepainting_tpu/weights/loader.py (numpy and torch
only). A checkpoint directory holds one `.npz` per component, keys the
'/'-joined flax parameter paths:

    unet.npz  vae_encoder.npz  vae_decoder.npz  patch_encoder.npz

Loading maps each component through from_jax.state_dict_from_jax and
validates it against the module's persistent state_dict (names, then
shapes) before any weight is copied; a missing file is logged and that
component gets the seeded random weights (random_init.py). Saving goes
back through from_jax.jax_tree_from_state_dict, in float32, after checking
the free space. The JAX package's load_pipeline_params(validate=True)
reads what save_pipeline_params writes here, and the other way round.
"""

from __future__ import annotations

import logging
import os
import shutil
import zipfile

import numpy as np
import torch

from .from_jax import jax_tree_from_state_dict, state_dict_from_jax

logger = logging.getLogger(__name__)

COMPONENTS = ("unet", "vae_encoder", "vae_decoder", "patch_encoder")


def flatten_params(params, prefix=""):
    out = {}
    for k, v in params.items():
        path = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            out.update(flatten_params(v, path))
        else:
            out[path] = np.asarray(v)
    return out


def unflatten_params(flat):
    tree = {}
    for path, v in flat.items():
        parts = path.split("/")
        node = tree
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = v
    return tree


def component_path(checkpoint_dir: str, name: str) -> str:
    return os.path.join(checkpoint_dir, f"{name}.npz")


def save_component(path: str, params) -> None:
    """One component's JAX parameter tree as an uncompressed npz."""
    np.savez(path, **flatten_params(params))


def load_component(path: str):
    with np.load(path) as data:
        return unflatten_params({k: data[k] for k in data.files})


def checkpoint_bytes(state_dicts: dict) -> int:
    """The float32 bytes of the arrays a checkpoint of `state_dicts`
    holds."""
    return sum(4 * t.numel() for sd in state_dicts.values()
               for t in sd.values())


def save_pipeline_params(checkpoint_dir: str, state_dicts: dict) -> int:
    """Write each component of `state_dicts` ({name: state_dict}) in the
    JAX package's format, float32; returns the bytes of the arrays. Raises
    OSError, before writing anything, where the directory's file system
    has less free space than that."""
    os.makedirs(checkpoint_dir, exist_ok=True)
    need = checkpoint_bytes(state_dicts)
    free = shutil.disk_usage(checkpoint_dir).free
    if free < need:
        raise OSError(f"checkpoint of {need} bytes does not fit in "
                      f"{checkpoint_dir} ({free} bytes free)")
    for name in COMPONENTS:
        if name in state_dicts:
            save_component(component_path(checkpoint_dir, name),
                           jax_tree_from_state_dict(name,
                                                    state_dicts[name]))
    return need


def validate_state_dict(name: str, sd: dict, module: torch.nn.Module):
    """Names, then shapes, of a loaded state_dict against `module`'s
    persistent state_dict (JAX loader.py _validate); ValueError naming the
    component and the first missing or extra keys."""
    ref = module.state_dict()
    missing = sorted(set(ref) - set(sd))
    extra = sorted(set(sd) - set(ref))
    if missing or extra:
        raise ValueError(
            f"checkpoint mismatch for {name}: missing={missing[:5]}... "
            f"extra={extra[:5]}... (counts {len(missing)}/{len(extra)})")
    for k, v in sd.items():
        if tuple(v.shape) != tuple(ref[k].shape):
            raise ValueError(f"{name}:{k} shape {tuple(v.shape)} != "
                             f"expected {tuple(ref[k].shape)}")


def load_pipeline_params(checkpoint_dir: str, modules: dict) -> dict:
    """{name: fp32 CPU state_dict, validated against modules[name]} for
    each component whose file is in `checkpoint_dir`; a component whose
    file is absent is left out, with a warning (the caller gives it the
    seeded random weights). Nothing is copied into the modules here."""
    out = {}
    for name in COMPONENTS:
        path = component_path(checkpoint_dir, name)
        if not os.path.exists(path):
            logger.warning("%s missing from %s - using random init", name,
                           path)
            continue
        try:
            sd = state_dict_from_jax(name, load_component(path))
        except (OSError, ValueError, KeyError, EOFError,
                zipfile.BadZipFile) as e:  # a truncated or corrupt npz
            raise ValueError(f"checkpoint {path} for {name} is unreadable: "
                             f"{type(e).__name__}: {e}") from e
        validate_state_dict(name, sd, modules[name])
        out[name] = sd
        logger.info("loaded %s from %s", name, path)
    return out
