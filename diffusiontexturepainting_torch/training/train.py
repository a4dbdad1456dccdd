"""Training entry point: LoRA + patch-encoder finetune on texture folders.

Port of diffusiontexturepainting_tpu/training/train.py for one process on
one device (the card unless --device cpu): the same flags and defaults,
the frozen towers seeded at random or read from --pretrained_dir (the JAX
package's npz format, weights/loader.py), a background batch prefetch,
checkpoints with bounded retention and resume ("latest" or a step), a
validation grid (a DDIM-20 stamp of the port's serving pipeline on the
current weights), tensorboard where it imports, optional wandb, and a
final export of serving-ready components in the JAX npz format (the UNet
LoRA-merged in fp32, the trained patch encoder), which
`serving.run --checkpoint_dir <output_dir>/export` serves.

Checkpoints are the port's own: output_dir/checkpoints/<step>/state.pt
holds the trainables, the optimizer state and the step, written to a
temporary directory and renamed into place. The data stream is a pure
function of (seed, batch index) and the step's draws of (seed, step), so a
resumed run continues as the unbroken one would have.

Data-parallel and mesh training (--mesh_data or --mesh_model above 1) and
the multi-host flags (--coordinator, --num_processes, --process_id) are
not ported yet: each raises SystemExit.

Usage:
    python -m diffusiontexturepainting_torch.training.train \\
        --images_path /data/textures --output_dir runs/tex1 \\
        --train_batch_size 32 --max_train_steps 15000
    # on the CPU at the tiny test models:
    python -m diffusiontexturepainting_torch.training.train --device cpu \\
        --tiny --resolution 64 --train_batch_size 2 --max_train_steps 4 \\
        --images_path DIR --output_dir OUT
"""

from __future__ import annotations

import argparse
import copy
import logging
import os
import random
import shutil
import time
from types import SimpleNamespace

import numpy as np
import torch

logger = logging.getLogger(__name__)

CHECKPOINT_FILE = "state.pt"


def _prefetch(it, depth: int = 2):
    """Background-thread batch prefetch (bounded queue): the next
    batch's host-side prep runs while the device executes the current
    step. Worker exceptions are re-raised at the consuming site."""
    import queue
    import threading

    q = queue.Queue(maxsize=depth)
    _end = object()

    def worker():
        try:
            for item in it:
                q.put(item)
            q.put(_end)
        except BaseException as e:  # noqa: BLE001 - surface in main thread
            q.put(e)

    threading.Thread(target=worker, daemon=True).start()
    while True:
        item = q.get()
        if item is _end:
            return
        if isinstance(item, BaseException):
            raise item
        yield item


def build_argparser():
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--images_path", required=True)
    p.add_argument("--output_dir", required=True)
    p.add_argument("--pretrained_dir", default=None,
                   help="dir with unet/vae/patch-encoder .npz (frozen towers)")
    p.add_argument("--resolution", type=int, default=256)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--learning_rate", type=float, default=1e-4)
    p.add_argument("--max_train_steps", type=int, default=15000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--lr_warmup_steps", type=int, default=0)
    p.add_argument("--lora_rank", type=int, default=4)
    p.add_argument("--snr_gamma", type=float, default=None)
    p.add_argument("--prediction_type", default="epsilon",
                   choices=["epsilon", "v_prediction"])
    p.add_argument("--noise_offset", type=float, default=0.0)
    p.add_argument("--cond_drop_prob", type=float, default=0.1)
    p.add_argument("--prob_no_mask", type=float, default=0.1)
    p.add_argument("--prob_empty_mask", type=float, default=0.2)
    p.add_argument("--num_images", type=int, default=-1)
    p.add_argument("--single_image", default=None)
    p.add_argument("--augment_data", action="store_true")
    p.add_argument("--checkpointing_steps", type=int, default=500)
    p.add_argument("--checkpoints_total_limit", type=int, default=None)
    p.add_argument("--resume_from_checkpoint", default=None,
                   help="'latest' or an explicit step number")
    p.add_argument("--validation_steps", type=int, default=0,
                   help="run a validation grid every N steps (0 = use "
                        "--validation_epochs)")
    p.add_argument("--validation_epochs", type=int, default=1,
                   help="run a validation grid every N epochs (reference "
                        "default: every epoch, train...py:749-782); "
                        "0 disables epoch-based validation")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mesh_data", type=int, default=None,
                   help="not ported yet: above 1 raises")
    p.add_argument("--mesh_model", type=int, default=1,
                   help="not ported yet: above 1 raises")
    p.add_argument("--max_grad_norm", type=float, default=1.0)
    p.add_argument("--tiny", action="store_true", help="tiny model (tests)")
    p.add_argument("--mixed_precision", choices=["bf16", "fp32"], default=None,
                   help="compute dtype (params stay f32); default bf16 on "
                        "CUDA, fp32 elsewhere")
    p.add_argument("--log_every", type=int, default=10)
    p.add_argument("--coordinator", default=None,
                   help="multi-host training: not ported yet, raises")
    p.add_argument("--num_processes", type=int, default=None,
                   help="multi-host training: not ported yet, raises")
    p.add_argument("--process_id", type=int, default=None,
                   help="multi-host training: not ported yet, raises")
    p.add_argument("--wandb", action="store_true",
                   help="also log metrics to Weights & Biases (reference "
                        "train...py:286-294; tensorboard stays on)")
    p.add_argument("--wandb_project", default="dtp-tpu")
    p.add_argument("--device", default="cuda",
                   help="the training device (cpu for debugging and tests)")
    return p


def _refuse_multi_device(args) -> None:
    if (args.mesh_data or 1) > 1 or args.mesh_model > 1:
        raise SystemExit(
            f"--mesh_data {args.mesh_data} / --mesh_model {args.mesh_model}: "
            "data-parallel and mesh training are not ported yet (one process "
            "on one device only)")
    for flag in ("coordinator", "num_processes", "process_id"):
        if getattr(args, flag) is not None:
            raise SystemExit(f"--{flag}: multi-host training is not ported "
                             "yet (one process on one device only)")


def build_models(tiny: bool, device, dtype):
    """The four components on `device` in the compute dtype, module legs
    (UNetConfig's fused_* False, VAEEncoder / VAEDecoder fused=False),
    weights not yet set (weights/random_init.build_pipeline)."""
    from ..core.config import (
        PatchEncoderConfig,
        UNetConfig,
        VAEConfig,
        tiny_patch_encoder_config,
        tiny_unet_config,
        tiny_vae_config,
    )
    from ..weights.random_init import build_pipeline

    if tiny:
        cfgs = (tiny_unet_config(), tiny_vae_config(),
                tiny_patch_encoder_config())
    else:
        cfgs = (UNetConfig(), VAEConfig(), PatchEncoderConfig())
    return build_pipeline(*cfgs, device=device, dtype=dtype)


def checkpoint_steps(ckpt_dir: str) -> list:
    """The steps of the complete checkpoints under `ckpt_dir`, ascending."""
    if not os.path.isdir(ckpt_dir):
        return []
    return sorted(int(d) for d in os.listdir(ckpt_dir) if d.isdigit()
                  and os.path.exists(os.path.join(ckpt_dir, d,
                                                  CHECKPOINT_FILE)))


def save_checkpoint(ckpt_dir: str, trainer, keep: int | None) -> str:
    """trainer.state_dict() to ckpt_dir/<step>/state.pt through a temporary
    directory renamed into place; then only the newest `keep` remain."""
    step = trainer.step
    final = os.path.join(ckpt_dir, str(step))
    tmp = os.path.join(ckpt_dir, f".tmp-{step}-{os.getpid()}")
    shutil.rmtree(tmp, ignore_errors=True)
    os.makedirs(tmp)
    torch.save(trainer.state_dict(), os.path.join(tmp, CHECKPOINT_FILE))
    shutil.rmtree(final, ignore_errors=True)
    os.replace(tmp, final)
    if keep is not None:
        for old in checkpoint_steps(ckpt_dir)[:-keep]:
            shutil.rmtree(os.path.join(ckpt_dir, str(old)))
    return final


def resolve_resume(ckpt_dir: str, which: str):
    """The checkpoint step `which` ('latest' or a number) names, or None
    where there is none."""
    steps = checkpoint_steps(ckpt_dir)
    if which == "latest":
        return steps[-1] if steps else None
    step = int(which)
    return step if step in steps else None


def prepare(args) -> SimpleNamespace:
    """Everything main() trains with, from its parsed arguments: the
    models (frozen weights loaded, cast once), the fp32 host weights, the
    Trainer (resumed where --resume_from_checkpoint finds a checkpoint),
    the dataset and the checkpoint directory."""
    _refuse_multi_device(args)
    from ..weights.loader import load_pipeline_params
    from ..weights.random_init import complete_weights
    from .dataset import AugmentedTextures
    from .trainer import Trainer, TrainConfig

    device = torch.device(args.device)
    dtype = {None: (torch.bfloat16 if device.type == "cuda"
                    else torch.float32),
             "bf16": torch.bfloat16, "fp32": torch.float32}[
        args.mixed_precision]
    cfg = TrainConfig(
        resolution=args.resolution, lora_rank=args.lora_rank,
        learning_rate=args.learning_rate, snr_gamma=args.snr_gamma,
        prediction_type=args.prediction_type, noise_offset=args.noise_offset,
        gradient_accumulation_steps=args.gradient_accumulation_steps,
        lr_warmup_steps=args.lr_warmup_steps,
        max_train_steps=args.max_train_steps, seed=args.seed,
        max_grad_norm=args.max_grad_norm)

    models = build_models(args.tiny, device, dtype)
    loaded = {}
    if args.pretrained_dir:
        loaded = load_pipeline_params(args.pretrained_dir, models)
    else:
        logger.warning("no --pretrained_dir: frozen towers are random "
                       "(smoke-training only)")
    weights = complete_weights(models, loaded, args.seed)
    for name, sd in weights.items():
        models[name].load_state_dict(sd)  # cast once to the compute dtype
    # fp32 host copies: the merge base of the export, the head's masters
    weights = {name: {k: v.detach().to("cpu", torch.float32)
                      for k, v in sd.items()} for name, sd in weights.items()}
    trainer = Trainer(cfg, models, weights, device, dtype)

    ckpt_dir = os.path.abspath(os.path.join(args.output_dir, "checkpoints"))
    os.makedirs(ckpt_dir, exist_ok=True)
    if args.resume_from_checkpoint:
        step = resolve_resume(ckpt_dir, args.resume_from_checkpoint)
        if step is not None:
            state = torch.load(os.path.join(ckpt_dir, str(step),
                                            CHECKPOINT_FILE),
                               map_location="cpu", weights_only=True)
            trainer.load_state_dict(state)
            logger.info("resumed from checkpoint step %d", step)
        else:
            logger.warning("no checkpoint found; starting fresh")

    pcfg = models["patch_encoder"].cfg
    dataset = AugmentedTextures(
        args.images_path, size=args.resolution,
        cond_size=pcfg.clip.image_size,
        cond_drop_prob=args.cond_drop_prob, prob_no_mask=args.prob_no_mask,
        prob_empty_mask=args.prob_empty_mask, num_images=args.num_images,
        single_image=args.single_image, augment=args.augment_data,
        num_patches=pcfg.num_patches, seed=args.seed)
    logger.info("dataset: %d images", len(dataset))
    return SimpleNamespace(trainer=trainer, models=models, weights=weights,
                           dataset=dataset, ckpt_dir=ckpt_dir)


def main(argv=None):
    """Train as the flags say; returns (the export directory, one record a
    step: {"step", "loss", "grad_norm", "time"}), "time" the
    time.perf_counter() reading when the step's host work was done (after
    its log line, whose read of the loss waits for the device)."""
    args = build_argparser().parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    from ..weights.loader import save_pipeline_params
    from .trainer import batch_to_device

    run = prepare(args)
    trainer, models, dataset = run.trainer, run.models, run.dataset
    device, start_step = trainer.device, trainer.step

    try:
        from torch.utils.tensorboard import SummaryWriter

        writer = SummaryWriter(os.path.join(args.output_dir, "logs"))
    except Exception:  # tensorboard not installed
        writer = None
    wandb_run = None
    if args.wandb:
        try:
            import wandb

            wandb_run = wandb.init(project=args.wandb_project,
                                   config=vars(args))
        except Exception as e:  # wandb not installed
            logger.warning("--wandb requested but unavailable: %s", e)

    # start= replays the exact batch sequence from the resume point; the
    # prefetch overlaps the host's sample prep (decode, augmentation, the
    # patch resizes, the mask) with the device's step
    it = _prefetch(dataset.batches(
        args.train_batch_size, steps=max(0, args.max_train_steps - start_step),
        start=start_step))
    steps_per_epoch = max(1, len(dataset) // args.train_batch_size)
    val_every = args.validation_steps or (
        args.validation_epochs * steps_per_epoch
        if args.validation_epochs > 0 else 0)
    t_last = time.time()
    history = []
    for step in range(start_step, args.max_train_steps):
        batch = batch_to_device(next(it), device)
        metrics = trainer.train_step(batch)

        if (step + 1) % args.log_every == 0:
            loss = float(metrics["loss"])
            gnorm = float(metrics["grad_norm"])
            dt = (time.time() - t_last) / args.log_every
            t_last = time.time()
            logger.info("step %d loss %.4f grad_norm %.3f %.2fs/step",
                        step + 1, loss, gnorm, dt)
            scalars = {"train/loss": loss, "train/grad_norm": gnorm,
                       "train/steps_per_sec": 1.0 / max(dt, 1e-9)}
            if writer:
                for k, v in scalars.items():
                    writer.add_scalar(k, v, step + 1)
            if wandb_run:
                wandb_run.log(scalars, step=step + 1)

        if (step + 1) % args.checkpointing_steps == 0:
            save_checkpoint(run.ckpt_dir, trainer,
                            args.checkpoints_total_limit)
            logger.info("saved checkpoint at step %d", step + 1)

        if val_every and (step + 1) % val_every == 0:
            _log_validation(writer, step + 1, trainer, models, dataset)
        history.append({"step": step + 1, "time": time.perf_counter(),
                        **metrics})

    export_dir = os.path.join(args.output_dir, "export")
    save_pipeline_params(export_dir, trainer.export_state_dicts(run.weights))
    logger.info("exported serving checkpoint to %s", export_dir)
    if wandb_run:
        wandb_run.finish()
    if writer:
        writer.close()
    return export_dir, [{**h, "loss": float(h["loss"]),
                         "grad_norm": float(h["grad_norm"])}
                        for h in history]


def validation_sample(dataset) -> dict:
    """Sample 0 of `dataset` from a generator of its own (seeded with the
    dataset's seed), on a copy, so that the prefetch thread's stream is
    never touched."""
    val = copy.copy(dataset)
    val.mask_generator = copy.copy(dataset.mask_generator)
    return val.sample(0, random.Random(f"{dataset.seed}-validation"))


def _validation_grid(step, trainer, models, dataset) -> np.ndarray:
    """Inpaint a validation sample with the current weights (the port's
    stamp, DDIM 20, cfg 2.0, no texture guidance, context pad 150, draws
    from a generator seeded with `step`) and return the [masked source |
    mask | conditioning image | result] grid, (H, 4W, 3) uint8, the
    reference's panel set (train...py:66-86, 749-782)."""
    from ..pipeline.inpaint import make_stamp_fn

    device = trainer.device
    with torch.no_grad():
        merged = trainer.unet_overrides()
        unet = models["unet"]

        def unet_fn(sample, t, ctx):
            return torch.func.functional_call(unet, merged, (sample, t, ctx))

        stamp = make_stamp_fn(unet_fn, models["vae_encoder"],
                              models["vae_decoder"], 20)
        sample = validation_sample(dataset)
        canvas = np.concatenate(
            [(sample["masked_image"] + 1.0) / 2.0, 1.0 - sample["mask"]],
            axis=-1)
        canvas_u8 = (np.clip(canvas, 0, 1) * 255).astype(np.uint8)
        patches = torch.from_numpy(sample["cond_patches"][None]).to(device)
        cond, uncond = trainer.encode_patches(patches)
        h, w = canvas.shape[:2]
        gen = torch.Generator(device=device).manual_seed(step)
        enc = torch.randn((2, h // 8, w // 8, 4), generator=gen,
                          device=device)
        init = torch.randn((1, h // 8, w // 8, 4), generator=gen,
                           device=device)
        brush = torch.zeros((1, h, w, 3), device=device)
        _, comp = stamp(torch.from_numpy(canvas_u8[None]).to(device), brush,
                        cond, uncond, enc, init, 2.0, 0.0, 0, 150)
    cond_u8 = (np.clip(sample["cond_image"], 0, 1) * 255).astype(np.uint8)
    return np.concatenate(
        [canvas_u8[..., :3],
         np.repeat((255 * (1 - sample["mask"])).astype(np.uint8), 3, -1),
         cond_u8, comp.cpu().numpy()], axis=1)


def _log_validation(writer, step, trainer, models, dataset) -> None:
    """_validation_grid to tensorboard; best-effort, as the JAX package's:
    a failure is logged and training goes on."""
    try:
        grid = _validation_grid(step, trainer, models, dataset)
        if writer:
            writer.add_image("val/grid", grid, step, dataformats="HWC")
    except Exception as e:  # validation is best-effort
        logger.warning("validation grid failed: %s", e)


if __name__ == "__main__":
    main()
