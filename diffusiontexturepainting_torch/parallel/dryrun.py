"""A dry run of every multi-device path on N devices.

The counterpart of the JAX package's `__graft_entry__.py multichip N`:

  1. one training step on a (N / model) x model mesh, model 2 where N is
     even and at least 4 (else 1): N ranks as spawned processes
     (parallel/launch.py), the frozen towers sharded over each model group
     (parallel/mesh.py ModelShards), the batch one row a data rank;
  2. one `--mesh data=N` batch of N requests with per-request cfg
     weights, a share of one request on each device
     (serving/parallel_model.py);
  3. one `--mesh model=3` stamp where N >= 3 (parallel/cfg_shard.py).

    python -m diffusiontexturepainting_torch.parallel.dryrun 4 --device cpu
    python -m diffusiontexturepainting_torch.parallel.dryrun 4 --full

On the CPU every device is "cpu" and the models are the tiny ones; on
cards (the default) device i is cuda:(i mod the cards present), so a
machine with fewer cards than N repeats them (the ranks then meet over
gloo, which lets ranks share a card), and --full runs the full-width
models. `--measure` (cards) then times what the paths cost on the
machine: the CFG-sharded stamp against the one-card stamp (wall and
device ms, each card's busy share), stamps/s of N painters through
`data=N` and through `data=1 --max-batch N`, and a training rank's frozen
tower bytes at rest and its peak under model 1 beside step 1's (model 2
where N is even and at least 4). Prints one JSON object as its last
line.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import shutil
import statistics
import tempfile
import threading
import time

import numpy as np
import torch

logger = logging.getLogger(__name__)

STAMP_RES = 64  # the tiny models' stamp on the CPU
RANK_TIMEOUT = 900  # seconds the training ranks may take before they die


def devices_of(n: int, device_type: str) -> list:
    """N devices: "cpu" N times, or cuda:(i mod the cards present)."""
    if device_type == "cpu":
        return ["cpu"] * n
    count = torch.cuda.device_count()
    if count < 1:
        raise RuntimeError("no CUDA device")
    return [f"cuda:{i % count}" for i in range(n)]


def model_axis_of(n: int) -> int:
    return 2 if n % 2 == 0 and n >= 4 else 1


# --- 1. the training step ---


def _batch(rows: int, res: int, pcfg, seed: int = 0) -> dict:
    """A synthetic batch, as the JAX dry run makes it."""
    rng = np.random.default_rng(seed)
    cs = pcfg.clip.image_size
    batch = {
        "image": rng.standard_normal((rows, res, res, 3)) * 0.1,
        "mask": (rng.random((rows, res, res, 1)) > 0.5) * 1.0,
        "cond_patches": rng.standard_normal(
            (rows, pcfg.total_patches, cs, cs, 3)),
        "drop_cond": (rng.random((rows,)) < 0.1) * 1.0,
    }
    batch["masked_image"] = batch["image"] * (1.0 - batch["mask"])
    return {k: v.astype(np.float32) for k, v in batch.items()}


def _train_rank(local_rank, n, model, device_type, backend, store, full,
                res, threads):
    """One rank's training step: {"rank", "device", "loss", "step",
    "digest", "frozen_bytes", "peak_bytes"}."""
    import hashlib

    import torch.distributed as dist

    from ..training.train import build_models
    from ..training.trainer import TrainConfig, Trainer, batch_to_device
    from ..weights.random_init import complete_weights
    from .mesh import ModelShards, init_distributed, mesh_groups

    torch.set_num_threads(threads)
    rank = init_distributed("file://" + store, 1, 0, data=n // model,
                            local_rank=local_rank, device_type=device_type,
                            backend=backend, model=model)
    try:
        device = torch.device(rank.device)
        dtype = torch.bfloat16 if device.type == "cuda" else torch.float32
        models = build_models(not full, device, dtype)
        weights = complete_weights(models, {}, 0)
        for name, sd in weights.items():
            models[name].load_state_dict(sd)
        weights = {name: {k: v.detach().to("cpu", torch.float32)
                          for k, v in sd.items()}
                   for name, sd in weights.items()}
        data_group, model_group = mesh_groups(rank)
        trainer = Trainer(TrainConfig(resolution=res, lora_rank=2), models,
                          weights, device, dtype, shard=rank.shard,
                          data_group=data_group)
        if model > 1:
            trainer.shards = ModelShards(
                {c: models[c] for c in ("unet", "vae_encoder",
                                        "patch_encoder")},
                rank.model_index, model, model_group, rank.backend,
                rank.data_index * model)
        from ..training.train import _frozen_bytes

        frozen = _frozen_bytes(trainer)
        batch = _batch(rank.data, res, models["patch_encoder"].cfg)
        row = slice(rank.data_index, rank.data_index + 1)
        batch = batch_to_device({k: v[row] for k, v in batch.items()},
                                device)
        if device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(device)
        metrics = trainer.train_step(batch)
        loss = float(metrics["loss"])
        h = hashlib.sha256()
        for k in sorted(trainer.params):
            h.update(trainer.params[k].detach().cpu().numpy().tobytes())
        return {"rank": rank.rank, "device": rank.device, "loss": loss,
                "step": trainer.step, "digest": h.hexdigest(),
                "frozen_bytes": frozen,
                "peak_bytes": (torch.cuda.max_memory_allocated(device)
                               if device.type == "cuda" else None)}
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def train_on_mesh(n: int, model: int, device_type: str, full: bool,
                  res: int) -> list:
    """One training step on n // model x model ranks (stopped after
    RANK_TIMEOUT seconds); each rank's record, checked: finite loss, step
    1, every rank's trainables equal."""
    from .launch import run_local_ranks

    count = torch.cuda.device_count() if device_type == "cuda" else 1
    backend = "gloo" if device_type != "cuda" or count < n else "nccl"
    tmp = tempfile.mkdtemp(prefix="dtp_dryrun_")
    threads = max(1, torch.get_num_threads() // n)
    try:
        ranks = run_local_ranks(
            _train_rank, [(i, n, model, device_type, backend,
                           os.path.join(tmp, "store"), full, res, threads)
                          for i in range(n)], timeout=RANK_TIMEOUT)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(np.isfinite(r["loss"]) and r["step"] == 1 for r in ranks):
        raise AssertionError(f"a rank's step failed: {ranks}")
    if len({r["digest"] for r in ranks}) != 1:
        raise AssertionError("the ranks' trainables differ")
    return ranks


# --- 2. and 3. serving ---


def _canvas(res: int, i: int) -> np.ndarray:
    canvas = np.zeros((res, res, 4), np.uint8)
    canvas[: res // 2, :, :3] = 40 + 30 * i
    canvas[: res // 2, :, 3] = 255
    return canvas


def data_batch(n: int, devices: list, full: bool, res: int,
               steps: int) -> dict:
    """One `data=n` batch of n requests, cfg weight 1.5 to 3.0, a share of
    one on each device: the stamps' shapes, and the devices the shares ran
    on (each device's model replica ran a program)."""
    from ..serving.parallel_model import make_parallel_service

    svc = make_parallel_service(res, f"data={n}", tiny=not full,
                                max_batch=n, device=devices[0],
                                devices=devices)
    session = svc.new_session()
    payloads = [dict(canvas=_canvas(res, i), image=session.image,
                     brush=session._brush, cond=session._cond,
                     uncond=session._uncond, counter=i + 1,
                     cfg_weight=float(w), tg_weight=1.0, tg_steps=steps,
                     context_pad=16)
                for i, w in enumerate(np.linspace(1.5, 3.0, n))]
    out = svc._run_batch((res, steps), payloads)
    if len(out) != n or any(o.shape != (res, res, 3) for o in out):
        raise AssertionError(f"a data={n} batch gave {len(out)} stamps")
    shares = [str(d) for d, _, _ in svc.shares(n)]
    ran = [str(d) for d, m in svc._replicas.items() if m.engine.programs]
    if set(ran) != set(shares):
        raise AssertionError(f"shares on {shares}, programs on {ran}")
    return {"stamps": n, "shares": shares, "replicas": len(svc._replicas)}


def cfg_stamp(devices: list, full: bool, res: int, steps: int) -> dict:
    """One `model=3` stamp over devices[:3]."""
    from ..pipeline.torch_model import TorchConditionalInpainter
    from .mesh import make_cfg_mesh

    model = TorchConditionalInpainter(
        res, tiny=not full, verbose_timing=False,
        cfg_mesh=make_cfg_mesh(3, devices[:3], devices[0]))
    out = model.generate_u8(_canvas(res, 0), steps=steps, context_pad=8)
    if out.shape != (res, res, 3):
        raise AssertionError(f"the cfg stamp's shape {out.shape}")
    return {"shape": list(out.shape),
            "devices": [str(d) for d in model.cfg_unets.devices],
            "replicas": len(model.cfg_unets.replicas)}


# --- --measure: what the paths cost on cards ---


def busy_share(fn, reps: int) -> tuple:
    """(wall s, {device index: the share of the wall its kernels and
    copies were busy}) of fn() `reps` times, from torch.profiler's device
    events; an empty dict where the profiler saw no device time."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        tic = time.perf_counter()
        for _ in range(reps):
            fn()
        for i in range(torch.cuda.device_count()):
            torch.cuda.synchronize(i)
        wall = time.perf_counter() - tic
    busy = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            busy[e.device_index] = (busy.get(e.device_index, 0.0)
                                    + e.time_range.elapsed_us() * 1e-6)
    return wall, {i: b / wall for i, b in sorted(busy.items())}


def stamp_times(model, res: int, steps: int, reps: int) -> dict:
    """Wall ms of generate_u8 (median, min, max of reps) and device ms
    (CUDA events on the model's stream around the stamp, median), after a
    warm-up stamp."""
    canvas = _canvas(res, 1)
    model.generate_u8(canvas, steps=steps)
    walls, device = [], []
    stream = torch.cuda.current_stream(model.device)
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        tic = time.perf_counter()
        start.record(stream)
        model.generate_u8(canvas, steps=steps)
        end.record(stream)
        walls.append((time.perf_counter() - tic) * 1e3)
        end.synchronize()
        device.append(start.elapsed_time(end))
    return {"wall_ms": statistics.median(walls), "wall_min_ms": min(walls),
            "wall_max_ms": max(walls),
            "device_ms": statistics.median(device)}


def measure_cfg(devices: list, points: list, reps: int) -> dict:
    """The CFG-sharded stamp over devices[:3] against the ordinary stamp
    on devices[0], the same weights, at each (res, steps), in turns
    (one card, sharded, sharded, one card); each card's busy share over
    the sharded stamps."""
    from ..pipeline.torch_model import TorchConditionalInpainter
    from .mesh import make_cfg_mesh

    one = TorchConditionalInpainter(max(r for r, _ in points),
                                    device=devices[0], verbose_timing=False)
    cfg = TorchConditionalInpainter(
        max(r for r, _ in points), device=devices[0], verbose_timing=False,
        weights=one.state_dicts(),
        cfg_mesh=make_cfg_mesh(3, devices[:3], devices[0]))
    out = {}
    for res, steps in points:
        runs = {"one_card": [], "cfg": []}
        for name in ("one_card", "cfg", "cfg", "one_card"):
            model = one if name == "one_card" else cfg
            runs[name].append(stamp_times(model, res, steps, reps))
        canvas = _canvas(res, 2)
        wall, busy = busy_share(
            lambda: cfg.generate_u8(canvas, steps=steps), reps)
        out[f"{res}x{steps}"] = {
            **runs, "cfg_busy": {f"cuda:{i}": b for i, b in busy.items()},
            "cfg_profiled_wall_s": wall}
        logger.info("cfg %dx%d: %s", res, steps, out[f"{res}x{steps}"])
    del one, cfg
    torch.cuda.empty_cache()
    return out


def painters_per_second(svc, clients: int, res: int, steps: int,
                        seconds: float) -> dict:
    """Stamps/s of `clients` threads, each a painter sending its next
    NEW_STAMP on its reply for `seconds` (after one stamp each)."""
    sessions = [svc.new_session() for _ in range(clients)]
    canvases = [_canvas(res, i) for i in range(clients)]
    for s, c in zip(sessions, canvases):
        s.generate_u8(c, steps=steps)
    done = [0] * clients
    stop = time.perf_counter() + seconds

    def paint(i):
        while time.perf_counter() < stop:
            sessions[i].generate_u8(canvases[i], steps=steps)
            done[i] += 1

    threads = [threading.Thread(target=paint, args=(i,))
               for i in range(clients)]
    tic = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - tic
    return {"stamps": sum(done), "seconds": wall,
            "stamps_per_s": sum(done) / wall,
            "batches": svc.batch_counts()}


def measure_data(devices: list, clients: int, res: int, steps: int,
                 seconds: float) -> dict:
    """Stamps/s of `clients` painters through data=len(devices) and
    through data=1 --max-batch clients, in turns."""
    from ..serving.parallel_model import make_parallel_service

    n = len(devices)
    out = {}
    for spec, max_batch, devs in (
            (f"data={n}", clients, devices),
            ("data=1", clients, devices[:1])):
        svc = make_parallel_service(res, spec, max_batch=max_batch,
                                    device=devs[0], devices=devs)
        # every batch size's program on every card, captured before the
        # clock starts
        session = svc.new_session()
        payloads = [dict(canvas=_canvas(res, i), image=session.image,
                         brush=session._brush, cond=session._cond,
                         uncond=session._uncond, counter=i + 1,
                         cfg_weight=2.0, tg_weight=1.0, tg_steps=steps,
                         context_pad=150) for i in range(max_batch)]
        for k in range(1, max_batch + 1):
            svc._run_batch((res, steps), payloads[:k])
        svc.batch_sizes.clear()
        out[f"{spec} max_batch={max_batch}"] = painters_per_second(
            svc, clients, res, steps, seconds)
        logger.info("%s: %s", spec, out[f"{spec} max_batch={max_batch}"])
        del svc
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n", type=int, nargs="?", default=4)
    p.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    p.add_argument("--full", action="store_true",
                   help="full-width models (on cards)")
    p.add_argument("--measure", action="store_true",
                   help="also time the paths (on cards)")
    args = p.parse_args(argv)
    logging.basicConfig(level=logging.INFO)
    devices = devices_of(args.n, args.device)
    if args.device == "cuda":
        count = torch.cuda.device_count()
        logger.info("%d cards for %d devices: %s", count, args.n,
                    "distinct" if count >= args.n else "repeated")
    res = 256 if args.full else STAMP_RES
    model = model_axis_of(args.n)
    record = {"n": args.n, "devices": devices, "model_axis": model}
    tic = time.perf_counter()
    ranks = train_on_mesh(args.n, model, args.device, args.full, res)
    record["train"] = {"mesh": [args.n // model, model], "ranks": ranks}
    print(f"dryrun({args.n}) train OK: mesh data {args.n // model} x model "
          f"{model}, loss {ranks[0]['loss']:.4f}", flush=True)
    record["data"] = data_batch(args.n, devices, args.full, res, 2)
    print(f"dryrun({args.n}) serve OK: data={args.n} batch over "
          f"{record['data']['shares']}", flush=True)
    if args.n >= 3:
        record["cfg"] = cfg_stamp(devices, args.full, res, 2)
        print(f"dryrun({args.n}) cfg-shard OK: branches on "
              f"{record['cfg']['devices']}", flush=True)
    if args.measure:
        if args.device != "cuda":
            raise SystemExit("--measure times cards: --device cuda")
        import subprocess

        record["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60).stdout.strip().splitlines()
        if not args.full:
            raise SystemExit("--measure times the full-width models: --full")
        record["measure"] = {
            "cfg": measure_cfg(devices, [(256, 20), (512, 4)], reps=5),
            "data": measure_data(devices, args.n, 256, 20, seconds=20.0),
            # the frozen bytes and peaks of step 1's mesh beside model 1's
            "train_model1": train_on_mesh(args.n, 1, "cuda", True, res),
        }
    record["seconds"] = time.perf_counter() - tic
    print(json.dumps(record), flush=True)
    return record


if __name__ == "__main__":
    main()
