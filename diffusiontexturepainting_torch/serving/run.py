"""Inference server entry point of the port.

Builds the serving model and serves it through serving/server.py (binary
websocket protocol at /websocket/, HTTP POST /inpaint with the same bytes,
GET /health), with the JAX package's single-chip flags
(diffusiontexturepainting_tpu/serving/run.py):

    python -m diffusiontexturepainting_torch.serving.run --port 6060 \
        --resolution 256 --config default --scheduler DDIM \
        --checkpoint_dir DIR --warmup-points 256x20,512x4
    python -m diffusiontexturepainting_torch.serving.run \
        --deep-cache-interval 2 --f32-final-step --warmup-points 256x20x2
    python -m diffusiontexturepainting_torch.serving.run --mock  # no card

--resolution is the model's size (256, 512 or 1024 px; each stamp runs at
its canvas's size); --config picks the serving legs: default (the fused
kernels), safe_twin (module legs only) or slotted (default plus the
head-slotted self-attention). At startup the server builds the kernels and
captures one stamp program (a CUDA graph, core/engine.py) per
--warmup-points operating point (default: the model's resolution at 20
steps), unless --no-warmup; --session-canvas WxH also runs a stroke
session on such a canvas, which captures the points' session stamps where
they differ. --device cpu --tiny serves the tiny test models on the CPU
(no graphs there: the engine runs eagerly).

The operating points: --deep-cache-interval (an int >= 1, the full UNet
every that many model calls from deep_cache_min_steps steps on, or an
'F'/'S' pattern such as FSSF, which applies where the scheduler's model
calls number its length), a --warmup-points point's third field (the
DeepCache spec it warms), --f32-final-step (the last model call's UNet in
fp32) and --f32-components (the named components computed in fp32).

Concurrent painters on one card, as the JAX server's --mesh data=1
--max-batch N (serving/parallel_model.py):

    python -m diffusiontexturepainting_torch.serving.run --mesh data=1 \
        --max-batch 4 --batch-window-ms 3

Each connection gets its own brush and stroke session; concurrent
connections' NEW_STAMPs run as one batched stamp of up to --max-batch
(default: the data axis) requests, each with its own settings: those that
arrived while the card was busy, and those that arrive within
--batch-window-ms (3.0) of the card coming to them, or within 50 ms for a
painter of the last batch (serving/parallel_model.py RETURN_MS).

Several cards, as the JAX server's meshes (parallel/mesh.py):

    python -m diffusiontexturepainting_torch.serving.run --mesh data=4
    python -m diffusiontexturepainting_torch.serving.run --mesh model=3

--mesh data=N splits each batch into contiguous shares, one a card, run
at once, and pins each stroke session to a card, round-robin, with one
model replica a card (--session-canvas warms one session a card). --mesh
model=3 serves one painter with the UNet's three guidance branches a card
each (parallel/cfg_shard.py), on the ordinary path. The mesh's devices
are the machine's cards, cuda:0 first; build_server(argv, devices=[...])
takes an explicit list instead, which may repeat a device (the tests use
["cpu", "cpu"]). Refused with ValueError, as the JAX server refuses them:
--mock with --mesh, --max-batch above 1 without --mesh, a max batch off a
multiple of the data axis, a data axis above the devices present,
model=N with another axis, with --max-batch, above the devices present or
other than 3. --profile-dir does not combine with --mesh.
"""

from __future__ import annotations

import argparse
import dataclasses
import logging
import time

from ..core.config import (
    COMPONENTS,
    CONFIG_NAMES,
    parse_deep_cache_spec,
    pipeline_config,
)

logger = logging.getLogger(__name__)

SCHEDULER_CHOICES = ("DDIM", "DPM", "DPM++", "EulerA", "LMS", "LMSD", "PNDM")


def parse_warmup_points(text: str) -> list:
    """'256x20,512x4x2,512x4xFSSF' -> [(256, 20), (512, 4, 2), (512, 4,
    'FSSF')]: RESOLUTIONxSTEPS[xDEEPCACHE], the third field a DeepCache
    spec (parse_deep_cache_spec)."""
    points = []
    for item in text.split(","):
        fields = item.strip().lower().split("x")
        if len(fields) not in (2, 3):
            raise ValueError(f"--warmup-points {item!r}: expected "
                             "RESOLUTIONxSTEPS[xDEEPCACHE]")
        point = (int(fields[0]), int(fields[1]))
        if len(fields) == 3:
            point += (parse_deep_cache_spec(fields[2]),)
        points.append(point)
    return points


def parse_f32_components(text: str) -> list:
    """'unet,vae_decoder' -> ['unet', 'vae_decoder']; a name outside
    COMPONENTS raises ValueError, as the JAX server refuses it."""
    names = [s.strip() for s in text.split(",") if s.strip()]
    bad = set(names) - set(COMPONENTS)
    if bad:
        raise ValueError(f"unknown --f32-components {sorted(bad)}; choose "
                         f"from {sorted(COMPONENTS)}")
    return names


def _arg_type(parse):
    """argparse type from a parser that raises ValueError."""
    def convert(text):
        try:
            return parse(text)
        except ValueError as e:
            raise argparse.ArgumentTypeError(str(e)) from None
    convert.__name__ = parse.__name__
    return convert


def parse_canvas(text: str) -> tuple:
    """'1024x768' (width x height) -> (1024, 768)."""
    w, h = (int(v) for v in text.lower().split("x"))
    return w, h


def warm_session(model, width: int, height: int, warmup_points=None) -> float:
    """A stroke session on a blank width x height canvas: for the default
    step count and each of `warmup_points`', one STAMP_AT with pixels and
    one without, then fetch_canvas and end_session (the JAX package's
    _warm_session; the port has no stroke buckets, so there is no flush to
    warm). A model's request counter is put back (a service's session
    draws from the service's: warm_sessions). Returns the seconds."""
    import numpy as np

    tic = time.perf_counter()
    counter = getattr(model, "request_counter", None)
    steps_list = [None] + sorted({int(p[1]) for p in (warmup_points or [])})
    try:
        model.begin_session(np.zeros((height, width, 4), np.uint8))
        for s in steps_list:
            kw = {} if s is None else {"steps": s}
            model.stamp_at(0, 0, return_pixels=True, **kw)
            model.stamp_at(0, 0, return_pixels=False, **kw)
        model.fetch_canvas()
        model.end_session()
    finally:
        if counter is not None:
            model.request_counter = counter
    return time.perf_counter() - tic


def warm_sessions(service, width: int, height: int,
                  warmup_points=None) -> float:
    """warm_session on one session a device of `service`'s data mesh (the
    JAX package's warm-up of one session a chip: sessions are pinned
    round-robin, so each lands on the next device); the service's request
    counter is put back. Returns the seconds."""
    tic = time.perf_counter()
    counter = service._counter
    try:
        for _ in service.devices:
            warm_session(service.new_session(), width, height,
                         warmup_points)
    finally:
        service._counter = counter
    return time.perf_counter() - tic


def make_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        description="texture inpainting server (PyTorch + CUDA port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6060)
    parser.add_argument("--resolution", type=int, default=256,
                        help="the model's size in px (256, 512 or 1024 at "
                             "full width)")
    parser.add_argument("--config", default="default", choices=CONFIG_NAMES)
    parser.add_argument("--mock", action="store_true",
                        help="serve the mock model (no torch model, no "
                             "card)")
    parser.add_argument("--checkpoint_dir", default=None,
                        help="weights in the JAX package's npz format "
                             "(seeded random weights when omitted)")
    parser.add_argument("--scheduler", default=None,
                        choices=SCHEDULER_CHOICES,
                        help="sampler (default: the configuration's, DDIM)")
    parser.add_argument("--debug_dir", default=None,
                        help="save each request's images here as .npy")
    parser.add_argument("--profile-dir", default=None,
                        help="diagnostic only: a torch.profiler trace of "
                             "each request here (Chrome JSON), the first 32 "
                             "of the process")
    parser.add_argument("--no-warmup", action="store_true",
                        help="skip the kernel build and warm-up stamps at "
                             "startup")
    parser.add_argument("--warmup-points",
                        type=_arg_type(parse_warmup_points), default=None,
                        help="comma list of RESOLUTIONxSTEPS[xDEEPCACHE] "
                             "operating points to warm at startup, e.g. "
                             "'256x20,512x4' or '256x20x2' (default: "
                             "--resolution at the configuration's steps)")
    parser.add_argument("--deep-cache-interval",
                        type=_arg_type(parse_deep_cache_spec), default=None,
                        help="DeepCache: an int >= 1 (the full UNet every "
                             "that many model calls, the outermost level "
                             "against the cache in between, for requests of "
                             "at least 8 steps; 1 is off) or an F/S pattern "
                             "starting with F, e.g. FSSF (applies only where "
                             "the scheduler's model calls number its "
                             "length)")
    parser.add_argument("--f32-final-step", action="store_true",
                        help="compute the last model call's UNet eval in "
                             "fp32 (the module legs over the serving "
                             "weights, upcast)")
    parser.add_argument("--f32-components",
                        type=_arg_type(parse_f32_components), default=None,
                        help="comma list of components computed, and their "
                             "weights kept, in fp32: "
                             + ", ".join(COMPONENTS))
    parser.add_argument("--session-canvas", type=parse_canvas, default=None,
                        help="warm a stroke session on a canvas of this "
                             "size at startup, e.g. 1024x1024 (width x "
                             "height)")
    parser.add_argument("--mesh", default=None,
                        help="'data=N': concurrent painters' stamps "
                             "batched and sharded over N cards, sessions "
                             "pinned a card each ('data=1': request "
                             "batching on one card); 'model=3': one "
                             "painter's guidance branches a card each")
    parser.add_argument("--max-batch", type=int, default=None,
                        help="with --mesh: batch up to this many "
                             "concurrent stamps (a multiple of the data "
                             "axis; default the data axis)")
    parser.add_argument("--batch-window-ms", type=float, default=3.0,
                        help="with --mesh: how long a batch waits for "
                             "peers once the card is free for it")
    parser.add_argument("--device", default="cuda",
                        help="the model's device (cpu for debugging)")
    parser.add_argument("--tiny", action="store_true",
                        help="the tiny test models (debugging on the CPU)")
    return parser


def build_server(argv=None, devices=None):
    """run.py's whole assembly, from its arguments to a bound server
    (serve_forever() serves it); the server also carries `model`,
    `model_info` and `startup` (seconds of each warm-up; on CUDA also each
    point's capture seconds, "<point> capture", and the engine pool's
    reserved bytes after it, "<point> pool_bytes"). `devices`: the mesh's
    devices (parallel/mesh.py mesh_devices; default every card)."""
    args = make_parser().parse_args(argv)
    from .server import create_server

    if args.mesh and args.mock:
        raise ValueError("--mock cannot combine with --mesh (the mesh "
                         "paths build the real pipeline)")
    if args.max_batch and args.max_batch > 1 and not args.mesh:
        raise ValueError("--max-batch requires --mesh data=N (use --mesh "
                         "data=1 for single-card request batching); "
                         "without a mesh it would be silently ignored")
    if args.mesh and args.profile_dir:
        raise ValueError("--profile-dir traces one request at a time; it "
                         "cannot combine with --mesh")
    mesh = cfg_mesh = None
    if args.mesh:
        from ..parallel.mesh import CfgMesh, make_serving_mesh

        # before the model is built: a refused mesh fails at once
        mesh = make_serving_mesh(args.mesh, args.device, devices,
                                 args.max_batch)
        if isinstance(mesh, CfgMesh):
            # one painter on three cards: the ordinary path, its model's
            # UNet sharded (the JAX server falls through the same way)
            cfg_mesh, mesh = mesh, None
    startup = {}
    if args.mock:
        from ..client.mock_model import MockConditionalInpainter

        model = MockConditionalInpainter(args.resolution)
        info = "mock"
    else:
        from ..pipeline.torch_model import TorchConditionalInpainter

        config = pipeline_config(args.config)
        if args.scheduler:
            config = dataclasses.replace(config, scheduler=args.scheduler)
        if args.deep_cache_interval is not None:
            config = dataclasses.replace(
                config, deep_cache_interval=args.deep_cache_interval)
        if args.f32_final_step:
            config = dataclasses.replace(config, f32_final_step=True)
        overrides = None
        if args.f32_components:
            import torch

            overrides = {name: torch.float32 for name in args.f32_components}
        if not args.checkpoint_dir:
            logger.warning("No --checkpoint_dir given - using seeded random "
                           "weights (latency-correct, visually "
                           "meaningless).")
        model = TorchConditionalInpainter(
            args.resolution, config=config,
            device=mesh.devices[0] if mesh else args.device,
            tiny=args.tiny, checkpoint_dir=args.checkpoint_dir,
            dtype_overrides=overrides, cfg_mesh=cfg_mesh)
        startup["model"] = model.init_seconds
        info = (f"torch-sd15-inpaint {args.config} {config.scheduler}"
                + (f" mesh[{args.mesh}]" if mesh else "")
                + (f" cfg-sharded[{cfg_mesh.spec}]" if cfg_mesh else "")
                + ("" if args.checkpoint_dir else " (random weights)"))
    service = None
    if mesh:
        from .parallel_model import ParallelInpainterService

        service = ParallelInpainterService(model, mesh,
                                           window_ms=args.batch_window_ms,
                                           max_batch=args.max_batch)
    # the base model, then each other card's replica of a data mesh
    models = [model] if not args.mock else []
    if service is not None:
        models += [service.params_on(d) for d in dict.fromkeys(
            service.devices) if d != model.device]
    for m in models if not args.no_warmup else ():
        prefix = "" if m is model else f"{m.device} "
        for point, secs in m.warmup(args.warmup_points).items():
            name = prefix + "x".join(str(v) for v in point)
            startup[name] = secs
            logger.info("warm-up %s: %.1f s", name, secs)
            captured = m.warmup_captures.get(point)
            if captured:
                startup[f"{name} capture"] = captured["seconds"]
                startup[f"{name} pool_bytes"] = captured["pool_bytes"]
        if m is model and model.build_seconds is not None:
            startup["build"] = model.build_seconds
    if args.session_canvas:
        w, h = args.session_canvas
        startup["session"] = (
            warm_sessions(service, w, h, args.warmup_points)
            if service is not None and len(service.devices) > 1
            else warm_session(model, w, h, args.warmup_points))
    server = create_server(model, args.host, args.port, model_info=info,
                           debug_dir=args.debug_dir,
                           profile_dir=args.profile_dir, service=service)
    server.startup = startup
    return server


def run_main(argv=None):
    logging.basicConfig(level=logging.INFO)
    server = build_server(argv)
    host, port = server.socket.getsockname()[:2]
    logger.info("Serving %s on ws://%s:%d/websocket/ (POST "
                "http://%s:%d/inpaint)", server.model_info, host, port,
                host, port)
    server.serve_forever()


if __name__ == "__main__":
    run_main()
