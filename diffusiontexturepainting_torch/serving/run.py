"""Inference server entry point of the port.

Builds TorchConditionalInpainter on the GPU (seeded random weights, bf16)
and serves it through serving/server.py (binary websocket protocol at
/websocket/, GET /health):

    python -m diffusiontexturepainting_torch.serving.run --port 6060 \
        --resolution 256 --config default

--resolution is the model's size (256, 512 or 1024 px; each stamp runs at
its canvas's size); --config picks the serving legs: default (the fused
kernels), safe_twin (module legs only) or slotted (default plus the
head-slotted self-attention).
"""

from __future__ import annotations

import argparse
import logging

from ..core.config import CONFIG_NAMES, pipeline_config

logger = logging.getLogger(__name__)


def run_main(argv=None):
    parser = argparse.ArgumentParser(
        description="texture inpainting server (PyTorch + CUDA port)")
    parser.add_argument("--host", default="0.0.0.0")
    parser.add_argument("--port", type=int, default=6060)
    parser.add_argument("--resolution", type=int, default=256,
                        choices=(256, 512, 1024))
    parser.add_argument("--config", default="default", choices=CONFIG_NAMES)
    args = parser.parse_args(argv)

    from ..pipeline.torch_model import TorchConditionalInpainter
    from .server import create_server

    logging.basicConfig(level=logging.INFO)
    model = TorchConditionalInpainter(args.resolution,
                                      config=pipeline_config(args.config),
                                      device="cuda")
    server = create_server(model, args.host, args.port,
                           model_info=f"torch-sd15-inpaint {args.config} "
                                      "(random weights)")
    logger.info("Serving on ws://%s:%d/websocket/", args.host, args.port)
    server.serve_forever()


if __name__ == "__main__":
    run_main()
