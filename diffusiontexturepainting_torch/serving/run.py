"""Inference server entry point of the port.

Builds TorchConditionalInpainter on the GPU and serves it through the JAX
package's framework-free Tornado application (binary websocket protocol at
/websocket/, HTTP POST /inpaint, GET /health):

    python -m diffusiontexturepainting_torch.serving.run --port 6060 \
        --resolution 256
"""

from __future__ import annotations

import argparse
import logging

logger = logging.getLogger(__name__)


def run_main(argv=None):
    parser = argparse.ArgumentParser(
        description="texture inpainting server (PyTorch + CUDA port)")
    parser.add_argument("--port", type=int, default=6060)
    parser.add_argument("--resolution", type=int, default=256)
    args = parser.parse_args(argv)

    import tornado.ioloop

    from diffusiontexturepainting_tpu.serving.run import create_server

    from ..pipeline.torch_model import TorchConditionalInpainter

    logging.basicConfig(level=logging.INFO)
    model = TorchConditionalInpainter(args.resolution, device="cuda")
    app = create_server(model=model)
    app.listen(args.port)
    logger.info("Serving on ws://0.0.0.0:%d/websocket/", args.port)
    tornado.ioloop.IOLoop.current().start()


if __name__ == "__main__":
    run_main()
