"""Client model registry: name -> inpainter factory.

Port of diffusiontexturepainting_tpu/client/library.py, the analog of the
reference's kit_app/.../inference/library.py:15-34; `add_gpu_model` takes
the place of add_tpu_model and registers the port's in-process model. A
URL or resolution left as None is read from utils/settings.py when the
model is made (DTP_SERVER_URL, DTP_RESOLUTION).
"""

from __future__ import annotations

from ..utils import settings
from .mock_model import MockConditionalInpainter

MODEL_LIBRARY = {
    "Mock": lambda: MockConditionalInpainter(settings.resolution()),
}


def add_remote_model(url: str | None = None, name: str = "AI Brush (remote)",
                     resolution: int | None = None):
    """Register a websocket-backed model under `name`."""

    def _factory():
        from .websocket_model import WebsocketConditionalInpainter

        return WebsocketConditionalInpainter(
            url or settings.get("DTP_SERVER_URL"),
            resolution=resolution or settings.resolution())

    MODEL_LIBRARY[name] = _factory
    return name


def add_gpu_model(name: str = "AI Brush (local GPU)",
                  resolution: int | None = None, **kwargs):
    """Register an in-process model on the card (TorchConditionalInpainter)
    under `name`."""

    def _factory():
        from ..pipeline.torch_model import TorchConditionalInpainter

        return TorchConditionalInpainter(
            resolution or settings.resolution(), **kwargs)

    MODEL_LIBRARY[name] = _factory
    return name


def load_model(name: str):
    return MODEL_LIBRARY[name]()


def model_names():
    return list(MODEL_LIBRARY.keys())
