"""The port's serving model behind the JAX package's framework-free server
and behind the port's own request handler, and the rule that the port
imports neither JAX nor the JAX package."""

import json
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.pipeline.inpaint import preview_canvas_u8
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_tpu.serving import server_io
from diffusiontexturepainting_tpu.serving.handler import handle_request_bytes
from diffusiontexturepainting_tpu.serving.model_base import (
    ConditionalInpainterBase)

torch.set_num_threads(2)

PKG = Path(__file__).resolve().parent.parent / "diffusiontexturepainting_torch"
RES = 64
SETTINGS = dict(steps=4, width=RES, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=4, context_pad=150)


def test_port_imports_without_jax():
    """Every module of the package imports in a fresh interpreter without
    pulling in jax or any module of the JAX package."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusiontexturepainting_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'diffusiontexturepainting_tpu')]\n"
        "print(len(sys.modules)); assert not bad, bad\n")
    subprocess.run([sys.executable, "-c", code], check=True, timeout=300,
                   cwd=PKG.parent)


def test_port_sources_have_no_jax_import():
    offenders = [
        f"{path}:{i}" for path in PKG.rglob("*.py")
        for i, line in enumerate(path.read_text().splitlines(), 1)
        if line.lstrip().startswith(("import jax", "from jax"))]
    assert not offenders


@pytest.fixture(scope="module")
def model():
    return TorchConditionalInpainter(RES, device="cpu", tiny=True)


@pytest.fixture(scope="module")
def server(model):
    """create_server(model=...) on a localhost port in its own IOLoop."""
    import asyncio

    import tornado.httpserver
    import tornado.ioloop
    import tornado.netutil

    from diffusiontexturepainting_tpu.serving.run import create_server

    holder, started = {}, threading.Event()

    def run():
        asyncio.set_event_loop(asyncio.new_event_loop())
        loop = tornado.ioloop.IOLoop.current()
        sockets = tornado.netutil.bind_sockets(0, "127.0.0.1")
        tornado.httpserver.HTTPServer(create_server(model=model)) \
            .add_sockets(sockets)
        holder.update(loop=loop, port=sockets[0].getsockname()[1])
        started.set()
        loop.start()

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    assert started.wait(timeout=30)
    yield holder["port"]
    holder["loop"].add_callback(holder["loop"].stop)
    thread.join(timeout=30)
    assert not thread.is_alive()


def _request(kind, image):
    return (server_io.encode_request_type(kind)
            + server_io.encode_inference_settings(**SETTINGS)
            + server_io.image_to_binary(image))


def _post(port, body):
    req = urllib.request.Request(f"http://127.0.0.1:{port}/inpaint",
                                 data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as resp:
        return resp.read()


def test_served_brush_and_stamp(model, server):
    R = server_io.RequestType
    with urllib.request.urlopen(f"http://127.0.0.1:{server}/health",
                                timeout=30) as resp:
        assert json.loads(resp.read())["model"] == "TorchConditionalInpainter"
    rng = np.random.default_rng(0)
    brush = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    preview = server_io.decode_response(_post(server,
                                              _request(R.NEW_BRUSH_IMAGE,
                                                       brush)))
    assert preview["type"] == R.RETURN_PREVIEW.value
    assert np.asarray(preview["image"]).shape == (RES, RES, 3)

    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:16, :, 3] = 255
    canvas[:16, :, :3] = 64
    stamp_req = _request(R.NEW_STAMP, canvas)
    first = model.request_counter + 1
    reply = server_io.decode_response(_post(server, stamp_req))
    img = np.asarray(reply["image"])
    assert reply["type"] == R.RETURN_STAMP.value
    assert img.shape == (RES, RES, 3) and img.dtype == np.uint8
    assert np.abs(img[:16].astype(int) - 64).max() <= 1
    assert img[16:].std() > 1.0
    # the same request counter gives the same bytes, through the handler
    model.request_counter = first - 1
    again = server_io.decode_response(handle_request_bytes(model, stamp_req))
    np.testing.assert_array_equal(np.asarray(again["image"]), img)


def test_preview_canvas_matches_model_base(model):
    """The on-device preview canvas equals the JAX package's
    create_preview_brush_context, quantized as a stamp quantizes it."""
    brush = np.random.default_rng(1).random((RES, RES, 3)).astype(np.float32)
    ctx = model.create_preview_brush_context(brush)
    np.testing.assert_array_equal(
        ctx, ConditionalInpainterBase.create_preview_brush_context(model,
                                                                   brush))
    want = (np.clip(ctx, 0.0, 1.0) * 255).astype(np.uint8)
    got = preview_canvas_u8(torch.from_numpy(brush)[None])[0].numpy()
    np.testing.assert_array_equal(got, want)


def test_port_handler_matches_jax_handler(model):
    """wire.handle_request_bytes (what chip_smoke.py drives) answers a brush
    change and a stamp with the bytes the JAX package's handler gives for
    the same requests and request counters."""
    brush = np.random.default_rng(3).integers(0, 256, (70, 50, 3), np.uint8)
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:, :20, 3] = 255
    canvas[:, :20, :3] = 180
    for kind, image in ((wire.RequestType.NEW_BRUSH_IMAGE, brush),
                        (wire.RequestType.NEW_STAMP, canvas)):
        req = wire.encode_request(kind, image, **SETTINGS)
        counter = model.request_counter
        got = wire.handle_request_bytes(model, req)
        model.request_counter = counter
        want = handle_request_bytes(model, req)
        assert got == want, kind


def test_sessions_raise_not_implemented(model):
    assert not model.session_active()
    with pytest.raises(NotImplementedError):
        model.begin_session(np.zeros((RES, RES, 4), np.uint8))
    with pytest.raises(NotImplementedError):
        model.stamp_at(0, 0)
