"""The port's serving model behind its own server and request handler
(answering as the JAX package's handler does), and the rule that the port
imports neither JAX, nor the JAX package, nor tornado, nor Pillow (the
card's machine has none of them)."""

import json
import subprocess
import sys
import threading
import urllib.error
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from websockets.sync.client import connect

from diffusiontexturepainting_torch.pipeline.inpaint import preview_canvas_u8
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_torch.serving.server import (
    MAX_MESSAGE_BYTES,
    create_server,
)
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
    pulling in jax, any module of the JAX package, tornado or PIL."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import diffusiontexturepainting_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in\n"
        "       ('jax', 'diffusiontexturepainting_tpu', 'tornado', 'PIL')]\n"
        "assert not bad, bad\n"
        "for m in ('serving.server', 'serving.run', 'ops.conv_variants',\n"
        "          'ops.attention_variants', 'tools.attn_variants',\n"
        "          'tools.attn_sublane', 'tools.pv_transpose',\n"
        "          'tools.conv_shift_cost', 'tools.stream_pipeline',\n"
        "          'client.mock_model', 'weights.loader',\n"
        "          'schedulers.base', 'schedulers.ddim',\n"
        "          'schedulers.dpm_solver', 'schedulers.euler_ancestral',\n"
        "          'schedulers.lms', 'schedulers.pndm',\n"
        "          'tools.check_fidelity', 'tools.deepcache_split',\n"
        "          'training.train', 'models.lora', 'parallel.mesh',\n"
        "          'parallel.serving', 'serving.parallel_model',\n"
        "          'core.engine', 'ops.constants'):\n"
        "    assert p.__name__ + '.' + m in sys.modules, m\n")
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


def test_server_entry_point_imports_without_tornado():
    """The card's machine has no tornado: the server and its entry point
    import with tornado made unimportable."""
    code = (
        "import sys\n"
        "sys.modules['tornado'] = None\n"
        "import diffusiontexturepainting_torch.serving.run as r\n"
        "import diffusiontexturepainting_torch.serving.server\n"
        "r.run_main(['--help'])\n")
    proc = subprocess.run([sys.executable, "-c", code], timeout=300,
                          cwd=PKG.parent, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr
    for flag in ("--resolution", "--config", "--port"):
        assert flag in proc.stdout


@pytest.fixture(scope="module")
def server(model):
    """The port's create_server on a free localhost port, in a thread."""
    srv = create_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.socket.getsockname()[1]
    srv.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _request(kind, image):
    return (server_io.encode_request_type(kind)
            + server_io.encode_inference_settings(**SETTINGS)
            + server_io.image_to_binary(image))


def test_served_brush_and_stamp(model, server):
    """/health, then a brush and a stamp over the websocket, each reply the
    JAX package's handler's bytes at the same request counter; a bad frame
    is dropped and the connection stays open."""
    R = server_io.RequestType
    with urllib.request.urlopen(f"http://127.0.0.1:{server}/health",
                                timeout=30) as resp:
        assert json.loads(resp.read()) == {
            "status": "ok", "model": "TorchConditionalInpainter"}
    rng = np.random.default_rng(0)
    brush = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    canvas = np.zeros((RES, RES, 4), np.uint8)
    canvas[:16, :, 3] = 255
    canvas[:16, :, :3] = 64
    with connect(f"ws://127.0.0.1:{server}/websocket/", max_size=None,
                 open_timeout=30) as ws:
        for kind, image, want_type in (
                (R.NEW_BRUSH_IMAGE, brush, R.RETURN_PREVIEW),
                (R.NEW_STAMP, canvas, R.RETURN_STAMP)):
            req = _request(kind, image)
            counter = model.request_counter
            ws.send(req)
            raw = ws.recv(timeout=300)
            reply = server_io.decode_response(raw)
            assert reply["type"] == want_type.value
            assert np.asarray(reply["image"]).shape == (RES, RES, 3)
            after = model.request_counter
            model.request_counter = counter
            assert handle_request_bytes(model, req) == raw, kind
            model.request_counter = after
        img = np.asarray(reply["image"])
        assert np.abs(img[:16].astype(int) - 64).max() <= 1
        assert img[16:].std() > 1.0
        ws.send(b"\xff")  # an unknown request type: logged, no reply
        ws.send("{}")  # a text frame: logged, no reply
        ws.send(req)
        assert server_io.decode_response(ws.recv(timeout=300))["type"] \
            == R.RETURN_STAMP.value


def test_server_routes(server):
    with pytest.raises(urllib.error.HTTPError) as err:
        urllib.request.urlopen(f"http://127.0.0.1:{server}/inpaint",
                               timeout=30)
    assert err.value.code == 404


def test_frame_limit_takes_a_1024_canvas():
    """A 1024^2 RGBA NEW_STAMP request fits the server's message limit."""
    req = wire.encode_request(wire.RequestType.NEW_STAMP,
                              np.zeros((1024, 1024, 4), np.uint8))
    assert len(req) <= MAX_MESSAGE_BYTES


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
    """Session requests the model does not serve raise: a stamp, an erase
    or a fetch with no session begun, and a canvas that is not (H, W, 4)
    uint8 of at least the stamp's size."""
    assert not model.session_active()
    for call in (lambda: model.stamp_at(0, 0), lambda: model.erase_at(0, 0),
                 model.fetch_canvas, model.sync_session):
        with pytest.raises(RuntimeError, match="no active stroke session"):
            call()
    for bad in (np.zeros((RES, RES, 3), np.uint8),
                np.zeros((RES - 1, 2 * RES, 4), np.uint8),
                np.zeros((RES, RES, 4), np.float32)):
        with pytest.raises(ValueError):
            model.begin_session(bad)
    assert not model.session_active()
