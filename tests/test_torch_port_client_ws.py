"""The port's websocket client (client/websocket_model.py) against the JAX
package's, on the CPU.

Both clients drive one scripted sequence (a brush, an empty-mask generate
that never reaches the server, the deferred NEW_BRUSH_IMAGE, a NEW_STAMP, a
stroke session with fire-and-forget stamps, a pixel-returning stamp, an
erase, a fetch, the end, a STAMP_AT outside a session, a brush prompt)
through a recording fake socket that each answers with its own package's
request handler over its own mock model: the frames sent are equal byte
for byte, and so are the values returned. Then one round trip of the port's
client and its TexturePainter against the port's server with --mock on a
loopback port.
"""

import threading

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch.client import websocket_model as pws
from diffusiontexturepainting_torch.client.mesh_io import make_unit_quad
from diffusiontexturepainting_torch.client.mock_model import (
    MockConditionalInpainter as PortMock)
from diffusiontexturepainting_torch.client.painter import TexturePainter
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_torch.serving.run import build_server
from diffusiontexturepainting_tpu.client import websocket_model as jws
from diffusiontexturepainting_tpu.client.mock_model import (
    MockConditionalInpainter as JaxMock)
from diffusiontexturepainting_tpu.serving import server_io
from diffusiontexturepainting_tpu.serving.handler import (
    handle_request_bytes as jax_handle)

torch.set_num_threads(2)

RES = 64
SETTINGS = dict(steps=4, width=RES, context_pad=30, cfg_weight=2.5,
                tg_weight=0.5, tg_steps=3)


class RecordingSocket:
    """A websocket that records each frame sent and queues the handler's
    reply to it (a session request that returns no pixels is answered at
    once, as the server does); a session request that fails is answered
    RETURN_ERROR "<type>: <message>", as both servers answer it."""

    def __init__(self, handle):
        self.handle, self.sent, self.replies = handle, [], []

    def send(self, data):
        self.sent.append(bytes(data))
        try:
            reply = self.handle(bytes(data))
        except RuntimeError as e:
            assert wire.is_session_request(data[0])
            reply = wire.encode_error(f"{type(e).__name__}: {e}")
        self.replies.append(reply)

    def recv(self, timeout=None):
        return self.replies.pop(0)

    def close(self):
        pass


def _script(client):
    """The scripted sequence; returns what each call returned."""
    rng = np.random.default_rng(4)
    out = []
    client.set_brush(rng.integers(0, 256, (80, 96, 3), dtype=np.uint8))
    empty = np.zeros((RES, RES, 4), np.float32)
    out.append(client.generate(empty, **SETTINGS))
    canvas = empty.copy()
    canvas[:20, :, :3] = 0.25
    canvas[:20, :, 3] = 1.0
    out.append(client.generate(canvas, **SETTINGS))  # NEW_BRUSH_IMAGE
    out.append(client.generate(canvas, **SETTINGS))  # NEW_STAMP
    session = np.zeros((96, 128, 4), np.uint8)
    session[:40, :, 3] = 255
    client.begin_session(session)
    for x0, y0 in ((0, 0), (40, 10), (90, 50)):
        out.append(client.stamp_at(x0, y0, return_pixels=False, wait=False,
                                   **SETTINGS))
    out.append(client.stamp_at(20, 20, overpaint=True, **SETTINGS))
    out.append(client.erase_at(10, 30, return_pixels=False, wait=False))
    out.append(client.fetch_canvas())
    client.end_session()
    out.append(type(pytest.raises(RuntimeError, client.stamp_at, 0, 0,
                                  **SETTINGS).value).__name__)
    client.set_brush(rng.integers(0, 256, (64, 64, 3), dtype=np.uint8))
    out.append(client.set_brush_prompt("mossy stone", **SETTINGS))
    out.append(client.generate(canvas, **SETTINGS))  # no brush send
    return out


def test_frames_equal_jax(monkeypatch):
    monkeypatch.delenv("DTP_NVCF_API_KEY", raising=False)
    runs = []
    for mod, model, handle in ((jws, JaxMock(RES), jax_handle),
                               (pws, PortMock(RES),
                                wire.handle_request_bytes)):
        sock = RecordingSocket(lambda raw, m=model, h=handle: h(m, raw))
        seen = {}

        def connect(url, **kw):
            seen.update(url=url, **kw)
            return sock

        monkeypatch.setattr(mod, "connect", connect)
        client = mod.WebsocketConditionalInpainter("127.0.0.1:1/websocket/",
                                                   resolution=RES)
        runs.append((sock.sent, _script(client), seen))
        assert not sock.replies
    (jsent, jout, jseen), (psent, pout, pseen) = runs
    assert pseen == jseen == {"url": "ws://127.0.0.1:1/websocket/",
                              "open_timeout": 30.0, "max_size": None,
                              "ping_interval": None}
    assert len(psent) == len(jsent) == 13
    for k, (a, b) in enumerate(zip(psent, jsent)):
        assert a == b, k
    kinds = [f[0] for f in psent]
    assert kinds[:2] == [wire.RequestType.NEW_BRUSH_IMAGE,
                         wire.RequestType.NEW_STAMP]
    assert kinds[-2:] == [wire.RequestType.NEW_BRUSH_PROMPT,
                          wire.RequestType.NEW_STAMP]
    assert len(pout) == len(jout)
    for a, b in zip(pout, jout):
        if isinstance(a, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b)
        else:
            assert a == b
    assert pout[-3] == "ServerError" and issubclass(wire.ServerError,
                                                   RuntimeError)


def test_ack_errors_raise_server_error():
    """A RETURN_ERROR where an acknowledgement is due raises ServerError,
    and the request no longer counts as in flight."""
    client = pws.WebsocketConditionalInpainter.__new__(
        pws.WebsocketConditionalInpainter)
    client.ws = RecordingSocket(None)
    client.ws.replies = [wire.encode_error("no session"), wire.encode_ack(3)]
    client._inflight = 2
    with pytest.raises(wire.ServerError, match="no session"):
        client._drain_acks()
    assert client._inflight == 1
    client._drain_acks()
    assert client._inflight == 0
    assert server_io.decode_error_response(wire.encode_error("x")) == {
        "type": server_io.RequestType.RETURN_ERROR.value, "message": "x"}


def test_round_trip_against_the_port_mock_server():
    """`serving.run --mock` on a loopback port: the client's stamps and a
    TexturePainter stroke over it, the painted region preserved."""
    server = build_server(["--mock", "--host", "127.0.0.1", "--port", "0",
                           "--resolution", str(RES)])
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        port = server.socket.getsockname()[1]
        client = pws.WebsocketConditionalInpainter(
            f"ws://127.0.0.1:{port}/websocket/", resolution=RES)
        brush = np.full((RES, RES, 3), 0.6, np.float32)
        client.set_brush(brush)
        canvas = np.zeros((RES, RES, 4), np.float32)
        canvas[:16, :, :3], canvas[:16, :, 3] = 0.25, 1.0
        for _ in range(2):
            raw = client.generate_raw(canvas, **SETTINGS)
            assert raw.shape == (RES, RES, 3)
            np.testing.assert_allclose(raw[16:], 0.6, atol=1 / 255 + 1e-6)
        texture = np.zeros((RES, RES, 4), np.float32)
        texture[:, :RES // 2, :3], texture[:, :RES // 2, 3] = 0.25, 1.0
        painter = TexturePainter(client, make_unit_quad(), texture_width=RES,
                                 texture=texture, device="cpu")
        painter.model_settings = dict(SETTINGS)
        for x in (-0.3, 0.3):
            painter.stamp(np.array([x, 0, 0]), np.array([0, 0, 1.0]),
                          radius=0.5)
        got = painter.texture.numpy()
        assert (got[..., 3] > 0).mean() > 0.5
        np.testing.assert_allclose(got[16:48, 8:24, :3], 0.25,
                                   atol=1 / 255 + 1e-6)
        np.testing.assert_allclose(got[16:48, 40:56, :3], 0.6,
                                   atol=1 / 255 + 1e-6)
        client.close()
    finally:
        server.shutdown()
        thread.join(timeout=30)
    assert not thread.is_alive()
