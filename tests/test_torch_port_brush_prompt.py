"""NEW_BRUSH_PROMPT (request type 1) on the port: the prompt codec and the
procedural brush against the JAX package's, and the reply bytes of the
port's request handler and server against the JAX handler's."""

import logging
import threading

import numpy as np
import pytest
import torch
from websockets.sync.client import connect

from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.serving import model_base, wire
from diffusiontexturepainting_torch.serving.server import create_server
from diffusiontexturepainting_tpu.client import nvcf_txt2img
from diffusiontexturepainting_tpu.serving import server_io
from diffusiontexturepainting_tpu.serving.handler import handle_request_bytes

torch.set_num_threads(2)

RES = 64
SETTINGS = dict(steps=4, width=RES, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=4, context_pad=150)
PROMPTS = ["mossy stone", "", "ziegel — rot, 煉瓦"]


@pytest.fixture(scope="module")
def model():
    return TorchConditionalInpainter(RES, device="cpu", tiny=True)


@pytest.mark.parametrize("prompt", PROMPTS)
def test_prompt_codec_matches_server_io(prompt):
    """The request's bytes equal server_io's, and each side decodes the
    other's payload."""
    ours = wire.encode_brush_prompt_request(prompt, **SETTINGS)
    theirs = server_io.encode_brush_prompt_request(prompt, **SETTINGS)
    assert ours == theirs
    _, _, offset = server_io.decode_request_metadata(ours)
    assert wire.decode_prompt_payload(theirs, offset) == prompt
    assert server_io.decode_prompt_payload(ours, offset) == prompt
    assert ours[0] == wire.RequestType.NEW_BRUSH_PROMPT == 1


@pytest.mark.parametrize("prompt", PROMPTS)
@pytest.mark.parametrize("size", [64, 256])
def test_procedural_brush_matches_jax(prompt, size):
    got = model_base.procedural_brush(prompt, size)
    assert got.shape == (size, size, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, nvcf_txt2img.procedural_brush(
        prompt, size=size))


def test_prompt_reply_matches_jax_handler(model, monkeypatch):
    """The port's handle_request_bytes answers NEW_BRUSH_PROMPT with the
    JAX handler's bytes for the same weights, prompt and request counter
    (no key: both take the procedural brush), and leaves the model with the
    same brush."""
    monkeypatch.delenv("DTP_NVCF_API_KEY", raising=False)
    req = wire.encode_brush_prompt_request("weathered oak", **SETTINGS)
    counter = model.request_counter
    got = wire.handle_request_bytes(model, req)
    brush = model.image.copy()
    model.request_counter = counter
    want = handle_request_bytes(model, req)
    assert got == want
    np.testing.assert_array_equal(model.image, brush)
    kind, img = wire.decode_response(got)
    assert kind == wire.RequestType.RETURN_PREVIEW
    assert img.shape == (RES, RES, 3) and img.dtype == np.uint8


def test_prompt_with_key_warns_and_uses_procedural_brush(model, monkeypatch,
                                                         caplog):
    """With DTP_NVCF_API_KEY set the port calls no service: it warns once
    and sets the procedural brush."""
    monkeypatch.setenv("DTP_NVCF_API_KEY", "not-a-key")
    monkeypatch.setattr(wire, "_nvcf_key_warned", False)
    req = wire.encode_brush_prompt_request("red brick", **SETTINGS)
    with caplog.at_level(logging.WARNING, logger=wire.__name__):
        for _ in range(2):
            reply = wire.handle_request_bytes(model, req)
    warned = [r for r in caplog.records if "DTP_NVCF_API_KEY" in r.message]
    assert len(warned) == 1
    assert reply[0] == wire.RequestType.RETURN_PREVIEW
    want = model_base.ensure_float01(model_base.procedural_brush("red brick",
                                                                 RES))
    np.testing.assert_array_equal(model.image, want)


def test_prompt_over_the_websocket(model, monkeypatch):
    """The port's server routes type 1 to handle_request_bytes: the reply
    over the websocket equals the handler's at the same request counter."""
    monkeypatch.delenv("DTP_NVCF_API_KEY", raising=False)
    srv = create_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    try:
        port = srv.socket.getsockname()[1]
        req = wire.encode_brush_prompt_request("sand dune", **SETTINGS)
        counter = model.request_counter
        with connect(f"ws://127.0.0.1:{port}/websocket/", max_size=None,
                     open_timeout=30) as ws:
            ws.send(req)
            raw = ws.recv(timeout=300)
    finally:
        srv.shutdown()
        thread.join(timeout=30)
    model.request_counter = counter
    assert raw == wire.handle_request_bytes(model, req)
    assert wire.decode_response(raw)[0] == wire.RequestType.RETURN_PREVIEW
