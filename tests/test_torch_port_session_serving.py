"""Stroke sessions through the port's serving layers: the session codec of
serving/wire.py byte for byte against the JAX package's server_io, the
request handler against the JAX package's handler on the same model and
the same bytes, the model's resident canvas against the host oracle
(per-request stamps replayed at the same request counters), and the
port's server: acknowledgements of stamps that return no pixels,
RETURN_ERROR replies, one owning connection, and release on close.

The tiny model on the CPU, 64^2 stamps at 2 DDIM steps.
"""

import threading
import time

import numpy as np
import pytest
import torch
from websockets.sync.client import connect

from diffusiontexturepainting_torch.pipeline import session as t_session
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter)
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_torch.serving.server import create_server
from diffusiontexturepainting_tpu.serving import server_io
from diffusiontexturepainting_tpu.serving.handler import (
    _handle_session_request,
    handle_request_bytes,
)

torch.set_num_threads(2)

RES = 64
SETTINGS = dict(steps=2, width=RES, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=2, context_pad=150)
R = wire.RequestType


@pytest.fixture(scope="module")
def model():
    return TorchConditionalInpainter(RES, device="cpu", tiny=True)


def _canvas(height=96, width=128):
    rng = np.random.default_rng(5)
    canvas = np.zeros((height, width, 4), np.uint8)
    canvas[:30, :, :3] = rng.integers(0, 256, (30, width, 3))
    canvas[:30, :, 3] = 255
    return canvas


# (x0, y0, return_pixels, overpaint) of the stroke's stamps; the third
# clamps to the canvas's bottom-right corner
STROKE = [(0, 10, False, False), (30, 20, False, True),
          (200, 200, False, False), (40, 16, True, False)]
ERASES = [(50, 0, False), (-5, 40, True)]


def _session_bytes(canvas):
    return ([wire.encode_begin_session(canvas, **SETTINGS)]
            + [wire.encode_stamp_at(x, y, px, op, **SETTINGS)
               for x, y, px, op in STROKE]
            + [wire.encode_erase_at(x, y, px) for x, y, px in ERASES]
            + [wire.encode_fetch_canvas(), wire.encode_end_session()])


def test_session_codec_matches_server_io():
    """Every session request and reply encodes to server_io's bytes and
    decodes back."""
    canvas = _canvas()
    S = server_io
    pairs = [
        (wire.encode_begin_session(canvas, **SETTINGS),
         S.encode_begin_session_request(canvas, **SETTINGS)),
        (wire.encode_stamp_at(-3, 70000, False, True, **SETTINGS),
         S.encode_stamp_at_request(-3, 70000, False, True, **SETTINGS)),
        (wire.encode_stamp_at(5, 6), S.encode_stamp_at_request(5, 6)),
        (wire.encode_erase_at(1, 2, False),
         S.encode_erase_at_request(1, 2, False)),
        (wire.encode_fetch_canvas(), S.encode_fetch_canvas_request()),
        (wire.encode_end_session(), S.encode_end_session_request()),
        (wire.encode_ack(2**32 + 7), S.encode_ack_response(2**32 + 7)),
        (wire.encode_error("x" * 5000), S.encode_error_response("x" * 5000)),
        (wire.encode_error("bad é"), S.encode_error_response("bad é")),
    ]
    for got, want in pairs:
        assert got == want
    assert wire.decode_ack(S.encode_ack_response(9)) == (R.RETURN_ACK, 9)
    assert wire.decode_error(S.encode_error_response("bad é")) == (
        R.RETURN_ERROR, "bad é")
    raw = S.encode_stamp_at_request(-3, 12, False, True)
    _, _, offset = S.decode_request_metadata(raw)
    assert wire.decode_coords(raw, offset) == S.decode_coords_payload(
        raw, offset)
    for kind in R:
        assert S.RequestType(kind.value).name == kind.name
        assert wire.is_session_request(kind) == (16 <= kind <= 20)


def test_session_handler_matches_jax_handler(model):
    """wire.handle_request_bytes answers a whole stroke session with the
    bytes the JAX package's handler gives for the same requests on the same
    model from the same request counter, and so does the port's
    handle_session_request beside the JAX _handle_session_request."""
    requests = _session_bytes(_canvas())
    counter = model.request_counter
    got = [wire.handle_request_bytes(model, raw) for raw in requests]
    model.request_counter = counter
    want = [handle_request_bytes(model, raw) for raw in requests]
    assert got == want
    model.request_counter = counter
    direct = [_handle_session_request(model, raw, raw[0])
              for raw in requests]
    assert direct == want
    assert [r[0] for r in got] == (
        [R.RETURN_ACK] * 4 + [R.RETURN_STAMP, R.RETURN_ACK, R.RETURN_STAMP,
                              R.RETURN_CANVAS, R.RETURN_ACK])
    assert [wire.decode_ack(r)[1] for r in got if r[0] == R.RETURN_ACK] == \
        [0, 1, 2, 3, 4, 5]
    assert not model.session_active()


def test_session_canvas_matches_host_oracle(model):
    """The fetched canvas of a session equals the host oracle: each stamp's
    crop (centre cleared for overpaint) replayed through generate_u8 at the
    stamp's request counter, written with host_stamp_update, then the
    erases with host_erase_update. The pixel-returning requests' crops
    equal the oracle's."""
    canvas = _canvas()
    first = model.request_counter + 1
    model.begin_session(canvas)
    crops = [model.stamp_at(x, y, px, op, **SETTINGS)
             for x, y, px, op in STROKE]
    erased = [model.erase_at(x, y, px) for x, y, px in ERASES]
    got = model.fetch_canvas()
    model.sync_session()
    model.end_session()
    oracle = canvas
    for k, (x, y, px, op) in enumerate(STROKE):
        cx, cy = t_session.clamped_corner(x, y, RES, canvas.shape[1],
                                          canvas.shape[0])
        crop = oracle[cy:cy + RES, cx:cx + RES].copy()
        if op:
            m = t_session.overpaint_margin(RES)
            crop[m:RES - m, m:RES - m] = 0
        model.request_counter = first + k - 1
        comp = model.generate_u8(crop, **SETTINGS)
        assert (crops[k] is None) != px
        if px:
            np.testing.assert_array_equal(crops[k], comp)
        oracle = t_session.host_stamp_update(oracle, comp, x, y)
    for (x, y, px), crop in zip(ERASES, erased):
        oracle = t_session.host_erase_update(oracle, RES, x, y)
        cx, cy = t_session.clamped_corner(x, y, RES, canvas.shape[1],
                                          canvas.shape[0])
        if px:
            np.testing.assert_array_equal(
                crop, oracle[cy:cy + RES, cx:cx + RES, :3])
    np.testing.assert_array_equal(got, oracle)
    # the clamped stamp painted the bottom-right corner's window
    assert (got[95 - RES + 2:95, 127 - 10:127, 3] == 255).all()


@pytest.fixture(scope="module")
def server(model):
    srv = create_server(model, "127.0.0.1", 0)
    thread = threading.Thread(target=srv.serve_forever, daemon=True)
    thread.start()
    yield srv.socket.getsockname()[1]
    srv.shutdown()
    thread.join(timeout=30)
    assert not thread.is_alive()


def _ws(port):
    return connect(f"ws://127.0.0.1:{port}/websocket/", max_size=None,
                   open_timeout=30)


def test_served_session_matches_handler(model, server):
    """A session over the websocket: a stamp before BEGIN_SESSION gets
    RETURN_ERROR; then every reply equals the request handler's on the same
    bytes from the same request counter."""
    requests = _session_bytes(_canvas())
    with _ws(server) as ws:
        ws.send(wire.encode_stamp_at(0, 0, False, **SETTINGS))
        kind, message = wire.decode_error(ws.recv(timeout=60))
        assert kind == R.RETURN_ERROR
        assert message == ("RuntimeError: no active stroke session "
                           "(BEGIN_SESSION first)")
        counter = model.request_counter
        replies = []
        for raw in requests:
            ws.send(raw)
            replies.append(ws.recv(timeout=300))
    model.request_counter = counter
    assert replies == [wire.handle_request_bytes(model, raw)
                       for raw in requests]


def _wait_inactive(model, seconds=30):
    deadline = time.monotonic() + seconds
    while model.session_active() and time.monotonic() < deadline:
        time.sleep(0.05)
    return not model.session_active()


def test_served_session_ownership_and_release(model, server):
    """One connection holds the session: another connection's session
    frames get RETURN_ERROR while it is active, its other requests are
    served, and closing the holder ends its session."""
    begin = wire.encode_begin_session(_canvas(), **SETTINGS)
    held = "stroke session held by another connection"
    with _ws(server) as second:
        with _ws(server) as first:
            first.send(begin)
            assert wire.decode_ack(first.recv(timeout=60)) == (R.RETURN_ACK,
                                                               0)
            for raw in (begin, wire.encode_stamp_at(0, 0, False,
                                                    **SETTINGS),
                        wire.encode_fetch_canvas()):
                second.send(raw)
                assert wire.decode_error(second.recv(timeout=60)) == (
                    R.RETURN_ERROR, held)
            second.send(wire.encode_request(R.NEW_STAMP,
                                            np.zeros((RES, RES, 4),
                                                     np.uint8), **SETTINGS))
            assert wire.decode_response(second.recv(timeout=300))[0] == \
                R.RETURN_STAMP
            first.send(wire.encode_stamp_at(3, 3, False, **SETTINGS))
            assert wire.decode_ack(first.recv(timeout=300)) == (R.RETURN_ACK,
                                                                1)
        assert _wait_inactive(model)
        second.send(begin)
        assert wire.decode_ack(second.recv(timeout=60)) == (R.RETURN_ACK, 0)
        second.send(wire.encode_end_session())
        assert wire.decode_ack(second.recv(timeout=60)) == (R.RETURN_ACK, 1)
    assert not model.session_active()
