"""Concurrent painters through the port's server with a batching service:
`serving.run --mesh data=1 --max-batch 4 --device cpu --tiny` on loopback,
64^2 stamps at 2 DDIM steps.

- Four websocket connections, each with its own brush (NEW_BRUSH_IMAGE,
  its preview checked), send NEW_STAMP together: each gets RETURN_STAMP,
  the service runs at least one batch of two or more, and each reply is
  byte for byte the stamp its batch computed for it (the batch run again
  on the same requests: the CPU's plain versions are deterministic at a
  batch); the painted rows come back unchanged.
- Two connections hold stroke sessions at the same time, their requests
  sent from two threads: every frame gets its reply (RETURN_ACK,
  RETURN_STAMP, RETURN_CANVAS), and each fetched canvas equals its own host
  oracle byte for byte (each stamp's window through generate_u8 of a model
  with that connection's brush, at the counter the stamp drew,
  pipeline/session.py host_stamp_update and host_erase_update); a session
  frame that fails gets RETURN_ERROR; /health reports the mesh.
"""

import json
import threading
import urllib.request

import numpy as np
import pytest
import torch
from websockets.sync.client import connect

from diffusiontexturepainting_torch.pipeline import session as t_session
from diffusiontexturepainting_torch.pipeline.torch_model import (
    TorchConditionalInpainter,
)
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_torch.serving.run import build_server

torch.set_num_threads(2)

RES = 64
SETTINGS = dict(steps=2, width=RES, cfg_weight=2.0, tg_weight=1.0,
                tg_steps=2, context_pad=150)
R = wire.RequestType


@pytest.fixture(scope="module")
def served():
    """(server, port, the recorded batches: (key, payloads, results))."""
    server = build_server(["--mesh", "data=1", "--max-batch", "4",
                           "--batch-window-ms", "500", "--device", "cpu",
                           "--tiny", "--resolution", str(RES), "--no-warmup",
                           "--host", "127.0.0.1", "--port", "0"])
    svc = server.service
    recorded = []
    run = svc._run_batch

    def recording(key, payloads):
        results = run(key, payloads)
        recorded.append((key, list(payloads), results))
        return results

    svc._run_batch = recording
    svc.dispatcher._run_batch = recording
    new_session = svc.new_session
    svc.sessions = []  # every connection's SessionModel, in order

    def recording_session():
        session = new_session()
        svc.sessions.append(session)
        return session

    svc.new_session = recording_session
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    yield server, server.socket.getsockname()[1], recorded
    server.shutdown()
    thread.join(timeout=60)


def _canvas(seed, rows, height=RES, width=RES):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((height, width, 4), np.uint8)
    canvas[:rows, :, :3] = rng.integers(0, 256, (rows, width, 3))
    canvas[:rows, :, 3] = 255
    return canvas


def _in_threads(fn, n):
    out, errors = [None] * n, []

    def go(i):
        try:
            out[i] = fn(i)
        except Exception as e:  # noqa: BLE001 - reported below
            errors.append(e)

    threads = [threading.Thread(target=go, args=(i,)) for i in range(n)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=600)
    assert not errors, errors
    return out


def test_health_reports_the_mesh(served):
    _, port, _ = served
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/health",
                                timeout=60) as resp:
        health = json.loads(resp.read())
    assert health["status"] == "ok" and health["mesh"] == "data=1"
    assert health["max_batch"] == 4 and "mesh[data=1]" in health["model"]
    assert health["batches"] == {str(n): k for n, k in
                                 served[0].service.batch_counts().items()}


def test_four_painters_batch(served):
    server, port, recorded = served
    barrier = threading.Barrier(4)
    canvases = [_canvas(10 + i, 16 + 8 * i) for i in range(4)]

    def paint(i):
        rng = np.random.default_rng(20 + i)
        brush = rng.integers(0, 256, (80, 96, 3), dtype=np.uint8)
        with connect(f"ws://127.0.0.1:{port}/websocket/", max_size=None,
                     open_timeout=60) as ws:
            ws.send(wire.encode_request(R.NEW_BRUSH_IMAGE, brush,
                                        **SETTINGS))
            kind, preview = wire.decode_response(ws.recv(timeout=600))
            assert kind == R.RETURN_PREVIEW and preview.shape == (RES, RES, 3)
            barrier.wait(timeout=600)
            ws.send(wire.encode_request(R.NEW_STAMP, canvases[i],
                                        **SETTINGS))
            kind, stamp = wire.decode_response(ws.recv(timeout=600))
        assert kind == R.RETURN_STAMP
        return np.array(stamp)

    before = len(recorded)
    stamps = _in_threads(paint, 4)
    stamp_batches = [(k, p, r) for k, p, r in recorded[before:]
                     if any(np.array_equal(q["canvas"], c)
                            for q in p for c in canvases)]
    assert max(len(p) for _, p, _ in stamp_batches) >= 2
    assert sum(len(p) for _, p, _ in stamp_batches) == 4
    svc = server.service
    for key, payloads, results in stamp_batches:
        again = type(svc)._run_batch(svc, key, payloads)
        for p, got, redo in zip(payloads, results, again):
            i = next(i for i, c in enumerate(canvases)
                     if np.array_equal(p["canvas"], c))
            assert np.array_equal(stamps[i], got)
            assert np.array_equal(got, redo)
    for i, c in enumerate(canvases):
        rows = 16 + 8 * i
        np.testing.assert_array_equal(stamps[i][:rows], c[:rows, :, :3])


# each connection's stroke on a 128 x 96 canvas: (x0, y0, return_pixels,
# overpaint), then an erase and a fetch
STROKES = [[(0, 10, False, False), (30, 20, True, True),
            (200, 200, False, False)],
           [(50, 0, False, False), (10, 30, False, False),
            (60, 25, True, False)]]
ERASES = [(40, 8, True), (-5, 40, False)]


def _oracle(model, canvas, stroke, counters, erase):
    """The session's canvas on the host: each stamp's window (centre
    cleared for overpaint) through generate_u8 at the counter it drew,
    written with host_stamp_update; then host_erase_update."""
    h, w = canvas.shape[:2]
    for (x0, y0, _, op), counter in zip(stroke, counters):
        x, y = t_session.clamped_corner(x0, y0, RES, w, h)
        window = canvas[y:y + RES, x:x + RES].copy()
        if op:
            m = t_session.overpaint_margin(RES)
            window[m:RES - m, m:RES - m] = 0
        model.request_counter = counter - 1
        comp = model.generate_u8(window, **SETTINGS)
        canvas = t_session.host_stamp_update(canvas, comp, x0, y0)
    return t_session.host_erase_update(canvas, RES, *erase[:2])


def test_two_concurrent_sessions(served):
    server, port, _ = served
    svc = server.service
    barrier = threading.Barrier(2)

    def stroke(i):
        rng = np.random.default_rng(40 + i)
        brush = rng.integers(0, 256, (RES, RES, 3), dtype=np.uint8)
        canvas = _canvas(50 + i, 30, height=96, width=128)
        with connect(f"ws://127.0.0.1:{port}/websocket/", max_size=None,
                     open_timeout=60) as ws:
            def ask(req):
                ws.send(req)
                return ws.recv(timeout=600)

            # a session frame before BEGIN_SESSION: RETURN_ERROR
            kind, msg = wire.decode_error(ask(wire.encode_fetch_canvas()))
            assert kind == R.RETURN_ERROR and "BEGIN_SESSION" in msg
            kind, _ = wire.decode_response(ask(wire.encode_request(
                R.NEW_BRUSH_IMAGE, brush, **SETTINGS)))
            assert kind == R.RETURN_PREVIEW
            assert wire.decode_ack(ask(wire.encode_begin_session(
                canvas, **SETTINGS))) == (R.RETURN_ACK, 0)
            barrier.wait(timeout=600)
            for x0, y0, px, op in STROKES[i]:
                reply = ask(wire.encode_stamp_at(x0, y0, px, op,
                                                 **SETTINGS))
                if px:
                    kind, crop = wire.decode_response(reply)
                    assert kind == R.RETURN_STAMP
                    assert crop.shape == (RES, RES, 3)
                else:
                    assert wire.decode_ack(reply)[0] == R.RETURN_ACK
            reply = ask(wire.encode_erase_at(*ERASES[i]))
            assert reply[0] == (R.RETURN_STAMP if ERASES[i][2]
                                else R.RETURN_ACK)
            kind, fetched = wire.decode_response(
                ask(wire.encode_fetch_canvas()))
            assert kind == R.RETURN_CANVAS
            fetched = np.array(fetched)
            assert wire.decode_ack(ask(wire.encode_end_session()))[0] == \
                R.RETURN_ACK
        return brush, canvas, fetched

    first = len(svc.sessions)
    got = _in_threads(stroke, 2)
    sessions = svc.sessions[first:]
    assert len(sessions) == 2
    drawn = sorted(c for s in sessions for c in s.stamp_counters)
    assert len(drawn) == 6 and len(set(drawn)) == 6
    for brush, canvas, fetched in got:
        model = TorchConditionalInpainter(RES, device="cpu", tiny=True,
                                          weights=svc.base.state_dicts())
        model.set_brush(brush)
        session = next(s for s in sessions
                       if np.array_equal(s.image, model.image))
        i = next(i for i in range(2) if got[i][1] is canvas)
        want = _oracle(model, canvas, STROKES[i], session.stamp_counters,
                       ERASES[i])
        assert fetched.shape == canvas.shape
        assert np.array_equal(fetched, want)
