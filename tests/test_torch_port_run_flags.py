"""The port's server entry point (serving/run.py build_server) with the JAX
package's single-chip flags, on tiny CPU models and the mock; and HTTP
POST /inpaint on the websocket's port (serving/server.py).

- POST /inpaint: the reply byte-equal to wire.handle_request_bytes at the
  same request counter, application/octet-stream; 400 with the JAX
  package's JSON message for the session types, 400 {"error": ...} for a
  request that fails; the websocket and /health still served on the port.
- --mock: no torch imported; its replies byte-equal to the JAX mock's
  through the JAX package's handle_request_bytes, every request type.
- --debug_dir: the JAX handler's file names ({time:.3f}_{tag}_{name}.npy).
- --profile-dir: Chrome JSON traces, capped at PROFILE_TRACE_CAP a process
  with one warning.
- --warmup-points / --session-canvas / --no-warmup: the parsing (a third
  field is a DeepCache spec, an interval >= 1 or a pattern), the warm-ups
  run, the request counter put back: a warmed server's first reply equals
  a cold server's.
- --checkpoint_dir and --scheduler: the weights and the scheduler served;
  /health says "(random weights)" only without a checkpoint.
"""

import http.client
import json
import logging
import os
import re
import subprocess
import sys
import threading
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch
from websockets.sync.client import connect

from diffusiontexturepainting_torch.serving import run as t_run
from diffusiontexturepainting_torch.serving import server as t_server
from diffusiontexturepainting_torch.serving import wire
from diffusiontexturepainting_torch.weights import loader as t_loader

torch.set_num_threads(2)

PKG = Path(wire.__file__).resolve().parents[1]
RES, STEPS = 64, 2
R = wire.RequestType
TINY = ["--host", "127.0.0.1", "--port", "0", "--device", "cpu", "--tiny",
        "--resolution", str(RES)]


class Serving:
    """A built server running in a thread; .port, .model, .url()."""

    def __init__(self, argv):
        self.server = t_run.build_server(argv)
        self.model = self.server.model
        self.port = self.server.socket.getsockname()[1]
        self.thread = threading.Thread(target=self.server.serve_forever,
                                       daemon=True)
        self.thread.start()

    def close(self):
        self.server.shutdown()
        self.thread.join(timeout=30)
        assert not self.thread.is_alive()


@pytest.fixture
def serving():
    started = []

    def start(argv):
        s = Serving(argv)
        started.append(s)
        return s

    yield start
    for s in started:
        s.close()


def post(port, body, path="/inpaint", headers=None):
    conn = http.client.HTTPConnection("127.0.0.1", port, timeout=120)
    conn.request("POST", path, body=body, headers=headers or {})
    resp = conn.getresponse()
    out = resp.status, resp.getheader("Content-Type"), resp.read()
    conn.close()
    return out


def stamp_request(res=RES, steps=STEPS, seed=0):
    rng = np.random.default_rng(seed)
    canvas = np.zeros((res, res, 4), np.uint8)
    canvas[:res // 3, :, :3] = rng.integers(0, 256, (res // 3, res, 3))
    canvas[:res // 3, :, 3] = 255
    return wire.encode_request(R.NEW_STAMP, canvas, steps=steps, width=res,
                               tg_weight=1.0, tg_steps=steps)


def brush_request():
    brush = np.random.default_rng(5).integers(0, 256, (50, 70, 3),
                                              dtype=np.uint8)
    return wire.encode_request(R.NEW_BRUSH_IMAGE, brush, steps=STEPS,
                               width=RES)


def test_post_inpaint_matches_the_handler(serving):
    s = serving(TINY + ["--no-warmup"])
    for raw in (brush_request(), stamp_request(),
                wire.encode_brush_prompt_request("moss", steps=STEPS)):
        counter = s.model.request_counter
        status, ctype, body = post(s.port, raw)
        assert status == 200 and ctype == "application/octet-stream"
        s.model.request_counter = counter
        assert body == wire.handle_request_bytes(s.model, raw)
    # the websocket and /health on the same port
    with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/health",
                                timeout=60) as resp:
        assert json.loads(resp.read())["status"] == "ok"
    raw = stamp_request(seed=1)
    counter = s.model.request_counter
    with connect(f"ws://127.0.0.1:{s.port}/websocket/", max_size=None,
                 open_timeout=60) as ws:
        ws.send(raw)
        reply = ws.recv(timeout=300)
    s.model.request_counter = counter
    assert reply == post(s.port, raw)[2]


def test_post_refuses_sessions_and_garbage(serving):
    s = serving(TINY + ["--no-warmup"])
    canvas = np.zeros((RES, RES, 4), np.uint8)
    for raw in (wire.encode_begin_session(canvas), wire.encode_stamp_at(0, 0),
                wire.encode_end_session()):
        status, ctype, body = post(s.port, raw)
        assert status == 400 and ctype.startswith("application/json")
        assert json.loads(body) == {"error": t_server.SESSION_OVER_HTTP}
    assert not s.model.session_active()
    for raw in (b"", b"\x02garbage", bytes([9]) + bytes(40)):
        status, _, body = post(s.port, raw)
        assert status == 400 and "error" in json.loads(body)
    status, _, _ = post(s.port, stamp_request(), path="/other")
    assert status == 404
    # a client that waits for 100 Continue before its body
    status, _, body = post(s.port, brush_request(),
                           headers={"Expect": "100-continue"})
    assert status == 200 and body[0] == R.RETURN_PREVIEW


def test_session_message_is_the_jax_servers():
    """The 400 message of a session type over POST, as the JAX package's
    InpaintHTTPHandler words it."""
    src = (PKG.parent / "diffusiontexturepainting_tpu" / "serving"
           / "run.py").read_text()
    words = re.sub(r'"\s+"', "", src[src.index('"stroke-session requests'):
                                   src.index('connection-scoped)"') + 20])
    assert t_server.SESSION_OVER_HTTP in words


def mock_requests():
    rng = np.random.default_rng(3)
    brush = rng.integers(0, 256, (90, 120, 3), dtype=np.uint8)
    canvas = rng.integers(0, 256, (RES, RES, 4), dtype=np.uint8)
    canvas[..., 3] = np.where(canvas[..., 3] > 128, 255, 0)
    big = rng.integers(0, 256, (2 * RES, 2 * RES, 4), dtype=np.uint8)
    session = rng.integers(0, 256, (100, 130, 4), dtype=np.uint8)
    return [
        wire.encode_request(R.NEW_BRUSH_IMAGE, brush, steps=3),
        wire.encode_request(R.NEW_STAMP, canvas),
        wire.encode_request(R.NEW_STAMP, big),
        wire.encode_request(R.NEW_STAMP, canvas.astype(np.uint8) // 2),
        wire.encode_brush_prompt_request("mossy stone"),
        wire.encode_request(R.NEW_STAMP, canvas),
        wire.encode_begin_session(session),
        wire.encode_stamp_at(10, 20, return_pixels=False),
        wire.encode_stamp_at(50, -5, return_pixels=True, overpaint=True),
        wire.encode_erase_at(70, 30, return_pixels=True),
        wire.encode_erase_at(0, 0, return_pixels=False),
        wire.encode_fetch_canvas(),
        wire.encode_end_session(),
    ]


def test_mock_replies_equal_the_jax_mocks(serving, monkeypatch):
    from diffusiontexturepainting_tpu.client.mock_model import (
        MockConditionalInpainter as JaxMock)
    from diffusiontexturepainting_tpu.serving import handler as j_handler

    monkeypatch.delenv("DTP_NVCF_API_KEY", raising=False)
    s = serving(["--mock", "--host", "127.0.0.1", "--port", "0",
                 "--resolution", str(RES)])
    assert s.server.model_info == "mock"
    jax_mock, direct = JaxMock(RES), JaxMock(RES)
    with connect(f"ws://127.0.0.1:{s.port}/websocket/", max_size=None,
                 open_timeout=60) as ws:
        for raw in mock_requests():
            want = j_handler.handle_request_bytes(jax_mock, raw)
            if wire.is_session_request(raw[0]):
                ws.send(raw)
                got = ws.recv(timeout=60)
            else:
                got = post(s.port, raw)[2]
            assert got == want, raw[0]
            assert j_handler.handle_request_bytes(direct, raw) == want


def test_mock_imports_no_torch():
    """--mock builds no torch model and touches no card: the server is
    built and answers a stamp and a stroke session with torch never
    imported."""
    code = (
        "import sys\n"
        "from diffusiontexturepainting_torch.serving import run, wire\n"
        "import numpy as np\n"
        "s = run.build_server(['--mock', '--host', '127.0.0.1', '--port',"
        " '0', '--resolution', '64'])\n"
        "raw = wire.encode_request(wire.RequestType.NEW_STAMP,"
        " np.zeros((64, 64, 4), np.uint8))\n"
        "assert wire.handle_request_bytes(s.model, raw)[0] == 4\n"
        "for raw in (wire.encode_begin_session(np.zeros((80, 90, 4),"
        " np.uint8)), wire.encode_stamp_at(5, 5),"
        " wire.encode_erase_at(9, 9), wire.encode_end_session()):\n"
        "    assert wire.handle_request_bytes(s.model, raw)[0] in (4, 21)\n"
        "s.shutdown()\n"
        "assert 'torch' not in sys.modules, 'torch imported'\n")
    proc = subprocess.run([sys.executable, "-c", code], timeout=300,
                          cwd=PKG.parent, capture_output=True, text=True)
    assert proc.returncode == 0, proc.stderr


def _dumped(directory):
    names = sorted(os.listdir(directory))
    pattern = re.compile(r"^\d+\.\d{3}_(brush_prompt|brush|stamp)_(\w+)\.npy$")
    assert all(pattern.match(n) for n in names), names
    return sorted((pattern.match(n).group(1), pattern.match(n).group(2))
                  for n in names)


def test_debug_dir_names_as_jax(serving, tmp_path, monkeypatch):
    from diffusiontexturepainting_tpu.client.mock_model import (
        MockConditionalInpainter as JaxMock)
    from diffusiontexturepainting_tpu.serving import handler as j_handler

    monkeypatch.delenv("DTP_NVCF_API_KEY", raising=False)
    ours, theirs = tmp_path / "port", tmp_path / "jax"
    s = serving(TINY + ["--no-warmup", "--debug_dir", str(ours)])
    jax_mock = JaxMock(RES)
    raws = [brush_request(), wire.encode_brush_prompt_request("bark"),
            stamp_request()]
    for raw in raws:
        reply = post(s.port, raw)[2]
        j_handler.handle_request_bytes(jax_mock, raw, debug_dir=str(theirs))
    assert _dumped(ours) == _dumped(theirs) == sorted([
        ("brush", "brush"), ("brush_prompt", "brush"), ("stamp", "canvas"),
        ("stamp", "result")])
    result = next(p for p in ours.iterdir() if p.name.endswith(
        "_stamp_result.npy"))
    np.testing.assert_array_equal(np.load(result),
                                  wire.decode_response(reply)[1])


@pytest.mark.parametrize("model_flags", [
    ["--mock", "--host", "127.0.0.1", "--port", "0", "--resolution",
     str(RES)],
    TINY + ["--no-warmup"],
], ids=["mock", "tiny"])
def test_profile_dir_traces_and_cap(serving, tmp_path, monkeypatch, caplog,
                                    model_flags):
    monkeypatch.setattr(wire, "PROFILE_TRACE_CAP", 2)
    monkeypatch.setattr(wire, "_profile_traces", 0)
    s = serving(model_flags + ["--profile-dir", str(tmp_path)])
    raw = stamp_request()
    with caplog.at_level(logging.WARNING):
        with connect(f"ws://127.0.0.1:{s.port}/websocket/", max_size=None,
                     open_timeout=60) as ws:
            for _ in range(4):
                counter = getattr(s.model, "request_counter", 0)
                ws.send(raw)
                reply = ws.recv(timeout=300)
                if hasattr(s.model, "request_counter"):
                    s.model.request_counter = counter
                assert reply == wire.handle_request_bytes(s.model, raw)
    traces = sorted(tmp_path.iterdir())
    assert len(traces) == 2
    for t in traces:
        assert re.match(r"^\d+\.\d{3}_0[12]\.trace\.json$", t.name)
        events = json.loads(t.read_text())["traceEvents"]
        assert any("handle_request_bytes" in str(e.get("name", ""))
                   or e.get("ph") == "X" for e in events)
    assert sum("trace cap (2) reached" in r.getMessage()
               for r in caplog.records) == 1


def test_scheduler_choices_are_the_registrys():
    """run.py names the choices itself (importing the registry imports
    torch, which --mock must not)."""
    from diffusiontexturepainting_torch.schedulers import (
        available_schedulers)

    assert sorted(t_run.SCHEDULER_CHOICES) == available_schedulers()


def test_warmup_points_parsing():
    assert t_run.parse_warmup_points("256x20,512x4") == [(256, 20), (512, 4)]
    assert t_run.parse_warmup_points("1024X4") == [(1024, 4)]
    assert t_run.parse_warmup_points("256x20,512x4x2,512x4xfssf") == [
        (256, 20), (512, 4, 2), (512, 4, "FSSF")]
    for bad in ("512x4x0", "512x4x-1", "512x4xSF"):
        with pytest.raises(ValueError, match="DeepCache"):
            t_run.parse_warmup_points(bad)
    with pytest.raises(ValueError, match="RESOLUTIONxSTEPS"):
        t_run.parse_warmup_points("256")
    with pytest.raises(ValueError, match="RESOLUTIONxSTEPS"):
        t_run.parse_warmup_points("256x4x2x2")
    with pytest.raises(SystemExit):
        t_run.make_parser().parse_args(["--warmup-points", "512x4x0"])
    with pytest.raises(SystemExit):
        t_run.make_parser().parse_args(["--scheduler", "Heun"])
    assert t_run.parse_canvas("1024x768") == (1024, 768)


def test_warmed_first_reply_equals_a_cold_servers(serving):
    warm = serving(TINY + ["--warmup-points", f"{RES}x{STEPS},128x1",
                           "--session-canvas", "96x80"])
    cold = serving(TINY + ["--no-warmup"])
    assert set(warm.server.startup) == {"model", f"{RES}x{STEPS}", "128x1",
                                        "session"}
    assert set(cold.server.startup) == {"model"}
    assert warm.model.request_counter == cold.model.request_counter == 0
    assert not warm.model.session_active()
    raw = stamp_request()
    assert post(warm.port, raw)[2] == post(cold.port, raw)[2]


def test_default_warmup_point(serving):
    s = serving(TINY)
    assert set(s.server.startup) == {"model", f"{RES}x20"}


def test_checkpoint_and_scheduler_flags(serving, tmp_path):
    random_server = serving(TINY + ["--no-warmup", "--config", "safe_twin"])
    assert random_server.server.model_info == (
        "torch-sd15-inpaint safe_twin DDIM (random weights)")
    src = random_server.model
    t_loader.save_pipeline_params(str(tmp_path), src.state_dicts())
    s = serving(TINY + ["--no-warmup", "--config", "safe_twin",
                        "--checkpoint_dir", str(tmp_path), "--scheduler",
                        "EulerA"])
    assert s.model.config.scheduler == "EulerA"
    for name, sd in src.state_dicts().items():
        got = s.model.state_dicts()[name]
        assert all(torch.equal(got[k], v) for k, v in sd.items()), name
    with urllib.request.urlopen(f"http://127.0.0.1:{s.port}/health",
                                timeout=60) as resp:
        info = json.loads(resp.read())["model"]
    assert info == "torch-sd15-inpaint safe_twin EulerA"
    raw = stamp_request(steps=3)
    status, _, body = post(s.port, raw)
    assert status == 200
    s.model.request_counter -= 1
    assert body == wire.handle_request_bytes(s.model, raw)
    # the same counter draws the same step noise: the same bytes
    s.model.request_counter -= 1
    assert body == post(s.port, raw)[2]
