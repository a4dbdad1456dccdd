"""The port's headless painting client (client/, utils/) against the JAX
package's, on the CPU.

TexturePainter with the port's mock model against the JAX painter with its
own, through BrushStroke in Inpaint, Overpaint and Erase modes and an
undo: the textures after each stamp within SAMPLED_ATOL of each other
(tests/test_torch_port_raster.py says why an update sampled at
back-projected positions is held there; the painted texels the same), and
the baked PNG's pixels equal to the JAX painter's, both decoded with
Pillow. circle_mask byte-equal to the JAX one's (Pillow's ImageDraw).
load_obj / save_obj, the history queue, the textures, the settings, the
async saves and the model library equal to the JAX modules' on the same
inputs.
"""

import os

import numpy as np
import pytest
import torch
from PIL import Image

from diffusiontexturepainting_torch.client import (
    brush as pbrush,
    history as phistory,
    library as plibrary,
    mesh_io as pmesh_io,
    painter as ppainter,
)
from diffusiontexturepainting_torch.client.mock_model import (
    MockConditionalInpainter as PortMock)
from diffusiontexturepainting_torch.utils import (
    async_save as psave,
    settings as psettings,
    textures as ptextures,
)
from diffusiontexturepainting_tpu.client import (
    brush as jbrush,
    history as jhistory,
    library as jlibrary,
    mesh_io as jmesh_io,
    painter as jpainter,
)
from diffusiontexturepainting_tpu.client.mock_model import (
    MockConditionalInpainter as JaxMock)
from diffusiontexturepainting_tpu.utils import (
    async_save as jsave,
    settings as jsettings,
    textures as jtextures,
)
from test_torch_port_raster import SAMPLED_ATOL

torch.set_num_threads(2)

RES, TEX = 32, 48


@pytest.mark.parametrize("size", [8, 31, 32, 64, 256, 512, 1024])
def test_circle_mask_equals_pillow(size):
    got = ppainter.circle_mask(size)
    want = jpainter.circle_mask(size)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert np.array_equal(got, want)


def test_circle_mask_margins_equal_pillow():
    for size in range(1, 40):
        for margin in range(0, 4):
            if size - 2 * margin >= 0:
                assert np.array_equal(ppainter.circle_mask(size, margin),
                                      jpainter.circle_mask(size, margin)), \
                    (size, margin)


def test_masks_and_settings_equal_jax():
    canvas = np.random.default_rng(0).random((RES, RES, 4)).astype(
        np.float32)
    assert np.array_equal(ppainter.overpaint_canvas(canvas, 5),
                          jpainter.overpaint_canvas(canvas, 5))
    assert np.array_equal(ppainter.stamp_edge_mask(RES),
                          jpainter.stamp_edge_mask(RES))
    assert ppainter.DEFAULT_MODEL_SETTINGS == jpainter.DEFAULT_MODEL_SETTINGS
    assert ppainter.OVERPAINT_MARGIN_FRAC == jpainter.OVERPAINT_MARGIN_FRAC
    assert [m.name for m in ppainter.BrushMode] == \
        [m.name for m in jpainter.BrushMode]


def _painters(mesh_np):
    """(JAX painter, port painter) over the same mesh, with mocks holding
    the same seeded brush."""
    brush = np.random.default_rng(7).random((RES + 8, RES, 3)).astype(
        np.float32)
    out = []
    for painter_mod, mesh_mod, mock, kw in (
            (jpainter, jmesh_io, JaxMock, {}),
            (ppainter, pmesh_io, PortMock, {"device": "cpu"})):
        mesh = mesh_mod.Mesh(*mesh_np)
        model = mock(RES)
        model.set_brush(brush)
        out.append(painter_mod.TexturePainter(model, mesh, texture_width=TEX,
                                              **kw))
    return out


def _mesh_np(name):
    m = (pmesh_io.make_uv_sphere(12, 10) if name == "sphere"
         else pmesh_io.make_unit_quad())
    return m.vertices, m.faces, m.face_uvs


def _stroke_points(name):
    if name == "quad":
        pts = [[-0.5, -0.3, 0], [0.1, 0.2, 0], [0.6, 0.4, 0]]
        return [(np.asarray(p, np.float32), np.array([0, 0, 1.0], np.float32))
                for p in pts]
    out = []
    for p in ([1, 0.05, 0.1], [0.8, 0.3, 0.5], [0.5, 0.5, 0.7]):
        p = np.asarray(p, np.float32)
        p /= np.linalg.norm(p)
        out.append((p, p.copy()))
    return out


def _close(jax_painter, port_painter):
    want, got = jax_painter.texture, port_painter.texture.numpy()
    np.testing.assert_allclose(got, want, atol=SAMPLED_ATOL, rtol=0)
    np.testing.assert_array_equal(got[..., 3] > 0, want[..., 3] > 0)


@pytest.mark.parametrize("name", ["quad", "sphere"])
def test_painter_strokes_match_jax(name, tmp_path):
    """A BrushStroke in each mode and an undo, stamp by stamp: each texture
    within SAMPLED_ATOL of the JAX painter's, the same texels painted."""
    painters = _painters(_mesh_np(name))
    radius = 0.45 if name == "quad" else 0.35
    for mode in ("INPAINT", "OVERPAINT", "ERASE"):
        strokes = []
        for p, mod in zip(painters, (jbrush, pbrush)):
            p.mode = type(p.mode)[mode]
            strokes.append(mod.BrushStroke(p, radius=radius))
        for k, (hit, normal) in enumerate(_stroke_points(name)):
            n = [s.move(hit, normal) for s in strokes]
            assert n[0] == n[1] >= 1
            _close(*painters)
        for s in strokes:
            s.end()
        if mode != "ERASE":
            assert (painters[1].texture[..., 3] > 0).any()
    erased = painters[1].texture.clone()
    assert painters[0].undo() and painters[1].undo()
    _close(*painters)
    assert not torch.equal(painters[1].texture, erased)
    assert painters[0].undo() and painters[1].undo()
    _close(*painters)

    paths = [str(tmp_path / f"{k}" / "baked") for k in ("jax", "port")]
    outs = [p.bake_texture(path) for p, path in zip(painters, paths)]
    assert outs == [path + ".png" for path in paths]
    pngs = [np.asarray(Image.open(out)) for out in outs]
    assert pngs[0].shape == (TEX, TEX, 4) and pngs[1].dtype == np.uint8
    for png, texture in zip(pngs, (painters[0].texture,
                                   painters[1].texture.numpy())):
        assert np.array_equal(
            png, (np.clip(texture, 0, 1) * 255).astype(np.uint8))
    # the float textures lie within SAMPLED_ATOL (2.4e-6 at most here) and
    # no texel falls on the two sides of a u8 level
    assert np.array_equal(pngs[0], pngs[1])
    np.testing.assert_array_equal(
        np.load(paths[1] + ".npy"), painters[1].texture.numpy())


def test_painter_keeps_its_state_on_the_device():
    """The mesh goes to the painter's device once; the texture, the undo
    stack and each update are tensors there; the StageTimer keeps each
    stamp's four stages."""
    _, painter = _painters(_mesh_np("quad"))
    assert isinstance(painter.mesh.vertices, torch.Tensor)
    assert painter.mesh.faces.dtype == torch.int64
    painter.begin_stroke()
    update = painter.stamp(np.zeros(3), np.array([0, 0, 1.0]), radius=0.6)
    assert isinstance(update, torch.Tensor)
    assert update.shape == (TEX, TEX, 4)
    assert isinstance(painter.undo_stack[0], torch.Tensor)
    assert set(painter.timer.records) == {"render", "generate",
                                          "backproject", "update"}


def test_brush_stroke_spacing_matches_jax():
    """The same stamps at the same points: evenly spaced along a segment,
    Erase at three a radius."""
    calls = []

    class Recorder:
        def __init__(self, tag, mode):
            self.tag, self.fov_distance = tag, 0.1
            self.mode = mode

        def begin_stroke(self):
            calls.append((self.tag, "begin"))

        def stamp(self, hit, normal, prev_point=None, radius=None):
            calls.append((self.tag, tuple(np.round(hit, 6)),
                          None if prev_point is None
                          else tuple(np.round(prev_point, 6)), radius))

    for mode in ("INPAINT", "ERASE"):
        logs = []
        for tag, mod, pmod in (("j", jbrush, jpainter),
                               ("p", pbrush, ppainter)):
            calls.clear()
            s = mod.BrushStroke(Recorder(tag, pmod.BrushMode[mode]))
            s.begin([0, 0, 0], [0, 0, 1])
            s.move([0.35, 0.1, 0], [0, 0, 1])
            s.move([0.35, 0.5, 0], [0, 0, 1])
            logs.append([c[1:] for c in calls])
        assert logs[0] == logs[1] and len(logs[0]) > 3


OBJ = """# a quad, a triangle without UVs, negative indices
v -1 -1 0
v 1 -1 0
v 1 1 0
v -1 1 0
v 0 0 1
vt 0 0
vt 1 0
vt 1 1
vt 0 1
f 1/1 2/2 3/3 4/4
f -1 -4 -3
f 2/-3/ 3/-2 5
"""


def test_obj_io_matches_jax(tmp_path):
    path = tmp_path / "m.obj"
    path.write_text(OBJ)
    for flip in (True, False):
        got = pmesh_io.load_obj(str(path), flip_v=flip)
        want = jmesh_io.load_obj(str(path), flip_v=flip)
        for k in ("vertices", "faces", "face_uvs"):
            a, b = getattr(got, k), getattr(want, k)
            assert a.dtype == b.dtype and np.array_equal(a, b), k
        for mod, mesh in ((pmesh_io, got), (jmesh_io, want)):
            mod.save_obj(str(tmp_path / f"{mod.__name__}.obj"), mesh,
                         flip_v=flip)
        texts = [(tmp_path / f"{m.__name__}.obj").read_text()
                 for m in (pmesh_io, jmesh_io)]
        assert texts[0] == texts[1]
        back = pmesh_io.load_obj(str(tmp_path / f"{pmesh_io.__name__}.obj"),
                                 flip_v=flip)
        assert np.array_equal(back.faces, got.faces)
    quad = (pmesh_io.make_unit_quad(2.0), jmesh_io.make_unit_quad(2.0))
    for k in ("vertices", "faces", "face_uvs"):
        assert np.array_equal(getattr(quad[0], k), getattr(quad[1], k))
    assert quad[0].bbox_max_dim() == quad[1].bbox_max_dim() == 4.0
    assert quad[0].bbox_diag() == quad[1].bbox_diag()


def test_uv_sphere_round_trips_through_obj(tmp_path):
    sphere = pmesh_io.make_uv_sphere(16, 8)
    assert sphere.faces.shape == (2 * 16 * 7, 3)
    path = str(tmp_path / "s.obj")
    pmesh_io.save_obj(path, sphere)
    back = pmesh_io.load_obj(path)
    assert np.array_equal(back.faces, sphere.faces)
    assert np.array_equal(back.vertices, sphere.vertices)
    np.testing.assert_allclose(back.face_uvs, sphere.face_uvs, atol=1e-7)


def test_history_textures_settings_match_jax(monkeypatch):
    rng = np.random.default_rng(1)
    imgs = [rng.integers(0, 255, (4, 4, 3), dtype=np.uint8) for _ in range(5)]
    queues = [phistory.BrushHistoryQueue(3), jhistory.BrushHistoryQueue(3)]
    for img in imgs + [imgs[2], imgs[4]]:
        for q in queues:
            q.push(img)
    assert len(queues[0]) == len(queues[1]) == 3
    for a, b in zip(*(q.items() for q in queues)):
        assert np.array_equal(a, b)
    for args in ((64,), (40, 24, 8), (16, None, 4, (1, 0, 0), (0, 0, 1))):
        assert np.array_equal(ptextures.checkerboard(*args),
                              jtextures.checkerboard(*args))
    assert np.array_equal(ptextures.blank(8, 4, (0.1, 0.2, 0.3, 0.4)),
                          jtextures.blank(8, 4, (0.1, 0.2, 0.3, 0.4)))
    # the port keeps the values a module of it reads, named and defaulted
    # as in the JAX module
    assert psettings.DEFAULTS == {k: jsettings.DEFAULTS[k]
                                  for k in ("DTP_SERVER_URL",
                                            "DTP_RESOLUTION")}
    for mod in (psettings, jsettings):
        monkeypatch.setattr(mod, "_OVERRIDES", {})
        mod.set_override("DTP_RESOLUTION", 512)
    assert psettings.get("DTP_RESOLUTION") == jsettings.get(
        "DTP_RESOLUTION") == "512"
    assert psettings.get("NOPE", "x") == "x"
    monkeypatch.setenv("DTP_RESOLUTION", "1024")
    assert psettings.resolution() == int(jsettings.get("DTP_RESOLUTION"))


def test_async_saves_match_jax(tmp_path):
    rng = np.random.default_rng(2)
    images = {"rgba": rng.random((9, 7, 4)).astype(np.float32),
              "rgb_u8": rng.integers(0, 255, (5, 6, 3), dtype=np.uint8)}
    for name, img in images.items():
        futures = []
        for mod in (psave, jsave):
            d = tmp_path / mod.__name__.split(".")[0]
            futures += [mod.save_png_async(str(d / f"{name}.png"), img),
                        mod.save_npy_async(str(d / f"{name}.npy"), img)]
        paths = psave.wait_all(futures)
        assert np.array_equal(np.asarray(Image.open(paths[0])),
                              np.asarray(Image.open(paths[2])))
        assert np.array_equal(np.load(paths[1]), np.load(paths[3]))


def test_library_matches_jax(monkeypatch):
    assert plibrary.model_names()[0] == jlibrary.model_names()[0] == "Mock"
    assert isinstance(plibrary.load_model("Mock"), PortMock)
    monkeypatch.setattr(plibrary, "MODEL_LIBRARY", dict(plibrary.MODEL_LIBRARY))
    name = plibrary.add_remote_model("127.0.0.1:1", "remote")
    assert name == "remote" and "remote" in plibrary.model_names()
    name = plibrary.add_gpu_model("gpu", 64, device="cpu", tiny=True)
    model = plibrary.load_model(name)
    from diffusiontexturepainting_torch.pipeline.torch_model import (
        TorchConditionalInpainter)
    assert isinstance(model, TorchConditionalInpainter)
    assert model.resolution() == 64


def test_library_reads_settings(monkeypatch):
    """A URL or resolution left as None comes from utils/settings.py when
    the model is made."""
    made = []

    class Recording:
        def __init__(self, url, resolution=256):
            made.append((url, resolution))

    from diffusiontexturepainting_torch.client import websocket_model

    monkeypatch.setattr(websocket_model, "WebsocketConditionalInpainter",
                        Recording)
    monkeypatch.setattr(plibrary, "MODEL_LIBRARY", dict(plibrary.MODEL_LIBRARY))
    monkeypatch.setattr(psettings, "_OVERRIDES", {})
    for var in ("DTP_SERVER_URL", "DTP_RESOLUTION"):
        monkeypatch.delenv(var, raising=False)
    name = plibrary.add_remote_model()
    plibrary.load_model(name)
    assert plibrary.load_model("Mock").resolution() == 256
    monkeypatch.setenv("DTP_SERVER_URL", "ws://127.0.0.1:1/websocket/")
    psettings.set_override("DTP_RESOLUTION", 512)
    plibrary.load_model(name)
    assert plibrary.load_model("Mock").resolution() == 512
    plibrary.load_model(plibrary.add_remote_model("127.0.0.1:2", "b", 64))
    assert made == [("ws://localhost:6060/websocket/", 256),
                    ("ws://127.0.0.1:1/websocket/", 512),
                    ("127.0.0.1:2", 64)]


def test_canvas_painter_calls_match_jax(tmp_path):
    """CanvasStrokePainter: the same model calls, (x0, y0) and settings as
    the JAX one's, with and without a `wait` parameter, in each mode, and
    undo's restore; bake writes the same npy and PNG pixels."""
    from diffusiontexturepainting_torch.client import canvas_painter as pcp
    from diffusiontexturepainting_tpu.client import canvas_painter as jcp

    def recorder(with_wait):
        class Model:
            def __init__(self):
                self.calls = []
                self.canvas = None

            def resolution(self):
                return 64

            def begin_session(self, canvas):
                self.calls.append(("begin", canvas.shape,
                                   int(canvas.sum())))
                self.canvas = canvas.copy()

            def fetch_canvas(self):
                self.calls.append(("fetch",))
                self.canvas[len(self.calls) % 64, 3, 3] = 200
                return self.canvas.copy()

            def erase_at(self, x0, y0, return_pixels=True, **kw):
                self.calls.append(("erase", x0, y0, return_pixels,
                                   sorted(kw.items())))

            def end_session(self):
                self.calls.append(("end",))

        if with_wait:
            def stamp_at(self, x0, y0, return_pixels=True, overpaint=False,
                         wait=True, **settings):
                self.calls.append(("stamp", x0, y0, return_pixels,
                                   overpaint, wait, sorted(settings.items())))
        else:
            def stamp_at(self, x0, y0, return_pixels=True, overpaint=False,
                         **settings):
                self.calls.append(("stamp", x0, y0, return_pixels,
                                   overpaint, sorted(settings.items())))
        Model.stamp_at = stamp_at
        return Model()

    canvas = np.random.default_rng(3).random((96, 160, 4)).astype(np.float32)
    for with_wait in (False, True):
        logs, bakes = [], []
        for mod in (jcp, pcp):
            model = recorder(with_wait)
            p = mod.CanvasStrokePainter(model, canvas=canvas,
                                        stamps_per_radius=2)
            p.model_settings["steps"] = 4
            p.begin_stroke(40.2, 50.7)
            p.move(120.0, 61.0)
            p.end_stroke()
            p.mode = type(p.mode).OVERPAINT
            p.begin_stroke(100, 30)
            p.move(20, 30)
            p.mode = type(p.mode).ERASE
            p.move(90, 70)
            p.end_stroke()
            assert p.undo() and p.undo()
            out = str(tmp_path / mod.__name__.split(".")[0] / "canvas")
            bakes.append([f.result() for f in p.bake(out)])
            p.close()
            logs.append(model.calls)
        assert logs[0] == logs[1]
        assert len([c for c in logs[0] if c[0] == "stamp"]) >= 4
        assert np.array_equal(np.load(bakes[0][0]), np.load(bakes[1][0]))
        assert np.array_equal(np.asarray(Image.open(bakes[0][1])),
                              np.asarray(Image.open(bakes[1][1])))
        assert os.path.getsize(bakes[1][1]) > 0
