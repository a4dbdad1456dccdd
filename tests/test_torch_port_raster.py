"""The port's rasterizer (ops/raster.py) and stamp render / back-projection
(client/render.py) against the JAX package's, on the CPU.

rasterize: face_idx equal at every pixel, features within atol 1e-6 (the
port evaluates the JAX einsum's fused multiply-adds through float64),
on jittered grid meshes with shared edges (every z 0, as in the
back-projection, and random z), with and without a valid mask, square and
not. A numpy emulation of csrc/raster.cu's two passes (each face's widened
bounding box, the 64-bit (z, face) key's atomicMax, the resolve) equals
the plain version bit for bit. The one departure, a zero-area face, is
shown on both sides. texture_mapping, face_normals and render_view within
atol 1e-6 (the render equal bit for bit here), backproject_texture within
SAMPLED_ATOL with its painted texels the same.
"""

import ctypes

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.client import render as prender
from diffusiontexturepainting_torch.client.mesh_io import (
    make_unit_quad as port_quad,
    make_uv_sphere,
)
from diffusiontexturepainting_torch.client.painter import TexturePainter
from diffusiontexturepainting_torch.client.mock_model import (
    MockConditionalInpainter as PortMock)
from diffusiontexturepainting_torch.ops import raster
from diffusiontexturepainting_torch.ops.conv3x3 import conv_impl
from diffusiontexturepainting_tpu.client import render as jrender
from diffusiontexturepainting_tpu.client.mesh_io import make_unit_quad
from diffusiontexturepainting_tpu.ops import raster as jraster
from diffusiontexturepainting_tpu.utils.textures import checkerboard
from test_torch_port_raster_sm90 import jittered_grid

torch.set_num_threads(2)

ATOL = 1e-6
# An update sampled from the stamp at back-projected positions: XLA's CPU
# einsum evaluates channel 0 of two without a fused multiply-add (channels
# of three and more with one, as the port does), so those positions may
# differ from the port's by a few fp32 roundings of values <= 1 (<= 4 ulp,
# 2^-22); bilinear sampling of a 64-pixel stamp scales that by its 63 pixel
# steps times the largest step between neighbours (<= 1).
SAMPLED_ATOL = 63 * 2.0**-22


def _jax(height, width, feats, z, fvi, valid=None):
    out, idx = jraster.rasterize(height, width, jnp.asarray(feats),
                                 jnp.asarray(z), jnp.asarray(fvi),
                                 None if valid is None
                                 else jnp.asarray(valid))
    return np.asarray(out), np.asarray(idx)


def _port(height, width, feats, z, fvi, valid=None):
    out, idx = raster.rasterize(height, width, torch.from_numpy(feats),
                                torch.from_numpy(z), torch.from_numpy(fvi),
                                None if valid is None
                                else torch.from_numpy(valid))
    assert out.dtype == torch.float32 and idx.dtype == torch.int32
    return out.numpy(), idx.numpy()


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("zmode", ["zero", "random"])
@pytest.mark.parametrize("hw", [(97, 97), (48, 64)])
@pytest.mark.parametrize("masked", [False, True])
def test_rasterize_matches_jax(seed, zmode, hw, masked):
    feats, z, fvi = jittered_grid(seed, zmode=zmode)
    valid = (np.random.default_rng(seed).random(len(z)) < 0.8
             if masked else None)
    jout, jidx = _jax(*hw, feats, z, fvi, valid)
    pout, pidx = _port(*hw, feats, z, fvi, valid)
    np.testing.assert_array_equal(pidx, jidx)
    np.testing.assert_allclose(pout, jout, atol=ATOL, rtol=0)
    # the grid covers the viewport, a fifth of it masked off
    assert (pidx >= 0).mean() > (0.6 if masked else 0.99)


def _key_bits(z):
    """csrc/raster.cu's order-preserving bits of fp32 z (-0 taken as +0)."""
    u = (z.astype(np.float32) + np.float32(0)).view(np.uint32).astype(
        np.uint64)
    return np.where(u & 0x80000000, ~u & 0xFFFFFFFF, u | 0x80000000)


def _pixel_range(vmin, vmax, n):
    half = np.float32(0.5) * np.float32(n)
    top = np.float32(n + 1)
    a = np.clip((vmin + np.float32(1)) * half - np.float32(0.5), -2, top)
    b = np.clip((vmax + np.float32(1)) * half - np.float32(0.5), -2, top)
    return max(int(np.floor(a)) - 1, 0), min(int(np.ceil(b)) + 1, n - 1)


def emulate_kernel(height, width, feats, z, fvi, valid=None):
    """csrc/raster.cu in numpy fp32: the cover pass over each face's
    widened bounding box with the key's maximum a pixel, then the resolve
    pass."""
    cx = raster.pixel_centers(width).numpy()
    cy = raster.pixel_centers(height).numpy()
    keys = np.zeros(height * width, np.uint64)
    area = raster.face_areas(torch.from_numpy(fvi)).numpy()
    for f in range(len(fvi)):
        if (valid is not None and not valid[f]) \
                or not abs(area[f]) >= raster.MIN_AREA:
            continue
        i0, i1 = _pixel_range(fvi[f, :, 0].min(), fvi[f, :, 0].max(), width)
        j0, j1 = _pixel_range(fvi[f, :, 1].min(), fvi[f, :, 1].max(), height)
        if i0 > i1 or j0 > j1:
            continue
        jj, ii = np.meshgrid(np.arange(j0, j1 + 1), np.arange(i0, i1 + 1),
                             indexing="ij")
        b0, b1, b2 = raster._bary(torch.from_numpy(fvi[f]),
                                       torch.from_numpy(cx[ii]),
                                       torch.from_numpy(cy[jj]))
        b0, b1, b2 = b0.numpy(), b1.numpy(), b2.numpy()
        inside = (b0 >= 0) & (b1 >= 0) & (b2 >= 0)
        zz = (b0 * z[f, 0] + b1 * z[f, 1]) + b2 * z[f, 2]
        key = (_key_bits(zz) << np.uint64(32)) | np.uint64(0xFFFFFFFF - f)
        np.maximum.at(keys, (jj * width + ii)[inside], key[inside])
    hit = keys != 0
    face = np.where(hit, 0xFFFFFFFF - (keys & np.uint64(0xFFFFFFFF)),
                    0).astype(np.int64)
    b0, b1, b2 = raster._bary(torch.from_numpy(fvi[face]),
                                   torch.from_numpy(np.tile(cx, height)),
                                   torch.from_numpy(np.repeat(cy, width)))
    b0, b1, b2 = (b[:, None].numpy() for b in (b0, b1, b2))
    fc = feats[face]
    out = b0 * fc[:, 0]
    for b, f in ((b1, fc[:, 1]), (b2, fc[:, 2])):
        out = (b.astype(np.float64) * f + out).astype(np.float32)
    out = np.where(hit[:, None], out, 0.0).astype(np.float32)
    return (out.reshape(height, width, -1),
            np.where(hit, face, -1).astype(np.int32).reshape(height, width))


@pytest.mark.parametrize("seed", range(2))
@pytest.mark.parametrize("zmode", ["zero", "random"])
def test_kernel_emulation_equals_plain(seed, zmode):
    feats, z, fvi = jittered_grid(seed, zmode=zmode)
    valid = np.random.default_rng(seed).random(len(z)) < 0.8
    for hw in ((97, 97), (48, 64)):
        for v in (None, valid):
            eout, eidx = emulate_kernel(*hw, feats, z, fvi, v)
            pout, pidx = _port(*hw, feats, z, fvi, v)
            np.testing.assert_array_equal(eidx, pidx)
            assert np.array_equal(eout.view(np.int32), pout.view(np.int32))


def test_zero_area_face_covers_nothing():
    """A face of three coincident corners: the JAX rasterize gives it the
    whole viewport (its area is replaced by 1e-12, so every barycentric is
    0, ops/raster.py:60); the port gives it no pixel. A quad whose first
    face has no UVs (mesh_io's zeros): the JAX painter paints nothing, the
    port's paints the other face's texels."""
    feats = np.ones((2, 3, 1), np.float32)
    z = np.zeros((2, 3), np.float32)
    fvi = np.array([[[0.2, 0.2]] * 3, [[-3, -3], [3, -3], [0, 3]]],
                   np.float32)
    _, jidx = _jax(16, 16, feats, z, fvi)
    _, pidx = _port(16, 16, feats, z, fvi)
    assert (jidx == 0).all()
    assert (pidx == 1).all()
    _, pidx = _port(16, 16, feats[:1], z[:1], fvi[:1])
    assert (pidx == -1).all()

    from diffusiontexturepainting_tpu.client.mock_model import (
        MockConditionalInpainter as JaxMock)
    from diffusiontexturepainting_tpu.client.painter import (
        TexturePainter as JaxPainter)

    mesh = make_unit_quad()
    mesh.face_uvs[0] = 0.0
    port_mesh = prender.Mesh(mesh.vertices, mesh.faces, mesh.face_uvs)
    painted = []
    for painter_cls, mock_cls, m, kw in ((JaxPainter, JaxMock, mesh, {}),
                                         (TexturePainter, PortMock,
                                          port_mesh, {"device": "cpu"})):
        model = mock_cls(32)
        model.set_brush(np.full((32, 32, 3), 0.6, np.float32))
        painter = painter_cls(model, m, texture_width=32, **kw)
        painter.stamp(hit=np.zeros(3), normal=np.array([0, 0, 1.0]),
                      radius=1.2)
        painted.append(np.asarray(painter.texture)[..., 3] > 0)
    assert not painted[0].any()
    # the second face's texels: uv (0, 1), (1, 0), (0, 0), below the
    # anti-diagonal
    yy, xx = np.mgrid[:32, :32]
    assert painted[1].any()
    assert not painted[1][(xx + yy) > 33].any()


def test_rasterize_dispatch(monkeypatch):
    """A CUDA call reaches dtp_rasterize once with the shapes, a null mask
    where none is given and the cover slices, and moves the launch
    counter by one; inside conv_impl("plain") a CPU call runs the plain
    version and launches nothing. The wrapper has no fallback."""
    calls = []

    class FakeCuda:
        def __init__(self, shape, dtype=torch.float32):
            self.shape, self.dtype = torch.Size(shape), dtype
            self.device = torch.device("cuda", 0)

        def contiguous(self):
            return self

        def to(self, dtype):
            return FakeCuda(self.shape, dtype)

        def data_ptr(self):
            return 1 << 20

    def function(source, symbol, argtypes):
        assert len(argtypes) == 13 and argtypes[3] is ctypes.c_void_p

        def call(*args):
            calls.append((source, symbol, args))
            return 0
        return call

    monkeypatch.setattr(_cuda, "function", function)
    monkeypatch.setattr(_cuda, "stream_of", lambda t: 0)
    monkeypatch.setattr(torch, "empty",
                        lambda shape, dtype=None, device=None:
                        FakeCuda((shape,) if isinstance(shape, int)
                                 else shape, dtype))
    F, C = 70000, 3
    before = raster.rasterize_launches.launches
    out, idx = raster.rasterize(1024, 1024, FakeCuda((F, 3, C)),
                                FakeCuda((F, 3)), FakeCuda((F, 3, 2)))
    assert out.shape == (1024, 1024, C) and idx.dtype == torch.int32
    assert raster.rasterize_launches.launches == before + 1
    (source, symbol, args), = calls
    assert (source, symbol) == ("raster", "dtp_rasterize")
    assert args[3] is None and args[7:12] == (F, 1024, 1024, C, 16)
    raster.rasterize(8, 8, FakeCuda((F, 3, C)), FakeCuda((F, 3)),
                     FakeCuda((F, 3, 2)), FakeCuda((F,), torch.bool))
    assert calls[1][2][3] == 1 << 20 and calls[1][2][11] == 1
    with pytest.raises(ValueError, match="face_vertices_z"):
        raster.rasterize(8, 8, FakeCuda((F, 3, C)), FakeCuda((F, 2)),
                         FakeCuda((F, 3, 2)))
    assert "raster" in _cuda.SOURCES
    monkeypatch.undo()
    feats, z, fvi = jittered_grid(0)
    n = raster.rasterize_launches.launches
    with conv_impl("plain"):
        _port(16, 16, feats, z, fvi)
    assert raster.rasterize_launches.launches == n
    src = open(raster.__file__).read()
    assert "try:" not in src and "except" not in src


def test_texture_mapping_matches_jax():
    rng = np.random.default_rng(0)
    tex = rng.random((37, 53, 4)).astype(np.float32)
    uv = rng.uniform(-0.3, 1.3, (19, 23, 2)).astype(np.float32)
    uv[0, :3] = [[0, 0], [1, 1], [1, 0]]
    want = np.asarray(jraster.texture_mapping(jnp.asarray(uv),
                                              jnp.asarray(tex)))
    got = raster.texture_mapping(torch.from_numpy(uv), torch.from_numpy(tex))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_face_normals_matches_jax():
    fv = np.random.default_rng(1).standard_normal((50, 3, 3)).astype(
        np.float32)
    fv[0] = 0.0  # a degenerate face: the 1e-12 floor
    for unit in (True, False):
        want = np.asarray(jraster.face_normals(jnp.asarray(fv), unit))
        got = raster.face_normals(torch.from_numpy(fv), unit).numpy()
        np.testing.assert_allclose(got, want, atol=ATOL, rtol=0)


def _meshes():
    return {"quad": port_quad(), "sphere": make_uv_sphere(12, 10)}  # 216


def _cameras(name):
    if name == "quad":
        return [jrender.OrthoCamera(eye=np.array([0.2, -0.1, 1.0], np.float32),
                                    at=np.array([0.2, -0.1, 0], np.float32),
                                    up=np.array([0.3, 1, 0], np.float32),
                                    half_width=0.9, height=64, width=64)]
    out = []
    for hit in ([1.0, 0, 0], [0.3, 0.5, 0.81], [-0.6, -0.2, -0.77]):
        # fp32, as TexturePainter.make_camera gives them
        hit = (np.asarray(hit) / np.linalg.norm(hit)).astype(np.float32)
        out.append(jrender.OrthoCamera(
            eye=hit * 1.1, at=hit, up=np.array([0, 1, 0], np.float32),
            half_width=0.7, height=64, width=64))
    return out


@pytest.mark.parametrize("name", ["quad", "sphere"])
def test_render_view_and_backprojection_match_jax(name):
    mesh = _meshes()[name]
    jmesh = jrender.Mesh(mesh.vertices, mesh.faces, mesh.face_uvs)
    tex = checkerboard(64, cell=8)
    tex[..., 3] = np.random.default_rng(2).random((64, 64))
    stamp = np.random.default_rng(3).random((64, 64, 4)).astype(np.float32)
    for cam in _cameras(name):
        pcam = prender.OrthoCamera(cam.eye, cam.at, cam.up, cam.half_width,
                                   cam.height, cam.width)
        want = jrender.render_view(cam, jmesh, texture=tex)
        got = prender.render_view(pcam, mesh.to("cpu"), texture=tex)
        for k in ("face_vertices_camera", "face_vertices_image",
                  "face_normals"):
            np.testing.assert_allclose(got["proj_mesh"][k].numpy(),
                                       want["proj_mesh"][k], atol=ATOL,
                                       rtol=0)
        np.testing.assert_array_equal(got["face_idx"].numpy(),
                                      want["face_idx"])
        assert (want["face_idx"] >= 0).any()
        for k in ("render_uvs", "alpha", "render"):
            np.testing.assert_allclose(got[k].numpy(), want[k], atol=ATOL,
                                       rtol=0)
        np.testing.assert_array_equal(
            prender.get_valid_faces(got["proj_mesh"]["face_normals"],
                                    got["face_idx"]).numpy(),
            jrender.get_valid_faces(want["proj_mesh"]["face_normals"],
                                    want["face_idx"]))
        for image in (stamp, stamp[..., :3]):
            jb = jrender.backproject_texture(jmesh, want["proj_mesh"],
                                             want["face_idx"], image, 64)
            pb = prender.backproject_texture(mesh, got["proj_mesh"],
                                             got["face_idx"], image, 64)
            np.testing.assert_allclose(pb.numpy(), jb, atol=SAMPLED_ATOL,
                                       rtol=0)
            np.testing.assert_array_equal(pb.numpy()[..., 3] > 0,
                                          jb[..., 3] > 0)
            assert (jb[..., 3] > 0).any()
