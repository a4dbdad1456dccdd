"""The rasterizer's CUDA kernel (csrc/raster.cu) against its plain PyTorch
version, on the card: face_idx and the features equal bit for bit on the
quad, a 5k-face UV sphere's stamp view and back-projection, and jittered
grid meshes with shared edges (every z 0, and random z). Marked `cuda`;
they skip where no GPU is visible. The file imports no JAX, so on the card:

    python -m pytest -m cuda --noconftest tests/test_torch_port_raster_sm90.py

`jittered_grid` also feeds the CPU parity tests of
tests/test_torch_port_raster.py.
"""

import numpy as np
import pytest
import torch

from diffusiontexturepainting_torch import _cuda
from diffusiontexturepainting_torch.client import render
from diffusiontexturepainting_torch.client.mesh_io import (
    make_unit_quad,
    make_uv_sphere,
)
from diffusiontexturepainting_torch.ops import raster

torch.set_num_threads(2)


def jittered_grid(seed: int, n: int = 12, zmode: str = "zero",
                  channels: int = 3, span: float = 1.2):
    """(features (F, 3, C), z (F, 3), NDC corners (F, 3, 2)) of an n x n
    vertex grid over [-span, span]^2 (past the viewport), each vertex
    moved by up to 0.3 of a cell, each cell cut along a random diagonal,
    each face's winding random, so that faces share edges; z all 0 (the
    back-projection's ties) or standard normal."""
    rng = np.random.default_rng(seed)
    xs = np.linspace(-span, span, n)
    step = xs[1] - xs[0]
    pts = np.stack(np.meshgrid(xs, xs), -1) + rng.uniform(
        -0.3, 0.3, (n, n, 2)) * step
    pts = pts.reshape(-1, 2).astype(np.float32)
    faces = []
    for i in range(n - 1):
        for j in range(n - 1):
            a, b = i * n + j, i * n + j + 1
            c, d = (i + 1) * n + j + 1, (i + 1) * n + j
            faces += ([[a, b, c], [a, c, d]] if rng.random() < 0.5
                      else [[a, b, d], [b, c, d]])
    faces = np.asarray(faces)
    flip = rng.random(len(faces)) < 0.5
    faces[flip] = faces[flip][:, ::-1]
    F = len(faces)
    z = (np.zeros((F, 3), np.float32) if zmode == "zero"
         else rng.standard_normal((F, 3)).astype(np.float32))
    feats = rng.standard_normal((F, 3, channels)).astype(np.float32)
    return feats, z, pts[faces]


def sphere_inputs(mesh, device, res=256, tex=1024, seed=0):
    """The stamp view's and the back-projection's rasterize arguments for
    a brush on `mesh` (a unit sphere): (height, width, features, z, NDC,
    valid) twice."""
    rng = np.random.default_rng(seed)
    hit = rng.standard_normal(3).astype(np.float32)
    hit /= np.linalg.norm(hit)
    cam = render.OrthoCamera(eye=hit * 1.1, at=hit,
                             up=np.array([0, 1, 0], np.float32),
                             half_width=0.3, height=res, width=res)
    m = mesh.to(device)
    pm = render.projected_mesh_attributes(m, cam)
    nz = render._norm_cam_z(pm["face_vertices_camera"])[..., None]
    view = (res, res, torch.cat([m.face_uvs, nz], -1),
            pm["face_vertices_camera"][..., 2].contiguous(),
            pm["face_vertices_image"], pm["face_normals"][:, 2] >= 0)
    _, face_idx = raster.rasterize_plain(*view)
    valid = render.get_valid_faces(pm["face_normals"], face_idx)
    back = (tex, tex, pm["face_vertices_image"] / 2 + 0.5,
            torch.zeros(m.face_uvs.shape[:2], device=device),
            m.face_uvs * 2 - 1, valid)
    return view, back


def _setup():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False


def _bit_equal(args):
    before = raster.rasterize_launches.launches
    out, idx = raster.rasterize(*args)
    torch.cuda.synchronize()
    assert raster.rasterize_launches.launches == before + 1
    pout, pidx = raster.rasterize_plain(*args)
    assert torch.equal(idx, pidx), int((idx != pidx).sum())
    assert torch.equal(out.view(torch.int32), pout.view(torch.int32))
    return idx


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("zmode", ["zero", "random"])
@pytest.mark.parametrize("hw", [(97, 97), (48, 64), (1024, 1024)])
def test_kernel_bit_equal_on_grids(seed, zmode, hw):
    _setup()
    feats, z, fvi = jittered_grid(seed, zmode=zmode)
    valid = np.random.default_rng(seed).random(len(z)) < 0.8
    args = [torch.from_numpy(a).cuda() for a in (feats, z, fvi, valid)]
    _bit_equal((*hw, *args[:3], None))
    _bit_equal((*hw, *args))


@pytest.mark.cuda
def test_kernel_bit_equal_on_the_quad():
    _setup()
    mesh = make_unit_quad().to("cuda")
    cam = render.OrthoCamera(eye=np.array([0, 0, 1.0], np.float32),
                             at=np.zeros(3, np.float32),
                             up=np.array([0, 1, 0], np.float32),
                             half_width=1.0, height=256, width=256)
    pm = render.projected_mesh_attributes(mesh, cam)
    idx = _bit_equal((256, 256, torch.cat([mesh.face_uvs, mesh.face_uvs],
                                          -1),
                      pm["face_vertices_camera"][..., 2].contiguous(),
                      pm["face_vertices_image"], None))
    assert (idx >= 0).all()  # one face or the other owns the diagonal
    _bit_equal((1024, 1024, pm["face_vertices_image"] / 2 + 0.5,
                torch.zeros((2, 3), device="cuda"),
                mesh.face_uvs * 2 - 1, None))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", range(3))
def test_kernel_bit_equal_on_a_sphere(seed):
    _setup()
    view, back = sphere_inputs(make_uv_sphere(64, 40), "cuda", seed=seed)
    assert (_bit_equal(view) >= 0).any()
    assert (_bit_equal(back) >= 0).any()


@pytest.mark.cuda
def test_kernel_covers_no_pixel_with_a_zero_area_face():
    _setup()
    fvi = torch.tensor([[[0.1, 0.1]] * 3, [[-3, -3], [3, -3], [0, 3]]],
                       device="cuda")
    idx = _bit_equal((32, 32, torch.ones((2, 3, 1), device="cuda"),
                      torch.tensor([[5.0] * 3, [0.0] * 3], device="cuda"),
                      fvi, None))
    assert (idx == 1).all()


@pytest.mark.cuda
def test_failed_build_raises_without_the_plain_version(monkeypatch):
    """A CUDA call whose kernel does not build raises; the plain version
    never runs in its place."""
    _setup()

    def no_build(name):
        raise RuntimeError(f"nvcc failed for {name}.cu")

    monkeypatch.setattr(_cuda, "_libs", {})
    monkeypatch.setattr(_cuda, "build", no_build)
    _cuda.function.cache_clear()
    monkeypatch.setattr(raster, "rasterize_plain", None)
    feats, z, fvi = jittered_grid(0)
    args = [torch.from_numpy(a).cuda() for a in (feats, z, fvi)]
    try:
        with pytest.raises(RuntimeError, match="nvcc failed"):
            raster.rasterize(16, 16, *args)
    finally:
        _cuda.function.cache_clear()
