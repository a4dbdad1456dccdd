"""Triangle rasterizer and texture sampling for the painting client.

Port of diffusiontexturepainting_tpu/ops/raster.py, the stamp render and
UV back-projection of client/render.py (the reference client runs kaolin's
CUDA rasterizer there, util/render.py:76-83, 156-176). Conventions as
there: face_vertices_image (F, 3, 2) in NDC [-1, 1], x right, y down
(pixel row 0 at y -1); inclusive edges; orthographic barycentrics; larger z
is closer; face_idx -1 where no face covers a pixel.

Kernel (csrc/raster.cu): `rasterize` on a CUDA tensor launches
dtp_rasterize (a cover pass over each face's bounding box with a 64-bit
atomicMax of (z, face) a pixel, then a resolve pass a pixel) or raises;
`rasterize_plain` runs for a CPU tensor and inside conv_impl("plain"). It
replaces no Pallas kernel: the JAX package's rasterize is a dense XLA
formulation ((H*W, F) arrays and an argmax over faces), which
rasterize_plain keeps, in chunks of faces. Both round every fp32 step as
the JAX function does (the features as its einsum's fused multiply-adds,
through float64), so face_idx agrees at every pixel and the two versions'
outputs are equal bit for bit.

One departure from the JAX function: a face with |area| < 1e-12 covers no
pixel. The JAX function divides by an area of 1e-12 there, so a face of
three coincident corners (a face without UVs in the back-projection) has
barycentrics 0 everywhere and covers the whole viewport (ROADMAP.md,
faults in the reference).

`texture_mapping` and `face_normals` are gathers and elementwise ops on the
caller's device.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from .. import _cuda
from .conv3x3 import plain_route

rasterize_launches = _cuda.LaunchCounter("rasterize")

SOURCE = "raster"
_ARGTYPES = (ctypes.c_void_p,) * 7 + (ctypes.c_int,) * 5 + (ctypes.c_void_p,)
MIN_AREA = 1e-12
# (pixels x faces) elements of the plain version's arrays a chunk of faces
PLAIN_CHUNK_ELEMS = 1 << 24


def pixel_centers(n: int, device=None) -> torch.Tensor:
    """(n,) fp32 NDC centres ((i + 0.5) / n) * 2 - 1, each step rounded to
    fp32 (numpy divides exactly; torch's CUDA division by a scalar
    multiplies by its reciprocal)."""
    i = np.arange(n, dtype=np.float32)
    c = (i + np.float32(0.5)) / np.float32(n) * np.float32(2) - np.float32(1)
    return torch.from_numpy(c).to(device)


def _edge(ax, ay, bx, by, px, py):
    """cross(b - a, p - a), as the JAX function's `edge`."""
    return (bx - ax) * (py - ay) - (by - ay) * (px - ax)


def _bary(v, px, py):
    """Barycentrics (b0, b1, b2) of points (px, py) in triangles v (..., 3,
    2) broadcast against them."""
    x0, y0 = v[..., 0, 0], v[..., 0, 1]
    x1, y1 = v[..., 1, 0], v[..., 1, 1]
    x2, y2 = v[..., 2, 0], v[..., 2, 1]
    area = _edge(x0, y0, x1, y1, x2, y2)
    return (_edge(x1, y1, x2, y2, px, py) / area,
            _edge(x2, y2, x0, y0, px, py) / area,
            _edge(x0, y0, x1, y1, px, py) / area)


def _fma(a, b, c):
    """a * b + c of fp32 tensors rounded to fp32 from float64, where a * b
    is exact: the fused multiply-add's value but for a double rounding (a
    float64 sum on an fp32 midpoint, about one case in 2^28)."""
    return (a.double() * b.double() + c.double()).float()


def interpolate(b0, b1, b2, fc):
    """(P,) barycentrics and (P, 3, C) corner features -> (P, C) as the JAX
    function's einsum("pk,pkc->pc") evaluates it on the CPU: b0 f0, then
    two fused multiply-adds, of b1 f1 and of b2 f2."""
    return _fma(b2[:, None], fc[:, 2],
                _fma(b1[:, None], fc[:, 1], b0[:, None] * fc[:, 0]))


def face_areas(face_vertices_image):
    """(F,) signed areas of the image-space triangles (twice the area)."""
    v = face_vertices_image
    return _edge(v[:, 0, 0], v[:, 0, 1], v[:, 1, 0], v[:, 1, 1], v[:, 2, 0],
                 v[:, 2, 1])


def rasterize_plain(height: int, width: int, face_features, face_vertices_z,
                    face_vertices_image, valid_faces=None):
    """The JAX function's dense formulation over chunks of faces: a running
    best (z, face) a pixel that only a strictly greater z replaces, so the
    lowest face index wins a tie, as the argmax does. Faces that
    `valid_faces` excludes, whose |area| < MIN_AREA or with a corner not
    finite (whose barycentrics are NaN) are dropped first."""
    dev = face_features.device
    fvi = face_vertices_image.float()
    fz = face_vertices_z.float()
    feats = face_features.float()
    keep = (face_areas(fvi).abs() >= MIN_AREA) \
        & torch.isfinite(fvi).flatten(1).all(dim=1)
    if valid_faces is not None:
        keep &= valid_faces.to(device=dev, dtype=torch.bool)
    ids = keep.nonzero()[:, 0]
    P = height * width
    px = pixel_centers(width, dev).repeat(height)
    py = pixel_centers(height, dev).repeat_interleave(width)
    best_z = torch.full((P,), -torch.inf, device=dev)
    best_f = torch.full((P,), -1, dtype=torch.long, device=dev)
    chunk = max(1, PLAIN_CHUNK_ELEMS // P)
    for c0 in range(0, ids.numel(), chunk):
        f = ids[c0:c0 + chunk]
        b0, b1, b2 = _bary(fvi[f][None], px[:, None], py[:, None])
        z = (b0 * fz[f, 0] + b1 * fz[f, 1]) + b2 * fz[f, 2]
        z = torch.where((b0 >= 0) & (b1 >= 0) & (b2 >= 0), z, -torch.inf)
        zmax, arg = z.max(dim=1)  # the first maximal face of the chunk
        better = zmax > best_z
        best_z = torch.where(better, zmax, best_z)
        best_f = torch.where(better, f[arg], best_f)
    hit = best_f >= 0
    take = best_f.clamp(min=0)
    b0, b1, b2 = _bary(fvi[take], px, py)
    out = interpolate(b0, b1, b2, feats[take])
    out = torch.where(hit[:, None], out, 0.0)
    C = feats.shape[-1]
    return (out.reshape(height, width, C),
            best_f.to(torch.int32).reshape(height, width))


def cover_slices(height: int, width: int) -> int:
    """gridDim.y of the cover pass: the ways a face's bounding box is cut,
    so that one face over the whole viewport does not run on one warp."""
    return min(16, max(1, (height * width) >> 16))


def rasterize(height: int, width: int, face_features, face_vertices_z,
              face_vertices_image, valid_faces=None):
    """Z-buffered barycentric rasterization.

    Args:
        face_features: (F, 3, C) per-corner attributes to interpolate.
        face_vertices_z: (F, 3) camera-space depth (larger = closer).
        face_vertices_image: (F, 3, 2) NDC xy in [-1, 1] (y down).
        valid_faces: (F,) bool; False faces never rasterize.

    Returns:
        (features (H, W, C) fp32, face_idx (H, W) int32)
    """
    if plain_route(face_features):
        return rasterize_plain(height, width, face_features, face_vertices_z,
                               face_vertices_image, valid_faces)
    return _launch(height, width, face_features, face_vertices_z,
                   face_vertices_image, valid_faces)


def _launch(height, width, face_features, face_vertices_z,
            face_vertices_image, valid_faces):
    dev = face_features.device
    if dev.type != "cuda":
        raise ValueError(f"rasterize: tensors must be on CPU or CUDA, got "
                         f"{dev}")
    F, corners, C = face_features.shape
    want = {"face_features": (F, 3, C), "face_vertices_z": (F, 3),
            "face_vertices_image": (F, 3, 2)}
    given = {"face_features": face_features,
             "face_vertices_z": face_vertices_z,
             "face_vertices_image": face_vertices_image}
    for name, t in given.items():
        if t.device != dev or t.dtype != torch.float32 \
                or tuple(t.shape) != want[name]:
            raise ValueError(f"rasterize: {name} must be fp32 {want[name]} "
                             f"on {dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
    if corners != 3 or C < 1 or height < 1 or width < 1:
        raise ValueError(f"rasterize: (F, 3, C >= 1) features on a "
                         f"non-empty image, got {tuple(face_features.shape)}"
                         f" at {height}x{width}")
    if valid_faces is not None:
        if valid_faces.device != dev or tuple(valid_faces.shape) != (F,):
            raise ValueError(f"rasterize: valid_faces must be ({F},) on "
                             f"{dev}, got {tuple(valid_faces.shape)} on "
                             f"{valid_faces.device}")
        valid_faces = valid_faces.to(torch.bool).contiguous()
    feats = face_features.contiguous()
    fz = face_vertices_z.contiguous()
    fvi = face_vertices_image.contiguous()
    P = height * width
    keys = torch.empty(P, dtype=torch.int64, device=dev)
    out = torch.empty((height, width, C), dtype=torch.float32, device=dev)
    face_idx = torch.empty((height, width), dtype=torch.int32, device=dev)
    code = _cuda.function(SOURCE, "dtp_rasterize", _ARGTYPES)(
        fvi.data_ptr(), fz.data_ptr(), feats.data_ptr(),
        None if valid_faces is None else valid_faces.data_ptr(),
        keys.data_ptr(), out.data_ptr(), face_idx.data_ptr(), F, height,
        width, C, cover_slices(height, width), _cuda.stream_of(fvi))
    _cuda.check(SOURCE, "dtp_rasterize", code)
    rasterize_launches.record((F, height, width, C))
    return out, face_idx


def texture_mapping(uv, texture):
    """Bilinear texture sampling, edge-clamped.

    Args:
        uv: (H, W, 2) coordinates in [0, 1], (0, 0) = texture top-left
            (row 0), u = x / width, v = y / rows.
        texture: (Ht, Wt, C).

    Returns: (H, W, C) samples.
    """
    th, tw = texture.shape[0], texture.shape[1]
    x = uv[..., 0] * (tw - 1)
    y = uv[..., 1] * (th - 1)
    x0 = torch.floor(x).to(torch.int32).clamp(0, tw - 1)
    y0 = torch.floor(y).to(torch.int32).clamp(0, th - 1)
    x1 = (x0 + 1).clamp(0, tw - 1)
    y1 = (y0 + 1).clamp(0, th - 1)
    fx = (x - x0).clamp(0.0, 1.0)[..., None]
    fy = (y - y0).clamp(0.0, 1.0)[..., None]
    x0, y0, x1, y1 = (t.long() for t in (x0, y0, x1, y1))
    t00 = texture[y0, x0]
    t01 = texture[y0, x1]
    t10 = texture[y1, x0]
    t11 = texture[y1, x1]
    return ((t00 * (1 - fx) + t01 * fx) * (1 - fy)
            + (t10 * (1 - fx) + t11 * fx) * fy)


def face_normals(face_vertices, unit: bool = True):
    """(F, 3, 3) camera-space corners -> (F, 3) normals."""
    e1 = face_vertices[:, 1] - face_vertices[:, 0]
    e2 = face_vertices[:, 2] - face_vertices[:, 0]
    n = torch.stack([e1[:, 1] * e2[:, 2] - e1[:, 2] * e2[:, 1],
                     e1[:, 2] * e2[:, 0] - e1[:, 0] * e2[:, 2],
                     e1[:, 0] * e2[:, 1] - e1[:, 1] * e2[:, 0]], dim=-1)
    if unit:
        norm = (n * n).sum(-1, keepdim=True).sqrt()
        n = n / norm.clamp(min=1e-12)
    return n
