"""Headless stamp rendering + UV back-projection.

Port of diffusiontexturepainting_tpu/client/render.py, the reference
client's 3D math (kit_app/.../util/render.py:22-178): orthographic
projection of the mesh around the brush tip, texture-mapped RGBA stamp
render, and inverse rasterization in UV space to write the generated stamp
back into the texture image.

The camera basis is numpy, as there. Everything per face and per pixel
stays on the mesh's device as tensors (Mesh.to): the projection, the
normals, both rasterizations (ops/raster.py: csrc/raster.cu on a card),
the texture sampling and the visibility of get_valid_faces (a scatter of
the faces hit, where the JAX function calls np.unique). The results are
tensors on that device.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops.raster import _fma, face_normals, rasterize, texture_mapping


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


@dataclass
class Mesh:
    """Minimal triangle mesh with per-face UVs: numpy arrays as loaded, or
    tensors on a device (`to`)."""

    vertices: np.ndarray  # (V, 3) float32
    faces: np.ndarray  # (F, 3) int32
    face_uvs: np.ndarray  # (F, 3, 2) float32 in [0, 1]

    @property
    def num_faces(self):
        return self.faces.shape[0]

    def bbox_diag(self) -> float:
        v = _host(self.vertices)
        return float(np.linalg.norm(v.max(axis=0) - v.min(axis=0)))

    def bbox_max_dim(self) -> float:
        v = _host(self.vertices)
        return float((v.max(axis=0) - v.min(axis=0)).max())

    def to(self, device) -> "Mesh":
        """The mesh as tensors on `device` (vertices and UVs fp32, faces
        int64)."""
        return Mesh(
            vertices=torch.as_tensor(self.vertices, dtype=torch.float32,
                                     device=device),
            faces=torch.as_tensor(self.faces, device=device).long(),
            face_uvs=torch.as_tensor(self.face_uvs, dtype=torch.float32,
                                     device=device))

    @property
    def device(self):
        return (self.vertices.device if torch.is_tensor(self.vertices)
                else torch.device("cpu"))


def _on_device(mesh: Mesh) -> Mesh:
    return mesh if torch.is_tensor(mesh.vertices) else mesh.to("cpu")


@dataclass
class OrthoCamera:
    """Orthographic camera looking from `eye` toward `at`, with view
    half-width `half_width` (the reference's fov_distance, manager.py:
    199-227: eye = hit + normal, up = previous stroke point - hit)."""

    eye: np.ndarray
    at: np.ndarray
    up: np.ndarray
    half_width: float
    height: int = 256
    width: int = 256

    def basis(self):
        z = self.eye - self.at
        z = z / max(np.linalg.norm(z), 1e-12)
        up = self.up
        up = up - z * float(np.dot(up, z))
        n = np.linalg.norm(up)
        if n < 1e-8:  # degenerate up: pick any perpendicular
            up = np.cross(z, np.array([1.0, 0.0, 0.0], np.float32))
            if np.linalg.norm(up) < 1e-8:
                up = np.cross(z, np.array([0.0, 1.0, 0.0], np.float32))
            n = np.linalg.norm(up)
        y = up / n
        x = np.cross(y, z)
        return np.stack([x, y, z], axis=0).astype(np.float32)  # rows = axes


def projected_mesh_attributes(mesh: Mesh, camera: OrthoCamera,
                              flip_normals: bool = False):
    """Camera-space face vertices, NDC image coords, unit face normals
    (reference render.py:22-30), as tensors on the mesh's device."""
    mesh = _on_device(mesh)
    dev = mesh.device
    R = torch.from_numpy(camera.basis()).to(dev)
    eye = torch.as_tensor(np.asarray(camera.eye, np.float32), device=dev)
    d = mesh.vertices - eye
    # (V, 3) @ R.T as numpy's float32 matmul evaluates it on the CPU (a
    # product, then two fused multiply-adds), the same on every device
    verts_cam = _fma(d[:, 2:3], R[:, 2],
                     _fma(d[:, 1:2], R[:, 1], d[:, 0:1] * R[:, 0]))
    fv_cam = verts_cam[mesh.faces]  # (F, 3, 3)
    # NDC: x right, y DOWN (screen rows). Camera y is "up", so negate.
    # a device tensor, not a Python scalar: torch's CUDA division by a
    # scalar multiplies by its reciprocal, which rounds otherwise
    half = torch.tensor(float(camera.half_width), device=dev)
    fv_img = torch.stack([fv_cam[..., 0] / half, -fv_cam[..., 1] / half],
                         dim=-1)
    normals = face_normals(fv_cam)
    if flip_normals:
        normals = -normals
    # camera looks along -z: facing faces have normal_z toward camera (+z)
    return {
        "face_vertices_camera": fv_cam,
        "face_vertices_image": fv_img,
        "face_normals": normals,
    }


def _norm_cam_z(face_vertices_camera):
    z = face_vertices_camera[..., 2]
    z = z - z.min()
    m = z.max()
    return z / torch.where(m > 1e-4, m, torch.ones_like(m))


def render_view(camera: OrthoCamera, mesh: Mesh, texture=None,
                partial_result=None, flip_normals: bool = False):
    """RGBA stamp render of the mesh around the brush tip (reference
    render.py:44-111). Returns a dict with render (H, W, 4), face_idx,
    render_uvs, alpha, proj_mesh: tensors on the mesh's device."""
    mesh = _on_device(mesh)
    res = partial_result if partial_result is not None else {"cam": camera}
    if "proj_mesh" not in res:
        res["proj_mesh"] = projected_mesh_attributes(mesh, camera,
                                                     flip_normals=flip_normals)
    pm = res["proj_mesh"]
    if "face_idx" not in res:
        nz = _norm_cam_z(pm["face_vertices_camera"])[..., None]  # (F, 3, 1)
        feats = torch.cat([mesh.face_uvs, nz], dim=-1)
        valid = pm["face_normals"][:, 2] >= 0.0
        # depth: camera looks along -z, so closer = larger z
        img_feats, face_idx = rasterize(
            camera.height, camera.width, feats,
            pm["face_vertices_camera"][..., 2].contiguous(),
            pm["face_vertices_image"], valid)
        res["face_idx"] = face_idx
        res["render_uvs"] = img_feats[..., :2]
        res["alpha"] = (face_idx != -1).float()

    if texture is not None:
        tex = torch.as_tensor(texture, dtype=torch.float32,
                              device=mesh.device)
        render = texture_mapping(res["render_uvs"], tex)
        # alpha-mask off-mesh pixels
        if render.shape[-1] == 4:
            render[..., 3] *= res["alpha"]
        res["render"] = render
    else:
        res["render"] = torch.cat(
            [res["alpha"].new_zeros(res["alpha"].shape + (3,)),
             res["alpha"][..., None]], dim=-1)
    return res


def get_valid_faces(face_normals_arr, face_idx):
    """Faces that contribute meaningfully to the render: visible in the
    rasterization AND facing the camera with normal_z >= 0.5 (reference
    render.py:113-130)."""
    visible = torch.zeros(face_normals_arr.shape[0], dtype=torch.bool,
                          device=face_normals_arr.device)
    hits = face_idx.reshape(-1).long()
    visible[hits[hits >= 0]] = True
    return (face_normals_arr[:, 2] >= 0.5) & visible


def backproject_texture(mesh: Mesh, proj_mesh, face_idx, in_render,
                        texture_width: int):
    """Write the stamp back into UV space by rasterizing the mesh *in UV
    coordinates* with screen positions as features, then sampling the
    stamp there (reference render.py:133-178).

    Args:
        in_render: (H, W, 3 or 4) stamp image, numpy or a tensor (alpha
            multiplied by render visibility if present).
    Returns:
        (texture_width, texture_width, 4) RGBA texture update, a tensor on
        the mesh's device.
    """
    mesh = _on_device(mesh)
    dev = mesh.device
    valid = get_valid_faces(proj_mesh["face_normals"], face_idx)
    if not bool(valid.any()):
        return torch.zeros((texture_width, texture_width, 4),
                           dtype=torch.float32, device=dev)

    # features = screen positions in [0,1] (y down, matching our NDC)
    screen_pos = proj_mesh["face_vertices_image"] / 2.0 + 0.5  # (F, 3, 2)
    # rasterize in UV space: uv in [0,1] -> NDC [-1,1]; v maps to rows
    uv_ndc = mesh.face_uvs * 2.0 - 1.0

    tex_feats, tex_face_idx = rasterize(
        texture_width, texture_width, screen_pos,
        torch.zeros(mesh.face_uvs.shape[:2], dtype=torch.float32,
                    device=dev),
        uv_ndc, valid)
    tex_hit = (tex_face_idx != -1).float()

    in_render = torch.as_tensor(in_render, dtype=torch.float32, device=dev)
    alpha = (face_idx != -1).float()
    if in_render.shape[-1] == 3:
        stamp = torch.cat([in_render, alpha[..., None]], dim=-1)
    else:
        stamp = torch.cat(
            [in_render[..., :3], in_render[..., 3:4] * alpha[..., None]],
            dim=-1)

    tex = texture_mapping(tex_feats, stamp)
    tex[..., 3] *= tex_hit
    return tex
