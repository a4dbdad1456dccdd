"""Mesh loading for the headless client.

Port of diffusiontexturepainting_tpu/client/mesh_io.py (numpy there and
here). The reference imports meshes through kaolin's USD importer with
naive triangulation (kit_app/.../manager.py:173-197). Headless hosts don't
ship USD, so this provides a dependency-free Wavefront OBJ loader with the
same guarantees the painter needs: triangulated faces and per-face UVs
(faces without UVs get degenerate zeros and never receive paint: the
port's rasterizer covers no pixel with a zero-area face).
"""

from __future__ import annotations

import numpy as np

from .render import Mesh


def load_obj(path: str, flip_v: bool = True) -> Mesh:
    """Load an OBJ file (v/vt/f records; polygons fan-triangulated).

    Args:
        flip_v: OBJ convention is v=0 at the bottom; texture rows start at
            the top, so v is flipped by default (v' = 1 - v).
    """
    vertices: list = []
    uvs: list = []
    face_v: list = []
    face_vt: list = []

    with open(path) as f:
        for line in f:
            parts = line.strip().split()
            if not parts or parts[0].startswith("#"):
                continue
            if parts[0] == "v" and len(parts) >= 4:
                vertices.append([float(parts[1]), float(parts[2]),
                                 float(parts[3])])
            elif parts[0] == "vt" and len(parts) >= 3:
                uvs.append([float(parts[1]), float(parts[2])])
            elif parts[0] == "f" and len(parts) >= 4:
                corners = []
                for token in parts[1:]:
                    comps = token.split("/")
                    vi = int(comps[0])
                    ti = int(comps[1]) if len(comps) > 1 and comps[1] else 0
                    corners.append((vi, ti))
                # fan triangulation (naive, matching the reference importer)
                for i in range(1, len(corners) - 1):
                    tri = [corners[0], corners[i], corners[i + 1]]
                    face_v.append([c[0] for c in tri])
                    face_vt.append([c[1] for c in tri])

    v = np.asarray(vertices, np.float32)
    vt = np.asarray(uvs if uvs else [[0.0, 0.0]], np.float32)
    if flip_v:
        vt = np.stack([vt[:, 0], 1.0 - vt[:, 1]], axis=-1)

    def resolve(idx, count):
        idx = np.asarray(idx, np.int64)
        return np.where(idx > 0, idx - 1, idx + count)

    faces = resolve(face_v, len(v)).astype(np.int32)
    ti = np.asarray(face_vt, np.int64)
    has_uv = ti != 0
    ti = np.where(ti > 0, ti - 1, np.where(ti < 0, ti + len(vt), 0))
    face_uvs = vt[ti.astype(np.int32)]
    face_uvs = np.where(has_uv[..., None], face_uvs, 0.0).astype(np.float32)
    return Mesh(vertices=v, faces=faces, face_uvs=face_uvs)


def save_obj(path: str, mesh: Mesh, flip_v: bool = True):
    """Write a triangulated OBJ with per-corner UVs."""
    with open(path, "w") as f:
        for v in mesh.vertices:
            f.write(f"v {v[0]} {v[1]} {v[2]}\n")
        uv_index = {}
        uv_list = []
        for tri in mesh.face_uvs.reshape(-1, 2):
            key = (float(tri[0]), float(tri[1]))
            if key not in uv_index:
                uv_index[key] = len(uv_list) + 1
                uv_list.append(key)
        for u, vv in uv_list:
            f.write(f"vt {u} {1.0 - vv if flip_v else vv}\n")
        for fi, tri in enumerate(mesh.faces):
            ids = []
            for c in range(3):
                uv = mesh.face_uvs[fi, c]
                ids.append(f"{tri[c] + 1}/{uv_index[(float(uv[0]), float(uv[1]))]}")
            f.write("f " + " ".join(ids) + "\n")


def make_unit_quad(size: float = 1.0) -> Mesh:
    """The test primitive (the analog of the reference test's cube prim)."""
    v = np.array([[-1, -1, 0], [1, -1, 0], [1, 1, 0], [-1, 1, 0]],
                 np.float32) * size
    f = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    uv = np.array([[[0, 1], [1, 1], [1, 0]],
                   [[0, 1], [1, 0], [0, 0]]], np.float32)
    return Mesh(v, f, uv)


def make_uv_sphere(longitudes: int = 256, latitudes: int = 128,
                   radius: float = 1.0) -> Mesh:
    """A UV sphere (the port's procedural test mesh, not in the JAX
    package): `latitudes` bands of `longitudes` quads, y up, one UV atlas
    with u = longitude / 2 pi and v = polar angle / pi (v 0 at the north
    pole, texture row 0), its seam at longitude 0 (the +x side), where
    faces take u = 1 on their far corners. The pole bands have one
    triangle a longitude, the others two: 2 * longitudes * (latitudes - 1)
    faces (65,024 at 256 x 128), wound counter-clockwise seen from outside
    (face normals outward, as the quad's face +z)."""
    lon, lat = int(longitudes), int(latitudes)
    theta = np.pi * np.arange(1, lat) / lat  # the rings between the poles
    phi = 2.0 * np.pi * np.arange(lon) / lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    ring = np.stack([st * np.cos(phi), np.broadcast_to(ct, (lat - 1, lon)),
                     st * np.sin(phi)], axis=-1).reshape(-1, 3)
    vertices = np.concatenate([[[0.0, 1.0, 0.0]], ring, [[0.0, -1.0, 0.0]]])
    south = len(vertices) - 1

    def vid(i, j):  # ring i in 1..lat-1, column j (wrapping)
        return 1 + (i - 1) * lon + j % lon

    faces, uvs = [], []
    for j in range(lon):
        u0, u1, um = j / lon, (j + 1) / lon, (j + 0.5) / lon
        faces.append([0, vid(1, j), vid(1, j + 1)])
        uvs.append([[um, 0.0], [u0, 1 / lat], [u1, 1 / lat]])
        for i in range(1, lat - 1):
            v0, v1 = i / lat, (i + 1) / lat
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            faces += [[a, b, c], [a, c, d]]
            uvs += [[[u0, v0], [u1, v0], [u1, v1]],
                    [[u0, v0], [u1, v1], [u0, v1]]]
        faces.append([south, vid(lat - 1, j + 1), vid(lat - 1, j)])
        uvs.append([[um, 1.0], [u1, (lat - 1) / lat], [u0, (lat - 1) / lat]])
    vertices = (vertices * radius).astype(np.float32)
    faces = np.asarray(faces, np.int32)
    uvs = np.asarray(uvs, np.float32)
    corners = vertices[faces].astype(np.float64)
    normal = np.cross(corners[:, 1] - corners[:, 0],
                      corners[:, 2] - corners[:, 0])
    inward = (normal * corners.mean(axis=1)).sum(-1) < 0
    faces[inward] = faces[inward][:, ::-1]
    uvs[inward] = uvs[inward][:, ::-1]
    return Mesh(vertices, faces, uvs)
