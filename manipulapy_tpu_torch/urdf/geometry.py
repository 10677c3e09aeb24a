"""Mesh loading & primitive mesh generation (no external dependencies).

Counterpart of ``manipulapy_tpu/urdf/geometry.py``, the same code.

Capability parity with the reference's ``ManipulaPy/urdf/geometry/``
(pure-Python STL/OBJ loaders with trimesh fallback,
``geometry/mesh_loader.py:31-213``, and primitive generation,
``geometry/primitives.py``). Meshes are host-side artifacts here — the
device-side collision path uses sphere/AABB abstractions derived from
them (:func:`mesh_bounding_sphere`, :func:`mesh_aabb`).
"""

from __future__ import annotations

import os
import struct
from typing import NamedTuple, Optional, Tuple

import numpy as np

__all__ = [
    "TriMesh",
    "load_mesh",
    "load_stl",
    "load_obj",
    "box_mesh",
    "cylinder_mesh",
    "sphere_mesh",
    "mesh_aabb",
    "mesh_bounding_sphere",
]


class TriMesh(NamedTuple):
    """Indexed triangle mesh: (V, 3) float64 vertices, (F, 3) int32 faces."""

    vertices: np.ndarray
    faces: np.ndarray

    @property
    def num_vertices(self) -> int:
        return int(self.vertices.shape[0])

    @property
    def num_faces(self) -> int:
        return int(self.faces.shape[0])

    def scaled(self, scale) -> "TriMesh":
        return TriMesh(self.vertices * np.asarray(scale, dtype=np.float64), self.faces)


# -- loaders ------------------------------------------------------------------


def load_mesh(path: str, scale=None) -> TriMesh:
    """Load an STL or OBJ file by extension (reference
    ``mesh_loader.py:31-78``). Falls back to trimesh for other formats
    when it happens to be installed."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".stl":
        mesh = load_stl(path)
    elif ext == ".obj":
        mesh = load_obj(path)
    else:
        try:
            import trimesh  # type: ignore

            tm = trimesh.load(path, force="mesh")
            mesh = TriMesh(
                np.asarray(tm.vertices, dtype=np.float64),
                np.asarray(tm.faces, dtype=np.int32),
            )
        except ImportError as e:
            raise ValueError(
                f"Unsupported mesh format {ext!r} (native loaders cover .stl/.obj; "
                "install trimesh for other formats)"
            ) from e
    if scale is not None:
        mesh = mesh.scaled(scale)
    return mesh


def _try_native(loader_name: str, path: str) -> Optional[TriMesh]:
    """Fast path through the C++ loader (``manipulapy_tpu_torch.native``);
    None on any failure so the caller falls back to pure Python —
    graceful-degradation contract, SURVEY.md section 5."""
    try:
        from .. import native

        if not native.available():
            return None
        verts, faces = getattr(native, loader_name)(path)
        return TriMesh(verts, faces)
    except Exception:
        return None


def load_stl(path: str) -> TriMesh:
    """Binary or ASCII STL (reference ``mesh_loader.py:80-160``).

    Binary detection follows the STL convention: a file is binary if its
    declared triangle count matches the file size (ASCII files that start
    with "solid" would otherwise be misdetected).
    """
    mesh = _try_native("load_stl", path)
    if mesh is not None:
        return mesh
    size = os.path.getsize(path)
    with open(path, "rb") as f:
        header = f.read(84)
        if len(header) >= 84:
            (count,) = struct.unpack("<I", header[80:84])
            if 84 + count * 50 == size:
                return _parse_binary_stl(f, count)
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        return _parse_ascii_stl(f.read())


def _parse_binary_stl(f, count: int) -> TriMesh:
    data = np.frombuffer(f.read(count * 50), dtype=np.uint8).reshape(count, 50)
    tris = data[:, 12:48].copy().view("<f4").reshape(count, 3, 3).astype(np.float64)
    return _index_triangles(tris)


def _parse_ascii_stl(text: str) -> TriMesh:
    verts = []
    for line in text.splitlines():
        parts = line.split()
        if len(parts) == 4 and parts[0] == "vertex":
            verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
    tri = np.asarray(verts, dtype=np.float64)
    if tri.size == 0 or tri.shape[0] % 3 != 0:
        raise ValueError("Malformed ASCII STL: vertex count not a multiple of 3")
    return _index_triangles(tri.reshape(-1, 3, 3))


def _index_triangles(tris: np.ndarray) -> TriMesh:
    """Deduplicate (T, 3, 3) triangle soup into an indexed mesh."""
    flat = tris.reshape(-1, 3)
    verts, inverse = np.unique(flat.round(decimals=9), axis=0, return_inverse=True)
    faces = inverse.reshape(-1, 3).astype(np.int32)
    return TriMesh(verts, faces)


def load_obj(path: str) -> TriMesh:
    """Wavefront OBJ: ``v`` and (triangulated) ``f`` records (reference
    ``mesh_loader.py:162-213``). Polygon faces are fan-triangulated;
    ``v/vt/vn`` index syntax is handled; negative indices resolve from
    the end per the spec."""
    mesh = _try_native("load_obj", path)
    if mesh is not None:
        return mesh
    verts, faces = [], []
    with open(path, "r", encoding="utf-8", errors="replace") as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "v" and len(parts) >= 4:
                verts.append([float(parts[1]), float(parts[2]), float(parts[3])])
            elif parts[0] == "f" and len(parts) >= 4:
                idx = []
                for tok in parts[1:]:
                    i = int(tok.split("/")[0])
                    idx.append(i - 1 if i > 0 else len(verts) + i)
                for k in range(1, len(idx) - 1):  # fan triangulation
                    faces.append([idx[0], idx[k], idx[k + 1]])
    if not verts or not faces:
        raise ValueError(f"OBJ file {path!r} contains no triangles")
    return TriMesh(
        np.asarray(verts, dtype=np.float64), np.asarray(faces, dtype=np.int32)
    )


# -- primitives (reference geometry/primitives.py) ----------------------------


def box_mesh(size=(1.0, 1.0, 1.0)) -> TriMesh:
    """Axis-aligned box centred at the origin."""
    sx, sy, sz = (float(s) / 2.0 for s in size)
    v = np.array(
        [[x, y, z] for x in (-sx, sx) for y in (-sy, sy) for z in (-sz, sz)]
    )
    f = np.array(
        [
            [0, 1, 3], [0, 3, 2],  # -x
            [4, 6, 7], [4, 7, 5],  # +x
            [0, 4, 5], [0, 5, 1],  # -y
            [2, 3, 7], [2, 7, 6],  # +y
            [0, 2, 6], [0, 6, 4],  # -z
            [1, 5, 7], [1, 7, 3],  # +z
        ],
        dtype=np.int32,
    )
    return TriMesh(v, f)


def cylinder_mesh(radius: float = 0.5, length: float = 1.0, segments: int = 32) -> TriMesh:
    """Z-aligned capped cylinder centred at the origin."""
    ang = np.linspace(0.0, 2 * np.pi, segments, endpoint=False)
    ring = np.stack([radius * np.cos(ang), radius * np.sin(ang)], axis=1)
    top = np.concatenate([ring, np.full((segments, 1), length / 2)], axis=1)
    bot = np.concatenate([ring, np.full((segments, 1), -length / 2)], axis=1)
    centers = np.array([[0, 0, length / 2], [0, 0, -length / 2]], dtype=np.float64)
    v = np.concatenate([top, bot, centers])
    ic_top, ic_bot = 2 * segments, 2 * segments + 1
    faces = []
    for i in range(segments):
        j = (i + 1) % segments
        faces.append([i, j, ic_top])  # top cap
        faces.append([segments + j, segments + i, ic_bot])  # bottom cap
        faces.append([i, segments + i, j])  # side
        faces.append([j, segments + i, segments + j])
    return TriMesh(v, np.asarray(faces, dtype=np.int32))


def sphere_mesh(radius: float = 0.5, subdivisions: int = 16) -> TriMesh:
    """UV sphere centred at the origin."""
    n_lat, n_lon = subdivisions, 2 * subdivisions
    lat = np.linspace(0, np.pi, n_lat + 1)
    lon = np.linspace(0, 2 * np.pi, n_lon, endpoint=False)
    verts = []
    for th in lat:
        for ph in lon:
            verts.append(
                [
                    radius * np.sin(th) * np.cos(ph),
                    radius * np.sin(th) * np.sin(ph),
                    radius * np.cos(th),
                ]
            )
    faces = []
    for i in range(n_lat):
        for j in range(n_lon):
            a = i * n_lon + j
            b = i * n_lon + (j + 1) % n_lon
            c = (i + 1) * n_lon + j
            d = (i + 1) * n_lon + (j + 1) % n_lon
            if i > 0:
                faces.append([a, b, c])
            if i < n_lat - 1:
                faces.append([b, d, c])
    return TriMesh(np.asarray(verts), np.asarray(faces, dtype=np.int32))


# -- derived collision abstractions -------------------------------------------


def mesh_aabb(mesh: TriMesh) -> Tuple[np.ndarray, np.ndarray]:
    """(min, max) corners of the axis-aligned bounding box."""
    return mesh.vertices.min(axis=0), mesh.vertices.max(axis=0)


def mesh_bounding_sphere(mesh: TriMesh) -> Tuple[np.ndarray, float]:
    """(center, radius) Ritter-style bounding sphere — the source of the
    per-link sphere radii used by the device-side collision checker."""
    c = mesh.vertices.mean(axis=0)
    r = float(np.linalg.norm(mesh.vertices - c, axis=1).max())
    return c, r
