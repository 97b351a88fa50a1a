"""Procedural replacement meshes: floor, sphere and camera gizmos.

The reference references assets that are absent from its repo (gitignored
``*.obj``): ``floor.obj`` (main.py:48), ``obj_loader_test/sphere.obj`` and
``obj_loader_test/camera.obj`` (core.py:533, 547 — the Light/Camera ``show``
gizmos). These factories generate equivalent meshes procedurally so every demo
scene is reproducible (SURVEY.md §7 step 8).
"""
from __future__ import annotations

import numpy as np

from tpu_renderer_torch.models.model import Model

__all__ = ["make_floor", "make_sphere", "make_camera_gizmo", "make_cube"]


def make_floor(size: float = 2.0, y: float = 0.0, uv_tiles: float = 1.0) -> Model:
    """A two-triangle quad in the XZ plane, UV-mapped, normals up."""
    s = float(size)
    vertices = np.array([
        [-s, y, -s, 1.0],
        [s, y, -s, 1.0],
        [s, y, s, 1.0],
        [-s, y, s, 1.0],
    ], dtype=np.float32)
    t = float(uv_tiles)
    uv = np.array([[0, 0, 0], [t, 0, 0], [t, t, 0], [0, t, 0]], dtype=np.float32)
    normals = np.array([[0, 1, 0]] * 4, dtype=np.float32)
    # Corner layout [vertex, uv, normal, material] (see Model.faces).
    faces = np.array([
        [[0, 0, 0, 0], [2, 2, 2, 0], [1, 1, 1, 0]],
        [[0, 0, 0, 0], [3, 3, 3, 0], [2, 2, 2, 0]],
    ], dtype=np.int32)
    return Model(vertices, uv, normals, faces, shadowing=False)


def make_sphere(subdiv_lat: int = 12, subdiv_lon: int = 18,
                radius: float = 1.0) -> Model:
    """UV sphere (used as the Light gizmo replacing sphere.obj, core.py:533)."""
    lats = np.linspace(0, np.pi, subdiv_lat + 1)
    lons = np.linspace(0, 2 * np.pi, subdiv_lon, endpoint=False)
    verts, norms, uvs = [], [], []
    for i, th in enumerate(lats):
        for j, ph in enumerate(lons):
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
            verts.append([*(radius * n), 1.0])
            norms.append(n)
            uvs.append([j / subdiv_lon, 1 - i / subdiv_lat, 0])

    def vid(i, j):
        return i * subdiv_lon + (j % subdiv_lon)

    faces = []
    for i in range(subdiv_lat):
        for j in range(subdiv_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append([[a, a, a, 0], [b, b, b, 0], [c, c, c, 0]])
            if i < subdiv_lat - 1:
                faces.append([[a, a, a, 0], [c, c, c, 0], [d, d, d, 0]])
    return Model(np.array(verts, np.float32), np.array(uvs, np.float32),
                 np.array(norms, np.float32), np.array(faces, np.int32),
                 shadowing=False)


def make_cube(size: float = 1.0) -> Model:
    """Axis-aligned cube, one quad per face (fan-triangulated)."""
    s = float(size) / 2
    corners = np.array([[x, y, z, 1.0]
                        for x in (-s, s) for y in (-s, s) for z in (-s, s)],
                       dtype=np.float32)
    # (corner ids, outward normal) per face; CCW seen from outside.
    quads = [
        ((1, 5, 7, 3), (0, 0, 1)), ((4, 0, 2, 6), (0, 0, -1)),
        ((5, 4, 6, 7), (1, 0, 0)), ((0, 1, 3, 2), (-1, 0, 0)),
        ((3, 7, 6, 2), (0, 1, 0)), ((0, 4, 5, 1), (0, -1, 0)),
    ]
    normals = np.array([n for _, n in quads], dtype=np.float32)
    uv = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], dtype=np.float32)
    faces = []
    for fi, (q, _) in enumerate(quads):
        for tri in ((0, 1, 2), (0, 2, 3)):
            faces.append([[q[k], k, fi, 0] for k in tri])
    return Model(corners, uv, normals, np.array(faces, np.int32), shadowing=False)


def make_camera_gizmo(size: float = 1.0) -> Model:
    """Small frustum-shaped mesh replacing the reference's missing camera.obj."""
    s = float(size)
    vertices = np.array([
        [0, 0, 0, 1],                              # apex
        [-s, -s, 2 * s, 1], [s, -s, 2 * s, 1],
        [s, s, 2 * s, 1], [-s, s, 2 * s, 1],
    ], dtype=np.float32)
    tris = [(0, 2, 1), (0, 3, 2), (0, 4, 3), (0, 1, 4), (1, 2, 3), (1, 3, 4)]
    faces = np.array([[[v, -1, -1, 0] for v in tri] for tri in tris],
                     dtype=np.int32)
    return Model(vertices, None, None, faces, shadowing=False)
