"""The builder ``stand_ins``: bench.py's scenes with seeded stand-ins for
its assets (a frozen copy of bench_torch.py's ``stand_in_mesh``,
``build_scene`` and ``build_highpoly_scene``).

The diablo3_pose OBJ and its TGAs are not in the repository: the mesh is a
UV sphere displaced by seeded noise, with area-weighted vertex normals, a
seeded diffuse map and a tangent normal map; the floor's map is a seeded
checker.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from rbench import scenes


def _smooth_noise(rng, shape, octaves=4):
    h, w = shape
    y, x = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                       np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    out = np.zeros(shape, np.float32)
    for o in range(octaves):
        f = 2.0 ** (o + 1)
        for _ in range(3):
            fx, fy = rng.integers(1, 4, 2) * f
            ph = rng.uniform(0, 2 * np.pi)
            out += np.sin(2 * np.pi * (fx * x + fy * y) + ph) / (o + 1)
    out -= out.min()
    return out / out.max()


def _vertex_normals(verts, faces):
    v = verts[:, :3].astype(np.float64)
    fv = faces[:, :, 0]
    n = np.cross(v[fv[:, 1]] - v[fv[:, 0]], v[fv[:, 2]] - v[fv[:, 0]])
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, fv[:, k], n)
    acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
    return acc.astype(np.float32)


def _tangent_normal_map(rng, tex):
    height = _smooth_noise(rng, (tex, tex)) * 8.0
    gy, gx = np.gradient(height)
    nm = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    nm8 = np.round((nm * 0.5 + 0.5) * 255) / 255.0
    return np.asarray(nm8 * 2 - 1, dtype=np.float32)


def _floor_map(rng, tex):
    checker = ((np.indices((tex, tex)) // 64).sum(0) % 2).astype(np.float32)
    return np.stack(
        [0.35 + 0.4 * checker, 0.35 + 0.3 * _smooth_noise(rng, (tex, tex)),
         0.3 + 0.2 * checker], axis=-1).astype(np.float32)


def _stand_in_mesh(rng, tex, bands):
    """The diablo3_pose stand-in: a UV sphere displaced by seeded noise,
    area-weighted vertex normals, a seeded diffuse map and a tangent
    normal map, shadowing."""
    base_verts, uv, _, faces = scenes.sphere(*bands)
    n = base_verts[:, :3]
    th = np.arccos(np.clip(n[:, 1], -1, 1))
    ph = np.arctan2(n[:, 2], n[:, 0])
    bump = np.zeros(len(n), np.float32)
    for _ in range(6):
        a, b = rng.integers(1, 5, 2)
        bump += rng.uniform(0.02, 0.06) * np.sin(a * th + rng.uniform(0, 6)) \
            * np.cos(b * ph + rng.uniform(0, 6))
    verts = base_verts.copy()
    verts[:, :3] = n * (1.0 + bump)[:, None]
    diffuse = np.stack([_smooth_noise(rng, (tex, tex)) for _ in range(3)],
                       axis=-1).astype(np.float32)
    norm = _tangent_normal_map(rng, tex)
    return scenes.MeshSpec(vertices=verts, uv=uv, normals=_vertex_normals(verts,
                                                                   faces),
                    faces=faces, shadowing=True, map_kd=diffuse, norm=norm,
                    norm_tangent=True)


def _floor_spec(rng, tex, size, y):
    v, uv, n, f = scenes.floor(size, y)
    return scenes.MeshSpec(vertices=v, uv=uv, normals=n, faces=f, shadowing=False,
                    map_kd=_floor_map(rng, tex))


def build(cfg: dict, seed: int) -> scenes.SceneSpec:
    """bench.py's scenes with stand-ins for its assets: the textured
    stand-in mesh alone (``instances`` 0, bench.py:25-49) or ``instances``
    copies of it on bench.py:93-115's grid with its scales and rotations
    (``grid_spacing``), over a textured floor (``floor`` size, or 1.2 times
    the grid's width when the size is null), in that order."""
    rng = np.random.default_rng(seed)
    tex = int(cfg["texture_size"])
    base = _stand_in_mesh(rng, tex, tuple(cfg["mesh_bands"]))
    n = int(cfg["instances"])
    models = []
    if n == 0:
        models.append(base)
        size = cfg["floor"]["size"]
    else:
        side = int(np.ceil(np.sqrt(n)))
        spacing = cfg["grid_spacing"]
        for i in range(n):
            r, c = divmod(i, side)
            x = (c - (side - 1) / 2) * spacing
            z = (r - (side - 1) / 2) * spacing
            models.append(dataclasses.replace(base, transform=scenes.mat(
                scenes.scale(0.9 + 0.2 * ((i * 7) % 5) / 4),
                scenes.rotate_xyz([0, (i * 37) % 360, 0]),
                scenes.translation([x, 0, z]))))
        size = cfg["floor"]["size"]
        if size is None:
            size = 1.2 * side * spacing
    models.append(_floor_spec(rng, tex, size, cfg["floor"]["y"]))
    return scenes.SceneSpec(
        resolution=tuple(cfg["resolution"]), shadows=bool(cfg["shadows"]),
        backface_culling=bool(cfg["camera"]["backface_culling"]),
        camera=dict(cfg["camera"]), light=dict(cfg["light"]), models=models)
