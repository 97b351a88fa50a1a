"""Minimal OBJ/MTL writer.

Counterpart of ``tpu_renderer/utils/objwrite.py``, the same numpy code:
standard ``v/vt/vn`` lines and ``f a/b/c`` polygons that this package's
loader (``Model.load_model``, Python or native) and the reference's parse
alike. The JAX package's heterogeneous-scene golden writes its models with
it; here it is also a small export utility.

Quad faces are written as quads on purpose: the loaders fan-triangulate
(the reference's core.py polygon fan), so a round trip exercises that path.
"""
from __future__ import annotations

import os

import numpy as np

__all__ = ["write_obj", "write_textured_box"]


def write_obj(path, vertices, uvs, normals, faces, texture=None,
              mtl_name="mat0"):
    """Write an OBJ (and a sibling .mtl when ``texture`` is given).

    vertices: (V, 3); uvs: (T, 2) | None; normals: (N, 3) | None;
    faces: list of lists of (vi, ti, ni) 0-based corner index triples
    (ti/ni may be None); texture: image path for map_Kd.
    """
    lines = []
    mtl_path = None
    if texture is not None:
        mtl_path = os.path.splitext(path)[0] + ".mtl"
        lines.append(f"mtllib {os.path.basename(mtl_path)}")
    for v in np.asarray(vertices, dtype=np.float64):
        lines.append("v " + " ".join(f"{c:.8g}" for c in v))
    if uvs is not None:
        for t in np.asarray(uvs, dtype=np.float64):
            lines.append("vt " + " ".join(f"{c:.8g}" for c in t))
    if normals is not None:
        for n in np.asarray(normals, dtype=np.float64):
            lines.append("vn " + " ".join(f"{c:.8g}" for c in n))
    if texture is not None:
        lines.append(f"usemtl {mtl_name}")
    for face in faces:
        parts = []
        for (vi, ti, ni) in face:
            s = str(vi + 1)
            if ti is not None:
                s += f"/{ti + 1}"
                if ni is not None:
                    s += f"/{ni + 1}"
            elif ni is not None:
                s += f"//{ni + 1}"
            parts.append(s)
        lines.append("f " + " ".join(parts))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")
    if mtl_path is not None:
        with open(mtl_path, "w") as f:
            f.write(f"newmtl {mtl_name}\n"
                    f"Ns 32.0\nKa 1 1 1\nKd 1 1 1\nKs 0.5 0.5 0.5\n"
                    f"map_Kd {texture}\n")
    return path


def write_textured_box(path, texture, size=1.0, center=(0.0, 0.0, 0.0)):
    """An axis-aligned box with per-face UVs over the full texture, written
    as six QUADS (exercises the loaders' fan triangulation)."""
    s = size / 2.0
    cx, cy, cz = center
    corners = np.array([[x, y, z] for x in (-s, s) for y in (-s, s)
                        for z in (-s, s)]) + [cx, cy, cz]
    uvs = np.array([[0, 0], [1, 0], [1, 1], [0, 1]], dtype=np.float64)
    normals = np.array([[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0],
                        [0, 0, -1], [0, 0, 1]], dtype=np.float64)
    # Each quad: corner indices into `corners`, CCW seen from outside.
    quads = [([0, 1, 3, 2], 0), ([4, 6, 7, 5], 1), ([0, 4, 5, 1], 2),
             ([2, 3, 7, 6], 3), ([0, 2, 6, 4], 4), ([1, 5, 7, 3], 5)]
    faces = [[(vi, k, ni) for k, vi in enumerate(vids)]
             for vids, ni in quads]
    return write_obj(path, corners, uvs, normals, faces, texture=texture)
