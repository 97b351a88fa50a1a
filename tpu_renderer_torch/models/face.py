"""Host-side per-triangle view: the reference's ``Face`` API (core.py:108-228).

Counterpart of ``tpu_renderer/models/face.py``, in numpy (float64 where the
reference computes). The render path never builds these (it is
struct-of-arrays end to end); ``Face`` exists for API parity, debugging,
and as executable documentation of the per-fragment semantics the deferred
shader implements in batch: perspective-corrected barycentrics
(``screen_perspective``), nearest-neighbour texture addressing with the V
flip and the max-only clamp (``get_UV``), the normal-source priority
(``get_normals``) and the per-pixel TBN solve (``tangent_``).
"""
from __future__ import annotations

from typing import Optional

import numpy as np

__all__ = ["Face"]


def _normalize(a, axis=-1):
    a = np.asarray(a, dtype=np.float64)
    n = np.linalg.norm(a, axis=axis, keepdims=True)
    n = np.where(n == 0, 1, n)
    return a / n


class Face:
    """One triangle of a model with attribute-fetch helpers."""

    def __init__(self, instance, Vi, Ti: Optional[np.ndarray] = None,
                 Ni: Optional[np.ndarray] = None, material=None):
        self._vi = np.asarray(Vi)
        self._ti = None if Ti is None else np.asarray(Ti)
        self._ni = None if Ni is None else np.asarray(Ni)
        self.model = instance
        self.vertices = instance.vertices[self._vi]
        self.world_vertices = self.vertices.copy()
        self.uv = (instance.uv[self._ti]
                   if instance.uv is not None and self._ti is not None else None)
        self.normals = (instance.normals[self._ni]
                        if instance.normals is not None and self._ni is not None
                        else None)
        if material is not None:
            self.material = instance.material_for_group(int(np.asarray(material)[0]))
        else:
            self.material = instance.materials["default"]

    # ------------------------------------------------------------ normals

    @property
    def unit_normal_world_space(self) -> np.ndarray:
        """Unit face normal from the world-space vertices (core.py:127-130)."""
        a, b, c = self.world_vertices[:, :3]
        return _normalize(np.cross(b - a, c - a)).squeeze()

    @property
    def unit_normal_current_space(self) -> np.ndarray:
        """Unit face normal of the current (post-transform) vertices — the
        screen-space backface test uses its z (core.py:132-136)."""
        a, b, c = self.vertices[:, :3]
        return _normalize(np.cross(b - a, c - a)).squeeze()

    # ------------------------------------------------------------ fetches

    def screen_perspective(self, bar_screen):
        """Perspective-corrected barycentric: 1/w-weighted and renormalized
        (core.py:155-160). The vertices' W column holds 1/w after the
        perspective divide (triangular.py:42-45)."""
        bar_screen = np.asarray(bar_screen)
        w_coord = bar_screen @ self.vertices[:, [3]]
        perspective = bar_screen * self.vertices[:, 3] / w_coord
        if perspective.size:
            return perspective
        return None

    def get_UV(self, shape, perspective_bar):
        """Texture indices: V-flip, clip(max=1) only — negative barycentrics
        wrap-index like numpy (core.py:138-143)."""
        pb = np.asarray(perspective_bar)
        v = (pb @ self.uv[..., 0]).clip(max=1.0) * (shape[1] - 1)
        u = (1.0 - (pb @ self.uv[..., 1])).clip(max=1.0) * (shape[0] - 1)
        return np.array((u, v)).astype(np.int32)

    def get_object_color(self, bar):
        """Diffuse map sample or flat Kd (core.py:162-173)."""
        if hasattr(self.material, "map_Kd"):
            *shape, _ = self.material.map_Kd.shape
            u, v = self.get_UV(shape, bar)
            return self.material.map_Kd[u, v]
        return self.material.Kd

    def get_specular(self, bar):
        """Specular map red channel * 255, or Ks * 255 (core.py:145-153)."""
        if hasattr(self.material, "map_Ks"):
            *shape, _ = self.material.map_Ks.shape
            u, v = self.get_UV(shape, bar)
            return self.material.map_Ks[u, v, 0, np.newaxis] * 255
        return self.material.Ks * 255

    def get_normals(self, bar):
        """Normal source priority: normal map (tangent-space via TBN when
        flagged) > vertex normals > face normal (core.py:175-189)."""
        if hasattr(self.material, "norm"):
            *shape, _ = self.material.norm.shape
            u, v = self.get_UV(shape, bar)
            norm = self.material.norm[u, v]
            if (self.material.norm.dtype.metadata or {}).get("tangent"):
                norm = (self.tangent_(bar) @ norm[..., np.newaxis]).squeeze()
        elif self.normals is not None:
            norm = bar @ self.normals
        else:
            norm = bar @ np.array([self.unit_normal_world_space] * 3)
        return _normalize(norm).squeeze()

    def tangent_(self, bar):
        """Per-pixel tangent basis: solve A @ [T B] = [du dv] with A rows
        (b-a, c-a, n) (core.py:191-224). Returns (N, 3, 3) with columns
        (T̂, B̂, n)."""
        a, b, c = self.world_vertices[:, :3]
        n = _normalize(bar @ self.normals)

        A = np.zeros((*n.shape, 3))
        A[:, 0] = b - a
        A[:, 1] = c - a
        A[:, 2] = n
        AI = np.linalg.inv(A)

        u_comp, v_comp, _ = self.uv.T
        tangent = AI @ np.array([u_comp[1] - u_comp[0],
                                 u_comp[2] - u_comp[0], 0])
        bitangent = AI @ np.array([v_comp[1] - v_comp[0],
                                   v_comp[2] - v_comp[0], 0])

        basis = np.empty((*n.shape, 3))
        basis[..., 0] = _normalize(tangent)
        basis[..., 1] = _normalize(bitangent)
        basis[..., 2] = n
        return basis

    @staticmethod
    def linearize_z(depth, camera):
        """Viewport-z linearization (core.py:226-228)."""
        return ((2 * camera.near * camera.far) /
                (camera.far + camera.near - depth * (camera.far - camera.near)))
