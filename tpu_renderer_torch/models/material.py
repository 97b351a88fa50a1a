"""Wavefront MTL material attribute bag.

Parity with the reference's ``obj/materials.py``: same class-level defaults, same
``__setattr__`` coercion rules (1-element values become floats, n-element values
become float32 arrays), and the diffuse/ambient/specular/shininess alias map —
with the reference's ``super(self)`` bug (materials.py:75, TypeError on any alias
access) fixed: an alias resolves to the texture map if present, else the scalar
color attribute.
"""
from __future__ import annotations

import numpy as np

_ALIASES = {
    "diffuse": ("map_Kd", "Kd"),
    "ambient": ("map_Ka", "Ka"),
    "specular": ("map_Ks", "Ks"),
    "shininess": ("map_Ns", "Ns"),
}


class Material:
    """See https://paulbourke.net/dataformats/mtl/ and reference materials.py:4-77.

    Ka/Kd/Ks ambient/diffuse/specular colors, Ns specular exponent, d/Tr
    transparency, illum illumination model, Pm/Pr metalness/roughness (PBR).
    Texture maps land as ``map_Kd``/``map_Ks``/``norm``/... attributes holding
    float32 HxWx3 arrays in [0, 1] (normal maps in [-1, 1] when normalized).
    """

    Pm = 0.5
    Pr = 0.5
    Ka = np.array((0.3, 0, 0))
    Kd = np.array((0.8, 0.8, 0.8))
    Ks = np.array((1.0, 1.0, 1.0))
    d = 1.0
    Tr = 0
    Ns = 64
    illum = 1

    def __setattr__(self, key, value):
        # MTL values arrive as token lists; scalars coerce to float when
        # possible, vectors to float32 arrays (reference materials.py:57-64).
        if np.ndim(value) == 0 and not isinstance(value, (list, tuple)):
            super().__setattr__(key, value)
        elif len(value) == 1:
            try:
                super().__setattr__(key, float(value[0]))
            except (TypeError, ValueError):
                super().__setattr__(key, value[0])
        else:
            super().__setattr__(key, np.array(value, dtype=np.float32))

    def __getattr__(self, item):
        alias = _ALIASES.get(item)
        if alias is None:
            raise AttributeError("No such attribute", item)
        map_key, color_key = alias
        try:
            return object.__getattribute__(self, map_key)
        except AttributeError:
            return getattr(self, color_key)

    def has(self, key: str) -> bool:
        """True when a texture map / attribute is present on this material."""
        try:
            object.__getattribute__(self, key)
            return True
        except AttributeError:
            return key in type(self).__dict__
