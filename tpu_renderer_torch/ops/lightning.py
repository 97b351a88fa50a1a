"""Light-type enum.

The reference names this module and enum "Lightning" (obj/lightning.py:4-7 —
presumably a misspelling of "lighting"); both the name and the member spelling
are part of the public API its users write (``light_type=
Lightning.DIRECTIONAL_LIGHTNING``, main.py:64), so they are preserved
verbatim here.

Semantics (ops/shading.py::shade_general, reference triangular.py:151-161):

- DIRECTIONAL: the light direction is constant, ``normalize(position -
  center)``; attenuation still uses the position (the reference applies its
  distance falloff to every light type).
- POINT: per-fragment direction ``normalize(position - fragment)``.
- SPOT: point-light direction plus a Hermite-smoothstep cone factor between
  cos(20°) and cos(10°) against the light's own axis.

The enum value is part of the static scene configuration
(pipeline.SceneConfig.light_type); position and color are per-frame inputs.
"""
from enum import Enum

__all__ = ["Lightning"]


class Lightning(Enum):
    """Reference-compatible light kinds (obj/lightning.py)."""

    DIRECTIONAL_LIGHTNING = 0
    POINT_LIGHTNING = 1
    SPOT_LIGHTNING = 2
