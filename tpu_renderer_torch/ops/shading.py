"""Deferred, pixel-parallel Blinn-Phong shading, in PyTorch.

Counterpart of ``tpu_renderer/ops/shading.py`` (``shade_general`` and its
helpers). Semantics follow the reference, quirks included: ambient-only
shadowed result ``clip(0.05, 1)`` (triangular.py:145-147), diffuse intensity
NOT clamped at zero (:169-170), spot cone smoothstep cos20°→cos10°
(:157-161), and the specular factor arriving pre-scaled by 255
(core.py:145-153).

The flat, gouraud and PBR shaders are not ported yet.
"""
from __future__ import annotations

import math

import torch

from tpu_renderer_torch.ops.lightning import Lightning
from tpu_renderer_torch.ops.transforms import normalize

__all__ = ["smoothstep", "shade_general"]

_COS20 = math.cos(math.radians(20.0))
_COS10 = math.cos(math.radians(10.0))


def smoothstep(edge0, edge1, x):
    """Hermite smoothstep (reference core.py:497-515)."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def shade_general(pix, light, camera_position, *, shadows_mask=None):
    """Blinn-Phong ambient + lit shading (reference general_shading).

    pix: dict of per-pixel tensors — ``color`` (H, W, 3), ``normal``
    (H, W, 3) normalized world normal, ``frag_world`` (H, W, 3),
    ``specular_light`` (H, W, 1 or 3), ``ns`` (H, W, 1).
    light: dict with position, direction, color, ambient (3,), scalars
    specular_strength, constant, linear, quadratic, and ``light_type``.
    shadows_mask: optional (H, W) bool, True where the pixel is in shadow
    (stencil != 0): those pixels take the ambient-only result.

    Returns (H, W, 3) float32 in [0.05, 1].
    """
    frag = pix["frag_world"]
    distance = torch.linalg.vector_norm(light["position"] - frag, dim=-1)
    att = (1.0 / (light["constant"] + distance *
                  (light["linear"] + light["quadratic"] * distance)))[..., None]

    color = pix["color"]
    ambient_rgb = torch.clamp(att * light["ambient"] * color, 0.05, 1.0)

    normals = pix["normal"]
    if light["light_type"] == Lightning.DIRECTIONAL_LIGHTNING:
        light_dir = light["direction"].expand(frag.shape)
    else:
        light_dir = normalize(light["position"] - frag)

    view_dir = normalize(camera_position - frag)
    if light["light_type"] == Lightning.SPOT_LIGHTNING:
        in_light = smoothstep(_COS20, _COS10,
                              (light["direction"] * light_dir).sum(-1))
        color = color * in_light[..., None]

    halfway = normalize(light_dir + view_dir)
    spec_reflection = torch.clamp(
        (normals * halfway).sum(-1), min=0)[..., None] ** pix["ns"]
    specular = (light["color"] * spec_reflection *
                light["specular_strength"] * pix["specular_light"])
    intensity = (normals * light_dir).sum(-1)[..., None]
    diffuse = intensity * light["color"]       # deliberately unclamped (:169)
    lit_rgb = torch.clamp(att * color * (light["ambient"] + diffuse + specular),
                          0.05, 1.0)

    if shadows_mask is None:
        return lit_rgb
    return torch.where(shadows_mask[..., None], ambient_rgb, lit_rgb)
