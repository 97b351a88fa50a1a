"""Deferred, pixel-parallel shading, in PyTorch.

Counterpart of ``tpu_renderer/ops/shading.py``: the general Blinn-Phong
shader and the flat, gouraud and Cook-Torrance PBR shaders, each term in
the JAX package's expression order. Semantics follow the reference, quirks
included: ambient-only shadowed result ``clip(0.05, 1)``
(triangular.py:145-147), diffuse intensity NOT clamped at zero (:169-170),
spot cone smoothstep cos20°→cos10° (:157-161), the specular factor arriving
pre-scaled by 255 (core.py:145-153), and flat/gouraud writing a 0..255-scale
intensity into the float frame (:174-182).

``pixel_barycentric``, ``sample_texture`` and ``tangent_basis_normal`` are
the per-pixel forms of the reference's Face fetches (core.py:138-224):
the render path computes them inside K2 and K3, these plain functions
remain as API surface and for checks.
"""
from __future__ import annotations

import math

import torch

from tpu_renderer_torch.ops.lightning import Lightning
from tpu_renderer_torch.ops.transforms import normalize

__all__ = ["pixel_barycentric", "sample_texture", "tangent_basis_normal",
           "smoothstep", "mix", "shade_general", "shade_flat",
           "shade_gouraud", "shade_gouraud_n", "fresnel_schlick",
           "distribution_ggx", "geometry_schlick_ggx", "geometry_smith",
           "shade_pbr"]

_COS20 = math.cos(math.radians(20.0))
_COS10 = math.cos(math.radians(10.0))


def smoothstep(edge0, edge1, x):
    """Hermite smoothstep (reference core.py:497-515)."""
    t = torch.clamp((x - edge0) / (edge1 - edge0), 0.0, 1.0)
    return t * t * (3 - 2 * t)


def mix(x, y, a):
    """Linear interpolation (reference triangular.py:391-395)."""
    return x * (1 - a) + y * a


def pixel_barycentric(aff, inv_w, row0=0):
    """Screen and perspective-corrected barycentrics for every pixel.

    aff: (H, W, 9) the winning face's affine barycentric coefficients per
    pixel (vertex.gather_faces); inv_w: (H, W, 3); ``row0`` offsets the
    rows into the whole frame. Returns (bar, pb), both (H, W, 3): ``pb`` is
    the reference's ``screen_perspective`` (core.py:155-160), bar * (1/w)
    renormalized.
    """
    H, W = aff.shape[:2]
    cols = torch.arange(W, dtype=torch.float32, device=aff.device)[None, :]
    rows = torch.arange(H, dtype=torch.float32,
                        device=aff.device)[:, None] + row0
    v = aff[..., 0] * cols + aff[..., 1] * rows + aff[..., 2]
    w = aff[..., 3] * cols + aff[..., 4] * rows + aff[..., 5]
    bar = torch.stack([1.0 - v - w, v, w], dim=-1)
    scaled = bar * inv_w
    return bar, scaled / scaled.sum(-1, keepdim=True)


def sample_texture(texture, pb, uv):
    """Nearest-texel fetch with the reference's UV mapping (get_UV,
    core.py:138-143): the column from the interpolated u, the row from 1 −
    the interpolated v, each clipped at max=1 only, truncated, and wrapped
    like numpy's negative indices.

    texture: (TH, TW, C); pb: (H, W, 3) perspective-corrected barycentrics;
    uv: (H, W, 3, 2) per-corner (u, v). Returns (H, W, C).
    """
    from tpu_renderer_torch.ops.raster_cuda import _wrap_clamped

    th, tw = texture.shape[0], texture.shape[1]
    iu = (pb * uv[..., 0]).sum(-1)
    iv = (pb * uv[..., 1]).sum(-1)
    col = _wrap_clamped(torch.clamp(iu, max=1.0) * (tw - 1), float(tw))
    row = _wrap_clamped((1.0 - torch.clamp(iv, max=1.0)) * (th - 1),
                        float(th))
    return texture[row, col]


def _inv3x3(m):
    """Batched closed-form 3x3 inverse by the adjugate; m: (..., 3, 3)."""
    r0, r1, r2 = m[..., 0, :], m[..., 1, :], m[..., 2, :]
    c0 = torch.linalg.cross(r1, r2)
    c1 = torch.linalg.cross(r2, r0)
    c2 = torch.linalg.cross(r0, r1)
    det = (r0 * c0).sum(-1, keepdim=True)[..., None]
    return torch.stack([c0, c1, c2], dim=-1) / det


def tangent_basis_normal(sampled, pb, world, uv, normals):
    """World-space normal from a tangent-space normal-map sample, by the
    per-pixel TBN of Face.tangent_ (core.py:191-224): solve A @ [T B] =
    [du dv] with A's rows (b − a, c − a, n), then rotate the sample by the
    (T, B, n) basis.

    sampled: (H, W, 3) in [-1, 1]; pb: (H, W, 3); world: (H, W, 3, 3)
    triangle world xyz; uv: (H, W, 3, 2); normals: (H, W, 3, 3) vertex
    normals.
    """
    n = normalize(torch.einsum("...k,...kc->...c", pb, normals))
    a = world[..., 0, :]
    A = torch.stack([world[..., 1, :] - a, world[..., 2, :] - a, n], dim=-2)
    AI = _inv3x3(A)
    zero = torch.zeros_like(uv[..., 0, 0])
    du = torch.stack([uv[..., 1, 0] - uv[..., 0, 0],
                      uv[..., 2, 0] - uv[..., 0, 0], zero], dim=-1)
    dv = torch.stack([uv[..., 1, 1] - uv[..., 0, 1],
                      uv[..., 2, 1] - uv[..., 0, 1], zero], dim=-1)
    tangent = normalize(torch.einsum("...ij,...j->...i", AI, du))
    bitangent = normalize(torch.einsum("...ij,...j->...i", AI, dv))
    basis = torch.stack([tangent, bitangent, n], dim=-1)    # columns T, B, n
    return torch.einsum("...ij,...j->...i", basis, sampled)


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


def shade_flat(face_world_normal, light):
    """Flat shading (reference triangular.py:174-177): the winning face's
    (H, W, 3) world normal against the light direction, clipped to
    [0.3, 1] and scaled to 0..255 like the reference."""
    intensity = (face_world_normal * light["direction"]).sum(-1)
    return torch.clamp(intensity, 0.3, 1.0)[..., None] * _full3(
        255.0, intensity)


def shade_gouraud(bar, normals, light):
    """Gouraud shading (reference triangular.py:180-182): (H, W, 3) screen
    barycentrics times (H, W, 3, 3) vertex normals."""
    return shade_gouraud_n((bar[..., :, None] * normals).sum(-2), light)


def shade_gouraud_n(n, light):
    """Gouraud from a pre-interpolated (H, W, 3) vertex normal (the slim
    G-buffer's channels 0-2)."""
    intensity = torch.clamp((n * light["direction"]).sum(-1), 0, 1)
    return intensity[..., None] * _full3(255.0, intensity)


def _full3(value, like):
    return torch.full((3,), value, dtype=torch.float32, device=like.device)


# ----------------------------------------------------------------- PBR (GGX)

def fresnel_schlick(cos_theta, F0):
    """(reference triangular.py:185-187)"""
    return F0 + (1.0 - F0) * ((1 - cos_theta[..., None]) ** 5)


def distribution_ggx(N, H, roughness):
    """(reference triangular.py:190-199)"""
    a2 = (roughness * roughness) ** 2
    ndoth = torch.clamp((N * H).sum(-1), min=0)
    denom = ndoth * ndoth * (a2 - 1.0) + 1.0
    return a2 / (math.pi * denom * denom)


def geometry_schlick_ggx(ndotv, roughness):
    """(reference triangular.py:202-208)"""
    r = roughness + 1.0
    k = (r * r) / 8.0
    return ndotv / (ndotv * (1.0 - k) + k)


def geometry_smith(N, V, L, roughness):
    """(reference triangular.py:211-217)"""
    ndotv = torch.clamp((N * V).sum(-1), min=0)
    ndotl = torch.clamp((N * L).sum(-1), min=0)
    return (geometry_schlick_ggx(ndotl, roughness)
            * geometry_schlick_ggx(ndotv, roughness))


def shade_pbr(pix, light, camera_position):
    """Cook-Torrance PBR (reference triangular.py:220-266), with a Reinhard
    tonemap and gamma 1/2.2.

    pix: ``normal_raw`` (H, W, 3) normalized screen-barycentric vertex
    normal, ``screen_pos`` (H, W, 3) interpolated (sx, sy, z_lin) — the
    reference lights post-viewport positions — ``metallic`` (H, W, 1),
    ``roughness`` (H, W) and ``ao`` (H, W, 3) material Pm, Pr, Ka. The
    ranks matter: roughness meets (H, W) dot products, metallic broadcasts
    against RGB.
    """
    albedo = 1.0
    metallic = pix["metallic"]
    roughness = pix["roughness"]
    ao = pix["ao"]

    N = pix["normal_raw"]
    V = normalize(camera_position - pix["screen_pos"])
    F0 = mix(_full3(0.04, N), albedo, metallic)

    to_light = light["position"] - pix["screen_pos"]
    L = normalize(to_light)
    H = normalize(V + L)
    distance = torch.linalg.vector_norm(to_light, dim=-1)
    radiance = light["color"] * (1.0 / (distance * distance))[..., None]

    ndf = distribution_ggx(N, H, roughness)[..., None]
    g = geometry_smith(N, V, L, roughness)[..., None]
    f = fresnel_schlick(torch.clamp((H * V).sum(-1), min=0), F0)

    ks = f
    kd = (1.0 - ks) * (1.0 - metallic)

    numerator = ndf * g * f
    denominator = (4.0 * torch.clamp((N * V).sum(-1), min=0) *
                   torch.clamp((N * L).sum(-1), min=0) + 0.0001)
    specular = numerator / denominator[..., None]

    ndotl = torch.clamp((N * L).sum(-1), min=0)
    lo = (kd * albedo / math.pi + specular) * radiance * ndotl[..., None]
    color = albedo * ao + lo
    color = color / (color + 1.0)
    return color ** (1.0 / 2.2)
