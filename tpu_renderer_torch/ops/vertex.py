"""Batched vertex stage: world -> clip -> NDC -> screen, in PyTorch.

Counterpart of ``tpu_renderer/ops/vertex.py``. All V vertices of a model
transform through the MVP at once; the perspective divide keeps 1/w per
vertex for perspective-correct interpolation; per-face attribute triples come
from one gather of a packed per-vertex table.

The 4x4 products are written out as elementwise sums in a fixed order
(``_rowvec``): elementwise float32 ops round the same way on the CPU and on
the GPU, so the port's geometry — and therefore every kernel input — is
bit-identical whichever device renders.

Face validity folds the reference's early-out Errors into masks
(triangular.py:15-20, 47-48, 69-78): backface culling by screen-space normal
z, degenerate barycentric denominator, and empty clamped bounding box.
"""
from __future__ import annotations

import torch

from tpu_renderer_torch.ops.transforms import bound_box_batch

__all__ = ["linearize_z", "transform_vertices", "gather_faces",
           "screen_normal_z"]


def _rowvec(v, m):
    """(..., 4) row vectors times a (4, 4) matrix, summed left to right."""
    return (((v[..., 0:1] * m[0] + v[..., 1:2] * m[1]) + v[..., 2:3] * m[2])
            + v[..., 3:4] * m[3])


def linearize_z(depth, near, far):
    """Depth linearization (reference core.py:226-228), applied to the
    viewport-transformed z exactly like triangular.py:96."""
    return (2 * near * far) / (far + near - depth * (far - near))


def transform_vertices(world_vertices, mvp, viewport, near, far):
    """(V, 4) world -> dict of per-vertex pipeline tensors.

    Returns: clip (V, 4) clip-space positions; inv_w (V,); screen (V, 4) with
    xy in pixels and the reference's viewport z; zlin (V,) linearized depth;
    world (V, 3).
    """
    world_vertices = world_vertices.to(torch.float32)
    clip = _rowvec(world_vertices, mvp)
    inv_w = 1.0 / clip[:, 3]
    ndc = clip * inv_w[:, None]
    screen = _rowvec(ndc, viewport)
    zlin = linearize_z(screen[:, 2], near, far)
    return {"clip": clip, "inv_w": inv_w, "screen": screen, "zlin": zlin,
            "world": world_vertices[:, :3]}


def screen_normal_z(sx, sy, sz):
    """Z component of the (unnormalized) screen-space face normal, sign-equal
    to the reference's ``unit_normal_current_space[2]`` (core.py:133-136).
    sx, sy, sz: (F, 3) per-face vertex components."""
    abx, aby = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    acx, acy = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    return abx * acy - aby * acx


def gather_faces(vert_arrays, face_vid, height, width, backface_culling):
    """Per-face triples + validity masks from per-vertex pipeline tensors.

    vert_arrays: output of :func:`transform_vertices`; face_vid: (F, 3) int
    vertex ids. Returns dict with sx/sy/szlin/inv_w (F, 3), aff (F, 9),
    clip (F, 3, 4), bbox (F, 4) int32, denom (F,), world (F, 3, 3), and
    valid (F,), which folds the masks (F,) it also returns: culled (all
    False without ``backface_culling``), degenerate and box_valid.
    """
    parts = [vert_arrays["screen"], vert_arrays["clip"],
             vert_arrays["inv_w"][:, None], vert_arrays["zlin"][:, None],
             vert_arrays["world"]]
    packed = torch.cat(parts, dim=1)[face_vid.long()]   # ONE (F, 3, 13) gather
    screen = packed[..., 0:4]
    clip = packed[..., 4:8]
    inv_w = packed[..., 8]
    zlin = packed[..., 9]

    sx = screen[..., 0]
    sy = screen[..., 1]
    sz = screen[..., 2]

    if backface_culling:
        # Cull when the normalized screen normal z < 0 (triangular.py:47-48).
        culled = screen_normal_z(sx, sy, sz) < 0
    else:
        culled = torch.zeros(face_vid.shape[0], dtype=torch.bool,
                             device=face_vid.device)

    # Barycentric denominator (transformation.py:25-27) on screen xy.
    v0x, v0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
    v1x, v1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
    d00 = v0x * v0x + v0y * v0y
    d01 = v0x * v1x + v0y * v1y
    d11 = v1x * v1x + v1y * v1y
    denom = d00 * d11 - d01 * d01
    degenerate = denom == 0                              # Errors.EMPTY_B

    # Screen barycentrics as per-face AFFINE functions of the pixel:
    # v = av*x + bv*y + cv, w likewise, u = 1 - v - w, z = az*x + bz*y + cz.
    # Every rasterizer and the G-buffer evaluate these coefficients with the
    # same expression (vertex.py:105-126 of the JAX package, term for term).
    ax, ay = sx[:, 0], sy[:, 0]
    inv_denom = 1.0 / torch.where(degenerate, torch.ones_like(denom), denom)
    av = (d11 * v0x - d01 * v1x) * inv_denom
    bv = (d11 * v0y - d01 * v1y) * inv_denom
    cv = -(ax * av + ay * bv)
    aw = (d00 * v1x - d01 * v0x) * inv_denom
    bw = (d00 * v1y - d01 * v0y) * inv_denom
    cw = -(ax * aw + ay * bw)
    z10, z20 = zlin[:, 1] - zlin[:, 0], zlin[:, 2] - zlin[:, 0]
    az = av * z10 + aw * z20
    bz = bv * z10 + bw * z20
    cz = zlin[:, 0] + cv * z10 + cw * z20
    aff = torch.stack([av, bv, cv, aw, bw, cw, az, bz, cz], dim=-1)

    # Errors.EMPTY_Z / WRONG_MIN_MAX
    box, box_valid = bound_box_batch(torch.stack([sx, sy], dim=-1),
                                     height, width)
    valid = ~culled & ~degenerate & box_valid

    return {
        "sx": sx, "sy": sy, "szlin": zlin, "inv_w": inv_w, "aff": aff,
        "clip": clip, "bbox": box, "denom": denom, "valid": valid,
        "world": packed[..., 10:13], "culled": culled,
        "degenerate": degenerate, "box_valid": box_valid,
    }
