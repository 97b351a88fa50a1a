"""Frustum-plane math and polygon clipping, in PyTorch.

Counterpart of ``tpu_renderer/ops/frustum.py``: Gribb–Hartmann plane
extraction from an MVP matrix (row-vector convention, so planes come from
matrix *columns*) and Sutherland–Hodgman polygon clipping over fixed-size
padded vertex buffers, batched over any leading dimensions so every shadow
quad of a frame clips in one tensor computation.

Each plane pass emits, per input edge, up to two candidate vertices (the
current vertex if visible; the edge/plane intersection on a visibility
change) and compacts them in order with a prefix-sum scatter — the same
output order as the reference's sequential appends
(plane_intersection.py:59-86).

The debug overlay clips on the host in float64 numpy:
``extract_frustum_planes_host`` and ``clipping``.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["normalize_plane", "extract_frustum_planes",
           "extract_frustum_planes_host", "line_plane_intersection",
           "is_visible", "clipping", "clip_polygon", "get_parameterized",
           "LEFT", "RIGHT", "BOTTOM", "TOP", "NEAR", "FAR", "P_MAX"]

# Plane indices (reference plane_intersection.py:10-15).
LEFT, RIGHT, BOTTOM, TOP, NEAR, FAR = range(6)

#: Vertex capacity of one padded clipped polygon in the JAX package: a
#: convex quad clipped by six planes has at most 4 + 6 = 10 vertices.
#: ``clip_polygon`` takes any capacity; the shadow quads use
#: ``shadow.QUAD_PMAX``.
P_MAX = 16


def _dot4(a, p):
    """Row-wise 4-component dot product in a fixed left-to-right order."""
    return ((a[..., 0] * p[0] + a[..., 1] * p[1]) + a[..., 2] * p[2]) \
        + a[..., 3] * p[3]


def normalize_plane(plane):
    """Plane coefficients scaled to unit norm (plane_intersection.py:
    17-21)."""
    plane = torch.as_tensor(plane)
    return plane / torch.linalg.vector_norm(plane)


def extract_frustum_planes(matrix):
    """Frustum planes [left, right, bottom, top, near, far] from a row-vector
    MVP (reference plane_intersection.py:43-56): with the row-vector
    convention, plane k combines the matrix's *columns*."""
    m = torch.as_tensor(matrix)
    col = lambda i: m[..., i]
    planes = torch.stack([
        col(3) + col(0),   # left
        col(3) - col(0),   # right
        col(3) + col(1),   # bottom
        col(3) - col(1),   # top
        col(3) + col(2),   # near
        col(3) - col(2),   # far
    ])
    return planes / torch.linalg.vector_norm(planes, dim=-1, keepdim=True)


def extract_frustum_planes_host(matrix):
    """Numpy twin of :func:`extract_frustum_planes` for the host overlay
    (tpu_renderer/ops/frustum.py:59): with a float64 MVP composed by numpy,
    the planes equal the reference's (plane_intersection.py:43-56)."""
    m = np.asarray(matrix)
    col = lambda i: m[..., i]
    planes = np.stack([col(3) + col(0), col(3) - col(0), col(3) + col(1),
                       col(3) - col(1), col(3) + col(2), col(3) - col(2)])
    return planes / np.linalg.norm(planes, axis=-1, keepdims=True)


def line_plane_intersection(p1, p2, plane):
    """Intersection of the segment ``p1 -> p2`` with a plane
    (plane_intersection.py:24-36). Returns (point, valid) instead of None:
    ``valid`` is False for a parallel segment (|denominator| < 1e-10) or an
    intersection outside [0, 1]."""
    p1, p2 = torch.as_tensor(p1), torch.as_tensor(p2)
    plane = torch.as_tensor(plane, dtype=p1.dtype)
    direction = p2 - p1
    denom = plane @ direction
    parallel = denom.abs() < 1e-10
    weight = -(plane @ p1) / torch.where(parallel, torch.ones_like(denom),
                                         denom)
    valid = (~parallel) & (weight >= 0) & (weight <= 1)
    return p1 + weight * direction, valid


def is_visible(point, plane):
    """Half-space test (plane_intersection.py:39-40)."""
    point = torch.as_tensor(point)
    return torch.as_tensor(plane, dtype=point.dtype) @ point >= 0


def get_parameterized(planes):
    """Print planes as GeoGebra-pasteable equations
    (plane_intersection.py:89-97)."""
    for plane in np.asarray(planes):
        coords = "xyz "
        eq = " + ".join(f"{coef:.2f}{var}" for coef, var in zip(plane, coords))
        print(eq.replace("+ -", "- ") + "= 0")


def _clip_one_plane(verts, count, plane):
    """One Sutherland–Hodgman pass over padded polygons.

    verts: (..., P, 4) float32; count: (...,) active vertex counts.
    Emits per input edge i < count the current vertex when visible, then the
    edge/plane intersection on a visibility change — the reference's append
    order (plane_intersection.py:69-83).
    """
    n = verts.shape[-2]
    idx = torch.arange(n, device=verts.device)
    active = idx < count[..., None]
    cur = verts
    wrap = (idx + 1 >= count[..., None])[..., None]
    nxt = torch.where(wrap, verts[..., 0:1, :], torch.roll(verts, -1, dims=-2))

    dist_cur = _dot4(cur, plane)
    dist_nxt = _dot4(nxt, plane)
    cur_vis = dist_cur >= 0
    nxt_vis = dist_nxt >= 0

    # Intersection of (nxt -> cur) with the plane, the reference's argument
    # order line_plane_intersection(next_vertex, current_vertex, plane).
    direction = cur - nxt
    denom = _dot4(direction, plane)
    parallel = denom.abs() < 1e-10
    weight = -dist_nxt / torch.where(parallel, torch.ones_like(denom), denom)
    ip = nxt + weight[..., None] * direction
    ip_valid = (~parallel) & (weight >= 0) & (weight <= 1)

    emit_cur = active & cur_vis
    emit_ip = active & (cur_vis ^ nxt_vis) & ip_valid

    # Interleave candidates in reference order: cur_0, ip_0, cur_1, ip_1, ...
    lead = verts.shape[:-2]
    cand = torch.stack([cur, ip], dim=-2).reshape(*lead, 2 * n, 4)
    flags = torch.stack([emit_cur, emit_ip], dim=-1).reshape(*lead, 2 * n)
    pos = torch.cumsum(flags.to(torch.int64), dim=-1) - 1
    out_count = flags.sum(-1)
    # Dropped candidates scatter into a dump slot past the end.
    dest = torch.where(flags, pos, torch.full_like(pos, 2 * n))
    out = torch.zeros(*lead, 2 * n + 1, 4, dtype=verts.dtype,
                      device=verts.device)
    out.scatter_(-2, dest[..., None].expand(*lead, 2 * n, 4), cand)
    return out[..., :n, :], out_count


def clip_polygon(verts, count, planes):
    """Clip padded convex polygons by a stack of planes.

    verts: (..., P, 4); count: (...,) ints; planes: (K, 4).
    Returns (clipped verts (..., P, 4) with slots past the count zeroed,
    new counts (...,) int32).
    """
    verts = torch.as_tensor(verts, dtype=torch.float32)
    count = torch.as_tensor(count, device=verts.device).to(torch.int64)
    planes = torch.as_tensor(planes, dtype=torch.float32, device=verts.device)
    for k in range(planes.shape[0]):
        verts, count = _clip_one_plane(verts, count, planes[k])
    keep = (torch.arange(verts.shape[-2], device=verts.device)
            < count[..., None])[..., None]
    verts = torch.where(keep, verts, torch.zeros_like(verts))
    return verts, count.to(torch.int32)


def clipping(polygon_vertices, clipping_planes):
    """Reference-compatible host clipper (plane_intersection.py:59-86;
    tpu_renderer/ops/frustum.py:178): an (N, 4) polygon -> the clipped
    (M, 4) polygon, Sutherland–Hodgman in float64 numpy.

    Visibility is ``plane @ point >= 0``; a crossing edge intersects from
    the *next* towards the *current* vertex (plane_intersection.py:81);
    segments parallel to the plane (|denominator| < 1e-10) or with weight
    outside [0, 1] add no vertex. Float64 matters: the debug overlay's
    frustum corners can lie exactly on the clip planes.
    """
    poly = [np.asarray(v, np.float64) for v in polygon_vertices]
    for plane in np.asarray(clipping_planes, np.float64):
        kept = []
        n = len(poly)
        for i in range(n):
            cur = poly[i]
            nxt = poly[(i + 1) % n]
            cur_in = plane @ cur >= 0
            nxt_in = plane @ nxt >= 0
            if cur_in:
                kept.append(cur)
            if cur_in != nxt_in:
                d = cur - nxt
                denom = plane @ d
                if abs(denom) >= 1e-10:
                    w = -(plane @ nxt) / denom
                    if 0 <= w <= 1:
                        kept.append(nxt + w * d)
        poly = kept
    return np.array(poly)
