"""Transform-matrix library: the L0 math core, in PyTorch.

Counterpart of ``tpu_renderer/ops/transforms.py``. Every matrix follows the
reference's **row-vector convention** (points are rows; matrices
right-multiply: ``vertices @ M``, reference core.py:350-352), which is why
``translation`` carries its offset in the last row and ``ViewPort`` its
translation in the last row (transformation.py:123-136, 219-227).

Matrices are float32 tensors built on the CPU: they are a handful of scalars
per frame, and building them on the host keeps the per-frame matrices
bit-identical whichever device renders. Callers move them with ``.to(device)``.
The camera builders also take ``dtype=torch.float64``: the host form of the
camera matrices that the debug overlay draws with (models/camera.py).

Parity map (reference transformation.py):
  scale:207  translation:219  rotate_xyz:230  looka_at_translate:77
  look_at_rotate_lh:83  look_at_rotate_rh:92  lookAtLH:52  lookAtRH:101
  ViewPort:123  opengl_orthographicLH:139  opengl_perspectiveLH:157
  opengl_perspectiveRH:168  directx_perspectiveRH:179  directx_perspectiveLH:193
  FPSViewRH:266  perspective_matrix_3point:294  perspective_matrix_2point:314
  perspectives registry:346  barycentric:12  bound_box:35  normalize:46

``FPSViewRH`` and the two- and three-point perspectives are functions the
reference exports but never calls; they are kept as API surface for its
users and return float32 numpy matrices, built on the host like the JAX
package's.
"""
from __future__ import annotations

from fractions import Fraction

import numpy as np
import torch

from tpu_renderer_torch.constants import PROJECTION_TYPE, SUBSYSTEM, SYSTEM

__all__ = [
    "matmul", "normalize", "barycentric", "barycentric_batch", "bound_box",
    "bound_box_batch", "scale", "translation", "rotate_xyz", "rotate",
    "looka_at_translate", "look_at_translate", "look_at_rotate_lh",
    "look_at_rotate_rh", "lookAtLH", "lookAtRH", "FPSViewRH", "ViewPort",
    "opengl_orthographicLH", "opengl_perspectiveLH", "opengl_perspectiveRH",
    "directx_perspectiveLH", "directx_perspectiveRH",
    "perspective_matrix_2point", "perspective_matrix_3point",
    "perspectives", "SYSTEM", "SUBSYSTEM",
]

_F32 = torch.float32


def _t(x, device=None, dtype=_F32):
    """Scalar / array / tensor -> ``dtype`` tensor (CPU unless ``device``)."""
    if isinstance(x, torch.Tensor):
        return x.to(dtype=dtype, device=device or x.device)
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)


def matmul(a, b):
    """float32 matrix product at full precision.

    The package sets ``torch.backends.cuda.matmul.allow_tf32 = False`` and
    ``torch.set_float32_matmul_precision("highest")`` on import (see
    ``tpu_renderer_torch/__init__.py``), the counterpart of the JAX package's
    ``precision="highest"`` rule: rasterization coverage is sign-sensitive.
    """
    return torch.matmul(_t(a), _t(b))


def normalize(a, axis=-1, order=2):
    """Safe L2 (or Lp) normalization (reference transformation.py:46-49).

    Zero-norm rows are passed through unchanged (norm treated as 1).
    """
    a = _t(a)
    l2 = torch.linalg.vector_norm(a, ord=order, dim=axis, keepdim=True)
    l2 = torch.where(l2 == 0, torch.ones_like(l2), l2)
    return a / l2


def barycentric(a, b, c, p):
    """Barycentric coordinates of points ``p`` (N, 2) in the 2D triangle
    (a, b, c), by the reference's dot products in float32
    (transformation.py:12-32). Returns ((N, 3), valid): the reference
    returns None on a degenerate triangle; here ``valid`` (a 0-d bool) is
    False and ``bar`` holds inf/NaN."""
    a, b, c, p = _t(a), _t(b), _t(c), _t(p)
    v0, v1, v2 = b - a, c - a, p - a
    d00 = v0 @ v0
    d01 = v0 @ v1
    d11 = v1 @ v1
    d20 = v2 @ v0
    d21 = v2 @ v1
    denom = d00 * d11 - d01 * d01
    inv_denom = 1.0 / denom
    v = (d11 * d20 - d01 * d21) * inv_denom
    w = (d00 * d21 - d01 * d20) * inv_denom
    return torch.stack([1.0 - v - w, v, w], dim=-1), denom != 0


def barycentric_batch(tri_xy, p):
    """Batched ``barycentric``: triangles ``tri_xy`` (..., 3, 2), pixels
    ``p`` (N, 2). Returns (bar (..., N, 3), valid (...,))."""
    tri_xy, p = _t(tri_xy), _t(p)
    a, b, c = tri_xy[..., 0, :], tri_xy[..., 1, :], tri_xy[..., 2, :]
    v0, v1 = b - a, c - a                          # (..., 2)
    v2 = p - a[..., None, :]                       # (..., N, 2)
    d00 = (v0 * v0).sum(-1)
    d01 = (v0 * v1).sum(-1)
    d11 = (v1 * v1).sum(-1)
    d20 = (v2 * v0[..., None, :]).sum(-1)          # (..., N)
    d21 = (v2 * v1[..., None, :]).sum(-1)
    denom = d00 * d11 - d01 * d01
    inv_denom = 1.0 / denom
    v = (d11[..., None] * d20 - d01[..., None] * d21) * inv_denom[..., None]
    w = (d00[..., None] * d21 - d01[..., None] * d20) * inv_denom[..., None]
    return torch.stack([1.0 - v - w, v, w], dim=-1), denom != 0


def bound_box(vert_xy, height, width):
    """Screen-clamped bounding box of the points ``vert_xy`` (K, 2)
    (reference transformation.py:35-43). Returns (box, valid): box =
    ceil([min_x, max_x, min_y, max_y]) as int32, x clamped to [0, width]
    and y to [0, height]; valid is False where the clamped box is empty
    (the reference returns None there, triangular.py:69-70)."""
    vert_xy = _t(vert_xy)
    min_x = torch.clamp(vert_xy[..., 0].min(), min=0)
    max_x = torch.clamp(vert_xy[..., 0].max(), max=width)
    min_y = torch.clamp(vert_xy[..., 1].min(), min=0)
    max_y = torch.clamp(vert_xy[..., 1].max(), max=height)
    valid = ~((min_x > max_x) | (min_y > max_y))
    box = torch.ceil(torch.stack([min_x, max_x, min_y, max_y]))
    return box.to(torch.int32), valid


def bound_box_batch(tri_xy, height, width):
    """Batched ``bound_box``: ``tri_xy`` (F, K, 2) -> ((F, 4) int32, (F,) bool)."""
    min_x = torch.clamp(tri_xy[..., 0].amin(-1), min=0)
    max_x = torch.clamp(tri_xy[..., 0].amax(-1), max=width)
    min_y = torch.clamp(tri_xy[..., 1].amin(-1), min=0)
    max_y = torch.clamp(tri_xy[..., 1].amax(-1), max=height)
    valid = ~((min_x > max_x) | (min_y > max_y))
    box = torch.ceil(torch.stack([min_x, max_x, min_y, max_y], -1))
    return box.to(torch.int32), valid


# --------------------------------------------------------------------------
# Model transforms (row-vector convention)
# --------------------------------------------------------------------------

def _mat(rows):
    """4x4 float32 matrix from nested rows of float32 0-d tensors."""
    return torch.stack([torch.stack([_t(x) for x in r]) for r in rows])


def scale(factor):
    """Uniform scale matrix (reference transformation.py:207-216)."""
    f = _t(factor)
    m = torch.eye(4, dtype=_F32)
    m[0, 0] = f
    m[1, 1] = f
    m[2, 2] = f
    return m


def translation(vec):
    """Translation matrix, transposed for row vectors (transformation.py:219-227)."""
    m = torch.eye(4, dtype=_F32)
    m[3, :3] = _t(vec)
    return m


def rotate_xyz(a):
    """Euler rotation from degrees ``(x, y, z)`` (transformation.py:230-263).

    Replicates the reference's angle wiring, where the matrix labelled
    ``rotate_x`` uses the *y* angle and ``rotate_y`` the *x* angle.
    """
    a = torch.deg2rad(_t(a))
    x, y, z = a[0], a[1], a[2]
    one, zero = torch.ones((), dtype=_F32), torch.zeros((), dtype=_F32)
    rot_x = _mat([[one, zero, zero, zero],
                  [zero, torch.cos(y), -torch.sin(y), zero],
                  [zero, torch.sin(y), torch.cos(y), zero],
                  [zero, zero, zero, one]]).T
    rot_y = _mat([[torch.cos(x), zero, torch.sin(x), zero],
                  [zero, one, zero, zero],
                  [-torch.sin(x), zero, torch.cos(x), zero],
                  [zero, zero, zero, one]]).T
    rot_z = _mat([[torch.cos(z), torch.sin(z), zero, zero],
                  [-torch.sin(z), torch.cos(z), zero, zero],
                  [zero, zero, one, zero],
                  [zero, zero, zero, one]]).T
    return matmul(matmul(rot_z, rot_y), rot_x)


#: The reference README documents ``rotate`` but ships only ``rotate_xyz``.
rotate = rotate_xyz


# --------------------------------------------------------------------------
# Look-at family
# --------------------------------------------------------------------------

def looka_at_translate(eye, dtype=_F32):
    """Look-at translation part (reference transformation.py:77-80)."""
    m = torch.eye(4, dtype=dtype)
    m[3, :3] = -_t(eye, dtype=dtype)
    return m


look_at_translate = looka_at_translate


def _cross3(a, b):
    return torch.stack([a[1] * b[2] - a[2] * b[1],
                        a[2] * b[0] - a[0] * b[2],
                        a[0] * b[1] - a[1] * b[0]])


def _fma(a, b, c):
    """a*b + c of three Python floats, rounded once: exact rational
    arithmetic, then the one correctly rounded conversion to a float."""
    return float(Fraction(a) * Fraction(b) + Fraction(c))


def _unit_f64(v):
    """v / |v| of a 3-vector of Python floats (zero stays zero), with
    |v| = sqrt(fma(z, z, fma(y, y, x*x)))."""
    x, y, z = v
    n = float(np.sqrt(_fma(z, z, _fma(y, y, x * x))))
    n = n if n != 0 else 1.0
    return [x / n, y / n, z / n]


def _cross_f64(a, b):
    """a × b of 3-vectors of Python floats, each component
    fma(a_i, b_j, -(a_j * b_i))."""
    return [_fma(a[i], b[j], -(a[j] * b[i]))
            for i, j in ((1, 2), (2, 0), (0, 1))]


def _look_at_axes_f64(eye, center, up):
    """The float64 look-at axes (right, new_up, forward) as the JAX
    package's x64 host matrices compute them. That package builds them
    through XLA's CPU backend, which contracts the norm's sum of squares
    and the cross products' a*b - c*d into fused multiply-adds (measured:
    rounded op by op, the norm differs by an ulp on about one vector in
    twenty, the cross product on more than half); these are the contracted
    forms, so the overlay's matrices equal that package's bit for bit."""
    f64 = lambda a: [float(c) for c in _t(a, dtype=torch.float64)]
    eye, center, up = f64(eye), f64(center), f64(up)
    forward = _unit_f64([c - e for c, e in zip(center, eye)])
    right = _unit_f64(_cross_f64(up, forward))
    return right, _cross_f64(forward, right), forward


def _look_at_rotate(eye, center, up, forward_sign, dtype):
    if dtype == torch.float64:
        right, new_up, forward = (torch.tensor(a, dtype=dtype) for a in
                                  _look_at_axes_f64(eye, center, up))
    else:
        forward = normalize(_t(center) - _t(eye)).reshape(-1)
        right = normalize(_cross3(_t(up), forward)).reshape(-1)
        new_up = _cross3(forward, right)
    rot = torch.eye(4, dtype=dtype)
    rot[:3, :3] = torch.stack((right, new_up, forward_sign * forward), dim=1)
    return rot


def look_at_rotate_lh(eye, center, up, dtype=_F32):
    """LH look-at rotation part (reference transformation.py:83-89)."""
    return _look_at_rotate(eye, center, up, -1.0, dtype)


def look_at_rotate_rh(eye, center, up, dtype=_F32):
    """RH look-at rotation part (reference transformation.py:92-98)."""
    return _look_at_rotate(eye, center, up, 1.0, dtype)


def lookAtLH(eye, center, up=(0, 1, 0)):
    """Monolithic LH view matrix (reference transformation.py:52-74)."""
    eye = _t(eye)
    m = look_at_rotate_lh(eye, center, up)
    m[3, :3] = matmul(-eye, m[:3, :3])
    return m


def lookAtRH(eye, center, up=(0, 1, 0)):
    """Monolithic RH view matrix (reference transformation.py:101-120);
    replicates the reference's ``eye @ rot`` translation (no negation)."""
    eye = _t(eye)
    m = look_at_rotate_rh(eye, center, up)
    m[3, :3] = matmul(eye, m[:3, :3])
    return m


def FPSViewRH(eye, pitch, yaw):
    """First-person RH view matrix (reference transformation.py:266-291),
    float32 numpy; pitch in [-90, 90] and yaw in [0, 360) degrees."""
    f32 = np.float32
    eye = np.asarray(eye, f32)
    pitch = np.deg2rad(f32(pitch))
    yaw = np.deg2rad(f32(yaw))
    cp, sp = np.cos(pitch), np.sin(pitch)
    cy, sy = np.cos(yaw), np.sin(yaw)
    xaxis = np.array([cy, 0, -sy], f32)
    yaxis = np.array([sy * sp, cp, cy * sp], f32)
    zaxis = np.array([sy * cp, -sp, cp * cy], f32)
    m = np.eye(4, dtype=f32)
    m[:3, :3] = np.stack([xaxis, yaxis, zaxis], axis=1)
    m[3, :3] = [-(xaxis @ eye), -(yaxis @ eye), -(zaxis @ eye)]
    return m


def _persp_d(d, aspect_ratio, fov_y):
    """The projection both multi-point perspectives start from."""
    f32 = np.float32
    f = f32(1.0) / np.tan(f32(fov_y) / f32(2.0))
    d0, d1 = f32(d[0]), f32(d[1])
    return np.array([[f / f32(aspect_ratio), 0, 0, 0],
                     [0, f, 0, 0],
                     [0, 0, (d1 + d0) / (d1 - d0),
                      f32(-2) * d0 * d1 / (d1 - d0)],
                     [0, 0, 1, 0]], f32)


def perspective_matrix_3point(d, aspect_ratio, fov_y, angles):
    """Three-point perspective (reference transformation.py:294-311),
    float32 numpy: the projection conjugated by a rotation about z."""
    a0 = np.float32(angles[0])
    c, s = np.cos(a0), np.sin(a0)
    rot = np.array([[c, -s, 0, 0], [s, c, 0, 0], [0, 0, 1, 0], [0, 0, 0, 1]],
                   np.float32)
    return rot @ _persp_d(d, aspect_ratio, fov_y) @ np.linalg.inv(rot)


def perspective_matrix_2point(d, aspect_ratio, fov_y, eye_sep):
    """Two-point perspective (reference transformation.py:314-331), float32
    numpy: the projection after a horizontal shift of -eye_sep / 2."""
    trans = np.eye(4, dtype=np.float32)
    trans[0, 2] = -np.float32(eye_sep) / np.float32(2)
    return trans @ _persp_d(d, aspect_ratio, fov_y)


# --------------------------------------------------------------------------
# Viewport & projections
# --------------------------------------------------------------------------

def ViewPort(resolution, far, near, x_offset=0, y_offset=0, dtype=_F32):
    """NDC -> screen matrix, translation in last row (transformation.py:123-136).

    ``resolution`` is (height, width) like the reference.
    """
    height, width = resolution
    t = lambda x: _t(x, dtype=dtype)
    hw, hh = t(width) / 2, t(height) / 2
    hd = (t(far) - t(near)) / 2
    m = torch.zeros((4, 4), dtype=dtype)
    m[0, 0] = hw
    m[1, 1] = hh
    m[2, 2] = hd
    m[3, 0] = hw + x_offset
    m[3, 1] = hh + y_offset
    m[3, 2] = hd
    m[3, 3] = 1.0
    return m


def opengl_orthographicLH(fov, aspect_ratio, z_near, z_far, dtype=_F32):
    """OpenGL LH orthographic projection (transformation.py:139-154)."""
    z_near, z_far = _t(z_near, dtype=dtype), _t(z_far, dtype=dtype)
    half_height = torch.tan(torch.deg2rad(_t(fov, dtype=dtype) / 2.0)) * z_near
    half_width = half_height * aspect_ratio
    m = torch.zeros((4, 4), dtype=dtype)
    m[0, 0] = 1.0 / half_width
    m[1, 1] = 1.0 / half_height
    m[2, 2] = -2.0 / (z_far - z_near)
    m[3, 2] = (z_far + z_near) / (z_far - z_near)
    m[3, 3] = 1.0
    return m


def _perspective(fovy, aspect, m22, m32, m23, dtype):
    f = 1.0 / torch.tan(torch.deg2rad(_t(fovy, dtype=dtype)) / 2.0)
    m = torch.zeros((4, 4), dtype=dtype)
    m[0, 0] = f / aspect
    m[1, 1] = f
    m[2, 2] = _t(m22, dtype=dtype)
    m[2, 3] = _t(m23, dtype=dtype)
    m[3, 2] = _t(m32, dtype=dtype)
    return m


def opengl_perspectiveLH(fovy, aspect, z_near, z_far, dtype=_F32):
    """OpenGL LH perspective (transformation.py:157-165)."""
    n, f = _t(z_near, dtype=dtype), _t(z_far, dtype=dtype)
    return _perspective(fovy, aspect, -(f + n) / (f - n),
                        2.0 * f * n / (f - n), 1.0, dtype)


def opengl_perspectiveRH(fovy, aspect, z_near, z_far, dtype=_F32):
    """OpenGL RH perspective (transformation.py:168-176)."""
    n, f = _t(z_near, dtype=dtype), _t(z_far, dtype=dtype)
    return _perspective(fovy, aspect, -(f + n) / (f - n),
                        -2.0 * f * n / (f - n), -1.0, dtype)


def directx_perspectiveRH(fovy, aspect, z_near, z_far, dtype=_F32):
    """DirectX RH perspective (transformation.py:179-190)."""
    n, f = _t(z_near, dtype=dtype), _t(z_far, dtype=dtype)
    return _perspective(fovy, aspect, f / (n - f), n * f / (n - f), -1.0,
                        dtype)


def directx_perspectiveLH(fovy, aspect, z_near, z_far, dtype=_F32):
    """DirectX LH perspective (transformation.py:193-204)."""
    n, f = _t(z_near, dtype=dtype), _t(z_far, dtype=dtype)
    return _perspective(fovy, aspect, -f / (f - n), n * f / (f - n), 1.0,
                        dtype)


#: Projection registry keyed by (SUBSYSTEM, PROJECTION_TYPE, SYSTEM), the same
#: shape (missing combinations raise KeyError) as the reference's
#: ``perspectives`` dict (transformation.py:346-361).
perspectives = {
    SUBSYSTEM.DIRECTX: {
        PROJECTION_TYPE.PERSPECTIVE: {
            SYSTEM.LH: directx_perspectiveLH,
            SYSTEM.RH: directx_perspectiveRH,
        },
        PROJECTION_TYPE.ORTHOGRAPHIC: {},
    },
    SUBSYSTEM.OPENGL: {
        PROJECTION_TYPE.PERSPECTIVE: {
            SYSTEM.LH: opengl_perspectiveLH,
            SYSTEM.RH: opengl_perspectiveRH,
        },
        PROJECTION_TYPE.ORTHOGRAPHIC: {
            SYSTEM.LH: opengl_orthographicLH,
        },
    },
}
