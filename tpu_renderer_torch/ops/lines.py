"""Line drawing on the host: the DDA stepper and z-tested anti-aliased splats.

Counterpart of ``tpu_renderer/ops/lines.py`` (reference ``obj/line.py``),
in numpy: ``bresenham_line`` is, as there, a uniform-step DDA that draws
right to left (line.py:6-16); ``draw_line`` clips against the inverse
viewport in clip space, z-tests and splats a ±1 pixel half blend
(line.py:19-50). The debug overlay (ops/overlay.py) draws with them on the
host frame after the device render; the render path never does.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bresenham_line", "draw_line", "splat_line_aa"]


def bresenham_line(start_point, end_point):
    """Uniform-step DDA along the major axis (reference line.py:6-16).
    Lines with increasing x are drawn from their far endpoint."""
    start_point = np.asarray(start_point, dtype=np.float64)
    end_point = np.asarray(end_point, dtype=np.float64)
    delta = end_point - start_point
    if delta[0] > 0:
        return bresenham_line(end_point, start_point)
    steps = np.max(np.abs(delta[:2]))
    if steps == 0:
        return start_point[None]
    step_size = delta / steps
    return start_point + np.arange(int(steps))[:, None] * step_size


def splat_line_aa(frame, z_buffer, x, y, z, color, sign):
    """Z-tested pixel write and ±1 px half-blend anti-aliasing
    (frustums.py:84-103). x: row indices, y: column indices (the
    reference's names), z: depths; writes in place."""
    h, w = z_buffer.shape
    idx = ((z_buffer[x, y] - z) * sign >= 0)
    x, y, z = x[idx], y[idx], z[idx]
    z_buffer[x, y] = z
    frame[x, y] = color
    for i in (-1, 1):
        xs = np.clip(x + i, 0, h - 1)
        ys = np.clip(y + i, 0, w - 1)
        z_buffer[xs, y] = z
        z_buffer[x, ys] = z
        frame[xs, y] = frame[xs, y] * 0.5 + np.asarray(color) / 2
        frame[x, ys] = frame[x, ys] * 0.5 + np.asarray(color) / 2
    return frame, z_buffer


def draw_line(start, end, camera_matrices, resolution, z_buffer, frame,
              color=(1.0, 0.0, 0.0)):
    """Screen-space line with the inverse-viewport clip test (line.py:
    19-50). camera_matrices: a dict with 'viewport' (numpy); the frame is in
    the pre-flip orientation, like the reference's."""
    viewport = np.asarray(camera_matrices["viewport"], np.float64)
    inv_viewport = np.linalg.inv(viewport)
    pxls = bresenham_line(np.asarray(start), np.asarray(end))
    homog = pxls.copy()
    homog[:, 3] = 1
    pxls_ndc = homog @ inv_viewport
    pxls_clip = pxls_ndc / pxls[:, [3]]
    w = pxls_clip[:, 3]
    inside = ((-w < pxls_clip[:, 0]) & (pxls_clip[:, 0] < w) &
              (-w < pxls_clip[:, 1]) & (pxls_clip[:, 1] < w) &
              (-w < pxls_clip[:, 2]) & (pxls_clip[:, 2] < w))
    if not inside.any():
        return
    y, x, z, _ = pxls[inside].T
    x = x.astype(np.int32)
    y = y.astype(np.int32)
    keep = z_buffer[x, y] > z
    x, y, z = x[keep], y[keep], z[keep]
    z_buffer[x, y] = z
    frame[x, y] = color
    h, w_res = resolution
    for i in (-1, 1):
        xs = np.clip(x + i, 0, h - 1)
        ys = np.clip(y + i, 0, w_res - 1)
        z_buffer[xs, y] = z
        z_buffer[x, ys] = z
        frame[xs, y] = frame[xs, y] * 0.5 + np.array([0.5, 0, 0])
        frame[x, ys] = frame[x, ys] * 0.5 + np.array([0.5, 0, 0])
