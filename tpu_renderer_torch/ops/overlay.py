"""The debug camera's frustum overlay, drawn on the host.

Counterpart of ``tpu_renderer/ops/overlay.py`` (reference
``obj/frustums.py``), in numpy: after the device render, ``Scene.render``
brings the pre-flip frame and the z-buffer to the host as float64 and
``draw_view_frustum`` draws the debug camera's frustum on them, as the
reference does on its host frame (core.py:638).

The frustum is the NDC cube carried to the world by inv(MVP) of the debug
camera, each face clipped against the main camera's frustum, drawn as red
lines with the ±1 pixel half blend; while the main camera is outside the
debug frustum, back faces are dashed (the reference's ``arange // 13 & 1``,
frustums.py:78-82). ``draw_axis`` needs Pillow, which the card's host
lacks, and is not ported.
"""
from __future__ import annotations

import numpy as np

from tpu_renderer_torch.ops.frustum import clipping
from tpu_renderer_torch.ops.lines import bresenham_line

__all__ = ["Frustum", "draw_view_frustum"]


class Frustum:
    """NDC cube geometry (reference frustums.py:7-43): the 8 clip-space
    corners; ``faces`` index the 6 quads with consistent winding."""

    vertices = np.array([
        [-1.0, -1.0, 1.0, 1.0],   # 0 near-ish corners (z = +1)
        [1.0, -1.0, 1.0, 1.0],    # 1
        [-1.0, 1.0, 1.0, 1.0],    # 2
        [1.0, 1.0, 1.0, 1.0],     # 3
        [-1.0, 1.0, -1.0, 1.0],   # 4 far-ish corners (z = -1)
        [1.0, 1.0, -1.0, 1.0],    # 5
        [-1.0, -1.0, -1.0, 1.0],  # 6
        [1.0, -1.0, -1.0, 1.0],   # 7
    ])

    edges = np.array([(0, 1), (1, 3), (3, 2), (2, 0), (5, 4), (7, 5), (6, 7),
                      (4, 6), (2, 4), (3, 5), (1, 7), (0, 6)])

    triangles = np.array([(4, 6, 7), (7, 5, 4), (0, 6, 4), (4, 2, 0),
                          (7, 1, 3), (3, 5, 7), (0, 2, 3), (3, 1, 0),
                          (4, 5, 3), (3, 2, 4), (6, 0, 7), (7, 0, 1)])

    faces = np.array([(2, 4, 5, 3), (0, 1, 7, 6), (0, 2, 3, 1),
                      (5, 4, 6, 7), (3, 5, 7, 1), (4, 2, 0, 6)])


def _linearize(z, near, far):
    return (2 * near * far) / (far + near - z * (far - near))


def draw_view_frustum(frame, camera_m, debug_m, camera_position, near, far,
                      resolution, z_buffer, sign):
    """Wireframe of the debug camera's frustum (reference frustums.py:
    46-103).

    frame: (H, W, 3) float64 frame (pre-flip); z_buffer: (H, W) float64;
    both numpy, modified in place. camera_m / debug_m: the host matrix
    dicts of camera_matrices(host=True, dtype=torch.float64) (MVP,
    viewport, frustum_planes).
    """
    dbg_mvp = np.asarray(debug_m["MVP"], np.float64)
    world = Frustum.vertices @ np.linalg.inv(dbg_mvp)
    world = world / world[:, [3]]
    planes = np.asarray(camera_m["frustum_planes"], np.float64)
    color = np.array((1.0, 0.0, 0.0))

    test = np.append(np.asarray(camera_position, np.float64), 1) @ dbg_mvp
    inside_frustum = (-test[3] < test[0] < test[3] and
                      -test[3] < test[1] < test[3] and
                      -test[3] < test[2] < test[3])

    mvp = np.asarray(camera_m["MVP"], np.float64)
    viewport = np.asarray(camera_m["viewport"], np.float64)
    h, w_res = resolution

    for face in world[Frustum.faces]:
        face = clipping(face, planes)
        if face.shape[0] < 3:
            continue
        face = np.asarray(face, np.float64) @ mvp
        face = face / face[:, [3]]
        face = face @ viewport

        a, b, c = face[0, :3], face[1, :3], face[2, :3]
        n = np.cross(b - a, c - a)

        face[:, 2] = _linearize(face[:, 2], near, far)
        count = len(face)
        for i in range(count):
            pxls = bresenham_line(face[i], face[(i + 1) % count])
            if n[2] > 0 and not inside_frustum:
                # Dashed back-face edges: odd chunks of 13 pixels.
                mask = np.bitwise_and(np.arange(len(pxls)) // 13, 1,
                                      dtype=np.int8).view(np.bool_)
                pxls = pxls[mask]
            if not len(pxls):
                continue
            y, x, z, _ = pxls.T
            x = x.astype(np.int32) - 1
            y = y.astype(np.int32) - 1
            keep = ((z_buffer[x, y] - z) * sign >= 0)
            x, y, z = x[keep], y[keep], z[keep]
            z_buffer[x, y] = z
            frame[x, y] = color
            clip_x, clip_y = h - 1, w_res - 1
            for off in (-1, 1):
                xs = np.clip(x + off, 0, clip_x)
                ys = np.clip(y + off, 0, clip_y)
                z_buffer[xs, y] = z
                z_buffer[x, ys] = z
                frame[xs, y] = frame[xs, y] * 0.5 + color / 2
                frame[x, ys] = frame[x, ys] * 0.5 + color / 2
