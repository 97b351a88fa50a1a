"""The debug camera's frustum overlay: its geometry on the host, its pixels
on the frame's device.

Counterpart of ``tpu_renderer/ops/overlay.py`` (reference
``obj/frustums.py``), which draws on the host frame after the device render,
as the reference does (core.py:638).

The frustum is the NDC cube carried to the world by inv(MVP) of the debug
camera, each face clipped against the main camera's frustum, drawn as red
lines with the ±1 pixel half blend; while the main camera is outside the
debug frustum, back faces are dashed (the reference's ``arange // 13 & 1``,
frustums.py:78-82).

The drawing has two halves. ``frustum_segments`` computes the geometry in
float64 numpy on the host, a few dozen small products, into a segment
table: per edge, in draw order, the DDA's start point and step as
``bresenham_line`` computes them, its number of points and whether it is
dashed. ``draw_segments`` applies the table to a float64 frame and
z-buffer with numpy's fancy-index writes; it is the plain version of K11
(``csrc/overlay.cu``, ``raster_cuda.overlay``), which applies the same
table on the card, where ``Scene.render`` keeps the frame.
``draw_view_frustum`` is the two halves on numpy arrays.

``draw_axis`` draws the world axes with text labels (reference axes.py);
it imports Pillow when called, so the rest of the module needs no image
library. ``draw_wireframe`` and ``draw_points`` are the host-loop forms of
the wireframe and points shaders (reference triangular.py:269-283), the
oracle of the device path (``Scene._render_debug_shader_host``).
"""
from __future__ import annotations

import numpy as np

from tpu_renderer_torch.ops.frustum import clipping
from tpu_renderer_torch.ops.lines import bresenham_line
from tpu_renderer_torch.utils.profiling import span

__all__ = ["Frustum", "frustum_segments", "draw_segments",
           "draw_view_frustum", "draw_axis", "draw_wireframe", "draw_points",
           "SEG_COLS", "MAX_SEGMENTS", "DASH"]

#: The font of the axis labels, as the reference's axes.py names it; a
#: host without it draws with Pillow's default font.
AXIS_FONT = "/usr/share/fonts/truetype/freefont/FreeSans.ttf"


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


#: Columns of a segment table row (:func:`frustum_segments`): the DDA's
#: first point (p0, p1, z) and its step (d0, d1, dz), both float64, the
#: number of points and 1.0 where the edge is dashed.
SEG_COLS = 8
#: Rows a table can hold: 6 faces, each clipped by 6 planes into a polygon
#: of at most 4 + 6 vertices, so of at most 10 edges.
MAX_SEGMENTS = 60
#: Points of a dash: a dashed edge keeps the odd runs of DASH points.
DASH = 13


def _segment(a, b, dashed):
    """The table row of the edge from ``a`` to ``b``, or None when it
    draws no point. The start and step are ``bresenham_line``'s: a line
    with increasing p0 runs from ``b``; a zero-length one is its start
    point alone, stored with a step of -0.0, which adds nothing to any
    value (so start + 0 * step is the start, bit for bit)."""
    start = np.asarray(a, dtype=np.float64)
    end = np.asarray(b, dtype=np.float64)
    delta = end - start
    if delta[0] > 0:
        start, end = end, start
        delta = end - start
    steps = np.max(np.abs(delta[:2]))
    if steps == 0:
        n, step = 1, np.full(3, -0.0)
    else:
        n, step = int(steps), (delta / steps)[:3]
    if _kept_range(n, dashed) is None:
        return None
    return np.concatenate([start[:3], step, [n, float(dashed)]])


def _kept_range(n, dashed):
    """(first, last) point of an edge of ``n`` points that dashing keeps,
    or None when it keeps none."""
    if not dashed:
        return (0, n - 1) if n else None
    if n <= DASH:
        return None
    q = (n - 1) // DASH
    return DASH, (n - 1 if q & 1 else q * DASH - 1)


def _points(row, ks):
    """Points ``ks`` of a table row, (len(ks), 3): start + k * step, as
    ``bresenham_line`` forms them."""
    return row[:3] + np.asarray(ks)[:, None] * row[3:6]


def _check_indices(table, shape):
    """Raise IndexError, as numpy's writes would, where a kept point of a
    row indexes outside the (H, W) frame: the points move monotonically
    along a row, so its first and last kept points bound them."""
    ends = np.array([_kept_range(int(n), bool(d))
                     for n, d in table[:, 6:8]]).reshape(-1, 2)
    for k in ends.T:
        p = table[:, :3] + k[:, None] * table[:, 3:6]
        for axis, size in ((1, shape[0]), (0, shape[1])):
            v = p[:, axis]
            with np.errstate(invalid="ignore"):
                ok = np.isfinite(v) & (np.trunc(v) - 1 >= -size) & (
                    np.trunc(v) - 1 < size)
            if not ok.all():
                raise IndexError(f"frustum overlay: a point {v[~ok][0]} "
                                 f"indexes outside {size} pixels")


def frustum_segments(camera_m, debug_m, camera_position, near, far,
                     resolution):
    """The debug camera's frustum as a segment table (reference
    frustums.py:46-83): (S, SEG_COLS) float64, one row per edge that keeps
    at least one point after dashing, in draw order; S <= MAX_SEGMENTS.

    camera_m / debug_m: the host matrix dicts of camera_matrices(host=True,
    dtype=torch.float64) (MVP, viewport, frustum_planes). Raises
    IndexError where an edge's point lies outside the ``resolution``
    (H, W) frame, as drawing it would.

    Runs under ``tr.overlay_segments``, each face's clipping under
    ``tr.overlay_clip`` (utils/profiling.py).
    """
    with span("overlay_segments"):
        dbg_mvp = np.asarray(debug_m["MVP"], np.float64)
        world = Frustum.vertices @ np.linalg.inv(dbg_mvp)
        world = world / world[:, [3]]
        planes = np.asarray(camera_m["frustum_planes"], np.float64)

        test = np.append(np.asarray(camera_position, np.float64), 1) @ dbg_mvp
        inside_frustum = (-test[3] < test[0] < test[3] and
                          -test[3] < test[1] < test[3] and
                          -test[3] < test[2] < test[3])

        mvp = np.asarray(camera_m["MVP"], np.float64)
        viewport = np.asarray(camera_m["viewport"], np.float64)
        rows = []
        for face in world[Frustum.faces]:
            with span("overlay_clip"):
                face = clipping(face, planes)
            if face.shape[0] < 3:
                continue
            face = np.asarray(face, np.float64) @ mvp
            face = face / face[:, [3]]
            face = face @ viewport

            a, b, c = face[0, :3], face[1, :3], face[2, :3]
            n = np.cross(b - a, c - a)
            # Dashed back-face edges: odd chunks of 13 pixels.
            dashed = bool(n[2] > 0 and not inside_frustum)

            face[:, 2] = _linearize(face[:, 2], near, far)
            count = len(face)
            for i in range(count):
                row = _segment(face[i], face[(i + 1) % count], dashed)
                if row is not None:
                    rows.append(row)
        table = np.array(rows, np.float64).reshape(-1, SEG_COLS)
        _check_indices(table, resolution)
        return table


def draw_segments(table, frame, z_buffer, sign):
    """Apply a segment table (:func:`frustum_segments`) to ``frame`` (H,
    W, 3) and ``z_buffer`` (H, W), float64 numpy, in place (reference
    frustums.py:84-103): per row, its points (the kept ones of a dashed
    row) at row p1 - 1, column p0 - 1 (truncated; -1 is the last row or
    column, as numpy indexes), the depth test ``(z_buffer - z) * sign >=
    0`` over the whole row, then the red write and the ±1 pixel half
    blend, clipped at the frame's edge. Returns the line pixels that
    passed the test (each written with its four half-blended neighbours,
    which are not counted). The plain version of K11."""
    h, w_res = z_buffer.shape
    color = np.array((1.0, 0.0, 0.0))
    pixels = 0
    for row in np.asarray(table, np.float64):
        pxls = _points(row, np.arange(int(row[6])))
        if row[7]:
            pxls = pxls[(np.arange(len(pxls)) // DASH) & 1 == 1]
        y, x, z = pxls.T
        x = x.astype(np.int32) - 1
        y = y.astype(np.int32) - 1
        keep = ((z_buffer[x, y] - z) * sign >= 0)
        x, y, z = x[keep], y[keep], z[keep]
        pixels += len(x)
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
    return pixels


def draw_view_frustum(frame, camera_m, debug_m, camera_position, near, far,
                      resolution, z_buffer, sign):
    """Wireframe of the debug camera's frustum (reference frustums.py:
    46-103): :func:`frustum_segments`, then :func:`draw_segments`.

    frame: (H, W, 3) float64 frame (pre-flip); z_buffer: (H, W) float64;
    both numpy, modified in place. camera_m / debug_m: the host matrix
    dicts of camera_matrices(host=True, dtype=torch.float64) (MVP,
    viewport, frustum_planes).

    Returns (segments, pixels): the edges drawn with at least one pixel
    left after dashing, and the line pixels that passed the depth test
    and were written (each with its four half-blended neighbours, which
    are not counted).
    """
    table = frustum_segments(camera_m, debug_m, camera_position, near, far,
                             resolution)
    return len(table), draw_segments(table, frame, z_buffer, sign)


def draw_axis(frame, camera_m, z_buffer, sign, font_path=None):
    """World ±X/Y/Z axes with coloured lines and text labels (reference
    axes.py:8-69, off by default there, core.py:639).

    frame: (H, W, 3) in [0, 1]; camera_m: a dict with ``MVP`` and
    ``viewport``; z_buffer: (H, W), modified in place. Returns the frame in
    [0, 1], like the reference, which goes through a Pillow image.
    """
    from PIL import Image, ImageDraw, ImageFont

    mvp = np.asarray(camera_m["MVP"], np.float64)
    viewport = np.asarray(camera_m["viewport"], np.float64)

    def transformer(vert):
        vert = np.asarray(vert, np.float64) @ mvp
        vert = vert / vert[..., [3]]
        return vert @ viewport

    axes = {
        "x": (transformer([[-1, 0, 0, 1], [1, 0, 0, 1]]), (255, 0, 0),
              transformer([1.05, 0, 0, 1]), transformer([-1.2, 0, 0, 1])),
        "y": (transformer([[0, -1, 0, 1], [0, 1, 0, 1]]), (0, 255, 0),
              transformer([0, 1.05, 0, 1]), transformer([0, -1.2, 0, 1])),
        "z": (transformer([[0, 0, -1, 1], [0, 0, 1, 1]]), (0, 0, 255),
              transformer([-0.05, 0, 1.05, 1]),
              transformer([-0.05, 0, -1.2, 1])),
    }

    image = Image.fromarray((frame * 255).astype(np.uint8))
    draw = ImageDraw.Draw(image)
    try:
        font = ImageFont.truetype(font_path or AXIS_FONT, 20)
        font = ImageFont.TransposedFont(font, Image.Transpose.FLIP_TOP_BOTTOM)
    except OSError:
        font = ImageFont.load_default()

    for name, (_, col, pos_label, neg_label) in axes.items():
        draw.text((pos_label[0], pos_label[1]), f"+{name.upper()}",
                  font=font, fill=col)
        draw.text((neg_label[0], neg_label[1]), f"-{name.upper()}",
                  font=font, fill=col)

    out = np.array(image)
    for name, (segment, col, _, _) in axes.items():
        for yy, xx, zz in bresenham_line(segment[0, :3], segment[1, :3]):
            for i in range(3):
                xi = max(0, min(out.shape[0] - 4, int(xx)))
                yi = max(0, min(out.shape[1] - 4, int(yy)))
                if (z_buffer[xi + i, yi + i] - 1 / zz) * sign > 0:
                    out[xi + i, yi + i] = col
                    z_buffer[xi + i, yi + i] = zz
    return out / 255


def draw_wireframe(frame, z_buffer, screen_faces,
                   color=(64 / 255, 64 / 255, 128 / 255)):
    """Wireframe shading (reference triangular.py:269-274): DDA edges whose
    z, linearized by the caller, is tested against the linearized z-buffer
    with a strict ``> 0``. frame and z_buffer are modified in place.

    screen_faces: (F, 3, 3) post-viewport vertex xyz per face. The
    reference writes the colour (64, 64, 128) into its float frame, on a
    255 scale; here it is scaled to [0, 1].
    """
    h, w = z_buffer.shape
    color = np.asarray(color)
    for tri in screen_faces:
        for i in range(3):
            p1, p2 = tri[i], tri[(i + 1) % 3]
            for yy, xx, zz in bresenham_line(p1, p2):
                xi, yi = int(xx), int(yy)
                if 0 < xi < h - 1 and 0 < yi < w - 1 and \
                        (z_buffer[xi, yi] - zz) > 0:
                    frame[xi, yi] = color
                    z_buffer[xi, yi] = zz
    return frame


def draw_points(frame, screen_faces, camera_position, world_normals):
    """Vertex-point shading (reference triangular.py:277-283): each edge's
    endpoints in red and blue, for the faces whose world normal faces the
    camera direction. frame is modified in place; colours in [0, 1]."""
    h, w = frame.shape[:2]
    cam_dir = -np.asarray(camera_position, np.float64)
    n = np.linalg.norm(cam_dir)
    cam_dir = cam_dir / (n if n else 1.0)
    for tri, normal in zip(screen_faces, world_normals):
        if normal @ cam_dir <= 0:
            continue
        pts = tri.astype(np.int32)
        for i in range(3):
            p1, p2 = pts[i], pts[(i + 1) % 3]
            if 0 <= p1[1] < h and 0 <= p1[0] < w:
                frame[p1[1], p1[0]] = (1.0, 0, 0)
            if 0 <= p2[1] < h and 0 <= p2[0] < w:
                frame[p2[1], p2[0]] = (0, 0, 1.0)
    return frame
