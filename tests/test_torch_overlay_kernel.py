"""K11 and K12, the debug camera's frustum overlay and its flip, gamma and
uint8 on the card (``raster_cuda.overlay``, ``overlay_quantize``,
csrc/overlay.cu), without JAX.

This file imports no JAX, so it also runs on the card's host:

    python -m pytest tests/test_torch_overlay_kernel.py -q

On the CPU:

- the segment table (``ops/overlay.frustum_segments``) replayed by the
  plain version (``draw_segments``) draws what the overlay drew before the
  table existed (``frozen_draw_view_frustum``, a copy of it), bit for bit:
  the frame, the z-buffer, the segments and the line pixels, at 150² and
  at 1500² over 8 positions of the benchmark's ``orbit-moving-light-debug``
  orbit, with dashed back faces; a table has at most 60 rows;
- each row's points are ``bresenham_line``'s, bit for bit, on seeded and
  degenerate edges (zero length, under a pixel, either direction);
- a numpy model of K11's design (``k11_model``: the depth test of a row,
  then each target written by the last statement and point that writes
  it, its colour from the statements that hit it) equals the plain version
  on those tables and on crafted ones: a row whose truncated index is -1,
  duplicate targets within one statement, neighbours clipped at the
  frame's edges, a row of one point (``steps == 0``), dashed rows, a
  failing depth test;
- a ``Scene.render()`` with a debug camera equals the numpy path it had
  before the overlay moved to the card (``frozen_render_overlay``): the
  uint8 frame, ``last_zbuf`` (float64) and the overlay counter;
- a still debug camera builds its float64 host matrices once over an
  orbit (``Camera._matrices`` keeps them while its state stays), equal to
  a fresh build bit for bit.

On a CUDA card (marker ``cuda``, skipped elsewhere): K11 and K12 equal the
plain versions with max abs err 0 (the frame, the z-buffer, the pixel
count and the uint8 frame) on the same tables and on K11's outputs; K12 on
special values and on chains of up to eight half blends; neither waits for the device; ``Scene.render()`` at 1500²
with a debug camera over the 8 positions equals the numpy path on the
frame's float outputs, launches each kernel once, reads back only the
uint8 frame and counts what the numpy path counts.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.models import gizmos as gz
from tpu_renderer_torch.ops import overlay as ov
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops.frustum import clipping
from tpu_renderer_torch.ops.lines import bresenham_line
from tpu_renderer_torch.utils import profiling

from test_torch_kernels import one_torch_thread, textures  # noqa: F401

#: The main camera of obj/main.py (examples/demo.py:50-55) and camera2, the
#: debug camera (main.py:84-92), as the ``reference-main`` configuration.
MAIN_CAM = dict(center=(0, 0, 0), fovy=90, near=0.0001, far=400,
                backface_culling=False)
CAMERA2 = dict(position=(0, 3, 0.01), center=(0, 0, 0), fovy=80, near=1,
               far=3, backface_culling=True)
#: 8 positions of ``orbit-moving-light-debug``'s camera: radius 5.05 about
#: (0.5, 3, 0).
POSITIONS = [(0.5 + 5.05 * np.sin(t), 3.0, 5.05 * np.cos(t))
             for t in 2 * np.pi * (np.arange(8) + 0.3) / 8]
SIZES = [(150, 150), (1500, 1500)]


def frozen_draw_view_frustum(frame, camera_m, debug_m, camera_position,
                             near, far, resolution, z_buffer, sign):
    """ops/overlay.draw_view_frustum as it was before the segment table: a
    frozen copy, the oracle of the table and its replay."""
    dbg_mvp = np.asarray(debug_m["MVP"], np.float64)
    world = ov.Frustum.vertices @ np.linalg.inv(dbg_mvp)
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
    segments = pixels = 0

    for face in world[ov.Frustum.faces]:
        face = clipping(face, planes)
        if face.shape[0] < 3:
            continue
        face = np.asarray(face, np.float64) @ mvp
        face = face / face[:, [3]]
        face = face @ viewport

        a, b, c = face[0, :3], face[1, :3], face[2, :3]
        n = np.cross(b - a, c - a)

        face[:, 2] = ov._linearize(face[:, 2], near, far)
        count = len(face)
        for i in range(count):
            pxls = bresenham_line(face[i], face[(i + 1) % count])
            if n[2] > 0 and not inside_frustum:
                mask = np.bitwise_and(np.arange(len(pxls)) // 13, 1,
                                      dtype=np.int8).view(np.bool_)
                pxls = pxls[mask]
            if not len(pxls):
                continue
            segments += 1
            y, x, z, _ = pxls.T
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
    return segments, pixels


def k11_model(table, frame, z_buffer, sign):
    """K11's design (csrc/overlay.cu) in numpy, in place: per row, the
    depth test of its kept points against the z-buffer as the rows before
    left it; then each of the five targets of each passing point (the
    pixel, its neighbours at row -1, column -1, row +1, column +1, each
    clipped; -1 wraps) is claimed with the stamp base + j * n + k + 1, the
    target's owner being the largest stamp and its mask the statements
    that hit it; the owner writes the target: its z, its colour red where
    statement 0 hit it, then one half blend per neighbour statement that
    did. Returns the line pixels."""
    h, w = z_buffer.shape
    zf, ff = z_buffer.reshape(-1), frame.reshape(-1, 3)
    owner = np.zeros(h * w, np.int64)
    mask = np.zeros(h * w, np.int64)
    wrap = lambda i, n: np.where(i < 0, i + n, i)
    base = pixels = 0
    for row in table:
        n = int(row[6])
        k = np.arange(n)
        p = row[:3] + k[:, None] * row[3:6]
        live = ((k // ov.DASH) & 1 == 1) if row[7] else np.ones(n, bool)
        x = p[:, 1].astype(np.int32) - 1
        y = p[:, 0].astype(np.int32) - 1
        z = p[:, 2]
        keep = live.copy()
        keep[live] = (zf[wrap(x[live], h) * w + wrap(y[live], w)]
                      - z[live]) * sign >= 0
        k, x, y, z = k[keep], x[keep], y[keep], z[keep]
        pixels += len(k)
        rows = [wrap(x, h), np.clip(x - 1, 0, h - 1), wrap(x, h),
                np.clip(x + 1, 0, h - 1), wrap(x, h)]
        cols = [wrap(y, w), wrap(y, w), np.clip(y - 1, 0, w - 1),
                wrap(y, w), np.clip(y + 1, 0, w - 1)]
        t = np.concatenate([r * w + c for r, c in zip(rows, cols)])
        j = np.repeat(np.arange(5), len(k))
        stamp = base + j * n + np.tile(k, 5) + 1
        np.maximum.at(owner, t, stamp)
        np.bitwise_or.at(mask, t, 1 << j)
        win = owner[t] == stamp
        t, zw = t[win], np.tile(z, 5)[win]
        m = mask[t]
        mask[t] = 0
        zf[t] = zw
        c = ff[t]
        c[m & 1 == 1] = (1.0, 0.0, 0.0)
        for b in range(1, 5):
            hit = (m >> b) & 1 == 1
            c[hit] = c[hit] * 0.5 + np.array((0.5, 0.0, 0.0))
        ff[t] = c
        base += 5 * n
    return pixels


def cameras(resolution, position):
    """(camera_m, debug_m, position, near, far, resolution): the overlay's
    camera arguments for the main camera at ``position`` and camera2."""
    scene = tt.Scene(tt.Camera(position, **MAIN_CAM),
                     debug_camera=tt.Camera(**CAMERA2),
                     resolution=resolution, system=tt.SYSTEM.LH,
                     subsystem=tt.SUBSYSTEM.OPENGL, device="cpu")
    main, dbg = scene.camera, scene.debug_camera
    return (main._matrices(torch.float64), dbg._matrices(torch.float64),
            main.position, main.near, main.far, scene.resolution)


def buffers(table, resolution, seed):
    """A seeded float64 frame in [0, 1) and z-buffer: depths drawn about
    the table's (so that the test passes and fails along a row), a tenth
    of the pixels at -inf (the background of a left-handed frame)."""
    rng = np.random.default_rng(seed)
    frame = rng.random((*resolution, 3))
    z = table[:, 2] if len(table) else np.zeros(1)
    lo, hi = z.min(), z.max()
    pad = (hi - lo) * 0.2 + 1e-6
    zb = rng.uniform(lo - pad, hi + pad, resolution)
    zb[rng.random(resolution) < 0.1] = -np.inf
    return frame, zb


def same(a, b):
    """Equal bit for bit (NaN payloads and the sign of zero included)."""
    a, b = np.asarray(a), np.asarray(b)
    return (a.dtype == b.dtype and a.shape == b.shape
            and np.array_equal(a.view(np.uint8), b.view(np.uint8)))


def orbit_cases():
    return [(res, i) for res in SIZES for i in range(len(POSITIONS))]


def _ids(case):
    res, i = case
    return f"{res[0]}-{i}"


@pytest.mark.parametrize("case", orbit_cases(), ids=_ids)
def test_table_replay_equals_the_frozen_draw(case):
    res, i = case
    cams = cameras(res, POSITIONS[i])
    table = ov.frustum_segments(*cams)
    assert table.dtype == np.float64 and table.shape[1] == ov.SEG_COLS
    assert 0 < len(table) <= ov.MAX_SEGMENTS
    # The main camera stands outside camera2's frustum: back faces dash.
    assert table[:, 7].any() and not table[:, 7].all()
    frame, zb = buffers(table, res, seed=i)
    f0, z0 = frame.copy(), zb.copy()
    want = frozen_draw_view_frustum(f0, *cams, z0, tt.SYSTEM.LH)
    f1, z1 = frame.copy(), zb.copy()
    pixels = ov.draw_segments(table, f1, z1, tt.SYSTEM.LH)
    assert (len(table), pixels) == want
    assert want[1] > 0
    assert same(f1, f0) and same(z1, z0)
    f2, z2 = frame.copy(), zb.copy()
    assert ov.draw_view_frustum(f2, *cams, z2, tt.SYSTEM.LH) == want
    assert same(f2, f0) and same(z2, z0)


def test_rows_are_the_dda_points():
    """Each row's points are bresenham_line's first three columns, bit for
    bit, whichever way the edge runs; an edge under a pixel draws nothing,
    one of zero length its start alone (step -0.0 keeps a -0.0)."""
    rng = np.random.default_rng(5)
    edges = [(rng.uniform(-2, 300, 4), rng.uniform(-2, 300, 4))
             for _ in range(200)]
    a = np.array([10.25, 7.5, -0.0, 1.0])
    edges += [(a, a.copy()), (a, a + [0.4, -0.3, 1.0, 0.0]),
              (a, a + [-0.0, 0.0, 2.0, 0.0]), (a, a + [3.0, 0.0, 1.0, 0.0]),
              (a, a + [-3.0, 0.0, 1.0, 0.0]), (a, a + [0.0, 5.0, 1.0, 0.0])]
    for start, end in edges:
        want = bresenham_line(start, end)[:, :3]
        row = ov._segment(start, end, False)
        if not len(want):
            assert row is None
            continue
        got = ov._points(row, np.arange(int(row[6])))
        assert same(got, want)
        dashed = ov._segment(start, end, True)
        if len(want) <= ov.DASH:
            assert dashed is None
        else:
            assert same(dashed[:7], row[:7]) and dashed[7] == 1.0
    assert ov._segment(a, a, False)[6] == 1


def test_kept_range():
    """The first and last points dashing keeps, against the mask."""
    for n in range(0, 80):
        for dashed in (False, True):
            k = np.arange(n)
            kept = k[(k // ov.DASH) & 1 == 1] if dashed else k
            want = (int(kept[0]), int(kept[-1])) if len(kept) else None
            assert ov._kept_range(n, dashed) == want


def test_points_outside_the_frame_raise():
    """An edge that indexes outside the frame raises IndexError at the
    table, as numpy's writes would."""
    cams = list(cameras((150, 150), POSITIONS[0]))
    table = ov.frustum_segments(*cams)
    span = table[:, 1] + (table[:, 6] - 1) * table[:, 4]
    assert max(table[:, 1].max(), span.max()) > 100
    cams[5] = (100, 150)
    with pytest.raises(IndexError):
        ov.frustum_segments(*cams)


def crafted_table(h, w):
    """Rows no frustum draws at these sizes, for K11's corner cases, with
    their depths about 0.5: (name, row)."""
    r = lambda p0, p1, z, d0, d1, dz, n, dashed=0.0: np.array(
        [p0, p1, z, d0, d1, dz, n, dashed], np.float64)
    return [
        # Row index -1 (p1 in (-1, 1) truncates to 0): the last row.
        ("row_minus_1", r(40.3, 0.5, 0.5, -1.0, 0.0, 1e-3, 30)),
        # Column index -1 for two points (p0 0.5 and -0.5): duplicates.
        ("col_minus_1", r(3.5, 20.2, 0.5, -1.0, 0.1, 1e-3, 6)),
        # Steps of a quarter pixel: four points a pixel, depths apart.
        ("quarter", r(10.1, 10.1, 0.5, 0.25, 0.25, 1e-3, 40)),
        # Along the first row and column: neighbours clipped onto the line.
        ("first_row", r(w - 0.5, 1.5, 0.5, -1.0, 0.0, -1e-4, w - 1)),
        ("first_col", r(1.5, h - 0.5, 0.5, 0.0, -1.0, 1e-4, h - 1)),
        # Along the last row and column.
        ("last_row", r(w + 0.5, h + 0.5, 0.5, -1.0, 0.0, 1e-4, w)),
        ("last_col", r(w + 0.5, h + 0.5, 0.5, 0.0, -1.0, -1e-4, h)),
        # One point (a zero-length edge), its depth -0.0.
        ("one_point", r(7.5, 9.5, -0.0, -0.0, -0.0, -0.0, 1)),
        # Dashed, crossing the others.
        ("dashed", r(w - 2.5, 3.5, 0.5, -1.0, 0.7, 1e-3, w - 4, 1.0)),
        # Back over the first rows: the depth test against their writes.
        ("again", r(35.0, 0.9, 0.4, -0.5, 0.02, 1e-3, 60)),
    ]


def crafted_buffers(h, w, seed):
    rng = np.random.default_rng(seed)
    frame = rng.random((h, w, 3))
    zb = rng.uniform(0.4, 0.6, (h, w))
    zb[rng.random((h, w)) < 0.1] = -np.inf
    return frame, zb


@pytest.mark.parametrize("sign", [-1, 1])
def test_model_equals_the_plain_version_on_crafted_rows(sign):
    h, w = 61, 47
    rows = crafted_table(h, w)
    table = np.stack([row for _, row in rows])
    for k in range(len(rows)):
        one = table[k:k + 1]
        frame, zb = crafted_buffers(h, w, k)
        f0, z0, f1, z1 = frame.copy(), zb.copy(), frame.copy(), zb.copy()
        px = ov.draw_segments(one, f0, z0, sign)
        assert k11_model(one, f1, z1, sign) == px, rows[k][0]
        assert same(f1, f0) and same(z1, z0), rows[k][0]
    frame, zb = crafted_buffers(h, w, 99)
    f0, z0, f1, z1 = frame.copy(), zb.copy(), frame.copy(), zb.copy()
    px = ov.draw_segments(table, f0, z0, sign)
    assert px > 100
    assert k11_model(table, f1, z1, sign) == px
    assert same(f1, f0) and same(z1, z0)
    # The cases are there: -1 wraps, a statement writes a pixel twice.
    assert (z0[-1] != zb[-1]).any() and (z0[:, -1] != zb[:, -1]).any()


@pytest.mark.parametrize("case", orbit_cases(), ids=_ids)
def test_model_equals_the_plain_version_on_orbits(case):
    res, i = case
    cams = cameras(res, POSITIONS[i])
    table = ov.frustum_segments(*cams)
    frame, zb = buffers(table, res, seed=10 + i)
    f0, z0, f1, z1 = frame.copy(), zb.copy(), frame.copy(), zb.copy()
    px = ov.draw_segments(table, f0, z0, tt.SYSTEM.LH)
    assert k11_model(table, f1, z1, tt.SYSTEM.LH) == px > 0
    assert same(f1, f0) and same(z1, z0)


def main_scene(resolution, position, device):
    """main.py's frame, small meshes: a shadowing sphere with a diffuse and
    a tangent normal map over make_floor(2.0, y=-1.0), the directional
    light at (5, 5, 0) towards (0, 0.5, 0.5), LH/OpenGL, shadows, camera2
    as the debug camera."""
    kd, nm, floor_kd = textures()
    mesh = gz.make_sphere(14, 20)
    mesh.shadowing = True
    mesh.materials["default"].map_Kd = kd
    mesh.materials["default"].norm = nm
    mesh.normal_map_is_tangent = True
    floor = gz.make_floor(2.0, y=-1.0)
    floor.materials["default"].map_Kd = floor_kd
    light = tt.Light((5, 5, 0), light_type=tt.Lightning.DIRECTIONAL_LIGHTNING,
                     center=(0, 0.5, 0.5), fovy=90, linear=1e-9,
                     quadratic=1e-10, ambient_strength=0.1,
                     specular_strength=0.1)
    scene = tt.Scene(tt.Camera(position, **MAIN_CAM), light, shadows=True,
                     debug_camera=tt.Camera(**CAMERA2),
                     resolution=resolution, system=tt.SYSTEM.LH,
                     subsystem=tt.SUBSYSTEM.OPENGL, device=device)
    scene.add_model(mesh)
    scene.add_model(floor)
    return scene


def frozen_render_overlay(scene):
    """The overlay's numpy path as Scene.render ran it before K11 and K12,
    on render_core's float frame and z-buffer: (uint8 frame, float64
    z-buffer, segments, pixels)."""
    cfg, dyn = scene._prepare()
    frame, zbuf = pl.render_core(cfg, dyn)[:2]
    frame = frame.cpu().numpy().astype(np.float64)
    zb = zbuf.cpu().numpy().astype(np.float64)
    drawn = frozen_draw_view_frustum(
        frame, scene.camera._matrices(torch.float64),
        scene.debug_camera._matrices(torch.float64), scene.camera.position,
        scene.camera.near, scene.camera.far, scene.resolution, zb,
        scene.system)
    out = (np.clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)
    return out, zb, drawn


def test_scene_equals_the_numpy_path_on_cpu():
    """Scene.render() with a debug camera on the CPU, over three orbit
    positions: the uint8 frame, last_zbuf (a float64 CPU tensor) and the
    overlay counter equal the numpy path; nothing counts as a launch."""
    scene = main_scene((150, 150), POSITIONS[0], "cpu")
    for i in (0, 3, 6):
        scene.camera.set_position(POSITIONS[i])
        profiling.reset()
        rc.reset_launches()
        frame = scene.render()
        snap = profiling.snapshot()
        out, zb, (segments, pixels) = frozen_render_overlay(scene)
        assert same(frame, out)
        assert scene.last_zbuf.dtype == torch.float64
        assert scene.last_zbuf.device.type == "cpu"
        assert same(scene.last_zbuf.numpy(), zb)
        assert snap["overlay"] == {"frames": 1, "segments": segments,
                                   "pixels": pixels}
        assert pixels > 50
        assert rc.LAUNCHES["overlay"] == rc.LAUNCHES["overlay_quantize"] == 0
    profiling.reset()


def test_a_still_debug_camera_builds_its_matrices_once(monkeypatch):
    """Camera._matrices in float64 keeps its last result while the camera
    and the scene's frame settings stay the same: over three frames of an
    orbit the moving main camera builds its matrices each frame, the still
    debug camera once; the kept arrays equal a fresh build bit for bit and
    are read-only; moving or refocusing the debug camera builds again."""
    from tpu_renderer_torch.models import camera as cam_mod

    built = []
    real = cam_mod.camera_matrices

    def counting(position, *args, **kw):
        if kw.get("dtype") == torch.float64:
            built.append(tuple(np.asarray(position).tolist()))
        return real(position, *args, **kw)

    monkeypatch.setattr(cam_mod, "camera_matrices", counting)
    scene = main_scene((150, 150), POSITIONS[0], "cpu")
    dbg = scene.debug_camera
    for position in POSITIONS[:3]:
        scene.camera.set_position(position)
        scene.render()
    dbg_pos = tuple(np.asarray(dbg.position).tolist())
    assert built.count(dbg_pos) == 1 and len(built) == 4
    kept = dbg._matrices(torch.float64)
    fresh = real(dbg.position, dbg.center, dbg.up, dbg.fovy, dbg.near,
                 dbg.far, projection_type=dbg.projection_type,
                 system=scene.system, subsystem=scene.subsystem,
                 resolution=scene.resolution, x_offset=dbg.x_offset,
                 y_offset=dbg.y_offset, host=True, dtype=torch.float64)
    assert kept.keys() == fresh.keys()
    assert all(same(kept[k], fresh[k]) for k in kept)
    with pytest.raises(ValueError):
        kept["MVP"][0, 0] = 0.0
    dbg.set_position((0, 3.5, 0.01))
    assert not same(dbg._matrices(torch.float64)["MVP"], kept["MVP"])
    dbg.fovy = 70
    dbg._matrices(torch.float64)
    dbg._matrices(torch.float64)
    assert len(built) == 6
    # The float32 form is built afresh on every call.
    assert dbg._matrices()["MVP"] is not dbg._matrices()["MVP"]


def test_plain_wrappers_on_cpu_tensors():
    """rc.overlay and rc.overlay_quantize on CPU tensors run the numpy
    plain versions in place and count into the given counter."""
    res = (150, 150)
    cams = cameras(res, POSITIONS[2])
    table = ov.frustum_segments(*cams)
    frame, zb = buffers(table, res, seed=3)
    f0, z0 = frame.copy(), zb.copy()
    px = ov.draw_segments(table, f0, z0, tt.SYSTEM.LH)
    f, z = torch.from_numpy(frame.copy()), torch.from_numpy(zb.copy())
    counter = torch.zeros(1, dtype=torch.int64)
    rc.overlay(torch.from_numpy(table), f, z, tt.SYSTEM.LH, counter)
    assert int(counter) == px > 0
    assert same(f.numpy(), f0) and same(z.numpy(), z0)
    out = rc.overlay_quantize(f)
    want = (np.clip(f0[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)
    assert out.dtype == torch.uint8 and same(out.numpy(), want)


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


def _on_card(table, frame, zb, sign):
    """K11 then K12 on the card; (frame, zb, pixels, uint8) on the host,
    and the launches."""
    f = torch.from_numpy(frame).cuda()
    z = torch.from_numpy(zb).cuda()
    counter = torch.zeros(1, dtype=torch.int64, device="cuda")
    rc.reset_launches()
    rc.overlay(torch.from_numpy(table), f, z, sign, counter)
    out = rc.overlay_quantize(f)
    torch.cuda.synchronize()
    launched = (rc.LAUNCHES["overlay"], rc.LAUNCHES["overlay_quantize"])
    return (f.cpu().numpy(), z.cpu().numpy(), int(counter),
            out.cpu().numpy(), launched)


def _plain(table, frame, zb, sign):
    f, z = frame.copy(), zb.copy()
    px = ov.draw_segments(table, f, z, sign)
    return f, z, px, (np.clip(f[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)


@pytest.mark.cuda
@pytest.mark.parametrize("case", orbit_cases(), ids=_ids)
def test_kernels_equal_plain_on_card(card, case):
    res, i = case
    cams = cameras(res, POSITIONS[i])
    table = ov.frustum_segments(*cams)
    frame, zb = buffers(table, res, seed=20 + i)
    *got, launched = _on_card(table, frame, zb, tt.SYSTEM.LH)
    want = _plain(table, frame, zb, tt.SYSTEM.LH)
    assert launched == (1, 1)
    assert got[2] == want[2] > 0
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert same(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("sign", [-1, 1])
def test_kernels_equal_plain_on_crafted_rows_on_card(card, sign):
    h, w = 61, 47
    table = np.stack([row for _, row in crafted_table(h, w)])
    for k in range(len(table) + 1):
        one = table if k == len(table) else table[k:k + 1]
        frame, zb = crafted_buffers(h, w, k)
        *got, _ = _on_card(one, frame, zb, sign)
        want = _plain(one, frame, zb, sign)
        assert got[2] == want[2], k
        for g, w_ in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert same(g, w_), k
    # An empty table draws nothing and still quantizes.
    frame, zb = crafted_buffers(h, w, 0)
    *got, launched = _on_card(table[:0], frame, zb, sign)
    assert launched == (1, 1) and got[2] == 0
    assert same(got[0], frame) and same(got[1], zb)


@pytest.mark.cuda
def test_quantize_equals_numpy_on_special_values_on_card(card):
    """K12 against numpy's flip, ** 0.8, clip and uint8 on float32 values
    cast to float64 (as the frame comes), the chains of one to eight half
    blends K11 leaves where several neighbour statements hit a pixel (red
    v * 0.5 + 0.5, green and blue v * 0.5, in draw order), values off
    [0, 1], infinities, NaN and zeros of both signs."""
    rng = np.random.default_rng(7)
    v = rng.random(3 * 1024 * 1024).astype(np.float32).astype(np.float64)
    special = np.array([0.0, -0.0, 1.0, -1e-300, 1.0 + 1e-16, 2.0, -0.5,
                        np.inf, -np.inf, np.nan, 5e-324, 0.5, 1 / 255,
                        254.5 / 255, 255 / 256])
    red, dark, chains = v, v, []
    for blends in range(8):
        red, dark = red * 0.5 + 1.0 / 2, dark * 0.5 + 0.0 / 2
        # The first chain whole; the deeper ones on a third of the values.
        chains += [red, dark] if blends == 0 else [red[::3], dark[::3]]
    vals = np.concatenate([v, *chains, special])
    vals = np.resize(vals, (len(vals) + 3 * 1023) // (3 * 1024) * 3 * 1024)
    frame = vals.reshape(-1, 1024, 3)
    out = rc.overlay_quantize(torch.from_numpy(frame).cuda()).cpu().numpy()
    with np.errstate(invalid="ignore"):
        want = (np.clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)
    assert same(out, want)


@pytest.mark.cuda
def test_kernels_do_not_wait_for_the_device(card):
    import chip_smoke

    res = (1500, 1500)
    cams = cameras(res, POSITIONS[1])
    table = torch.from_numpy(ov.frustum_segments(*cams))
    f = torch.rand((*res, 3), dtype=torch.float64, device="cuda")
    z = torch.rand(res, dtype=torch.float64, device="cuda")
    counter = torch.zeros(1, dtype=torch.int64, device="cuda")
    chip_smoke._assert_no_sync(lambda: (
        rc.overlay(table, f, z, tt.SYSTEM.LH, counter),
        rc.overlay_quantize(f)))


@pytest.mark.cuda
def test_scene_on_card_equals_the_numpy_path(card):
    """Scene.render() at 1500² with camera2, over the 8 orbit positions:
    the uint8 frame, last_zbuf (float64, on the card, a fresh tensor each
    frame) and the overlay's segments and pixels equal the numpy path on
    render_core's float outputs; each frame launches K11 and K12 once and
    copies the uint8 frame alone to the host, the table up once."""
    h, w = 1500, 1500
    scene = main_scene((h, w), POSITIONS[0], "cuda")
    scene.render()
    zbufs = []
    for position in POSITIONS:
        scene.camera.set_position(position)
        profiling.reset()
        rc.reset_launches()
        frame = scene.render()
        snap = profiling.snapshot()
        assert rc.LAUNCHES["overlay"] == rc.LAUNCHES["overlay_quantize"] == 1
        out, zb, (segments, pixels) = frozen_render_overlay(scene)
        assert scene.last_zbuf.dtype == torch.float64
        assert scene.last_zbuf.is_cuda
        assert same(frame, out)
        assert same(scene.last_zbuf.cpu().numpy(), zb)
        assert snap["overlay"] == {"frames": 1, "segments": segments,
                                   "pixels": pixels}
        assert pixels > 100
        copies = snap["copies"]
        assert copies["readback"]["d2h"] == [1, h * w * 3]
        assert copies["overlay"]["h2d"] == [1, segments * ov.SEG_COLS * 8]
        zbufs.append(scene.last_zbuf)
    assert len({z.data_ptr() for z in zbufs}) == len(zbufs)
    profiling.reset()
