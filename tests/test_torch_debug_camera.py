"""The debug camera, its frustum overlay and the camera/light gizmos in the
PyTorch port, against the JAX package on the CPU.

- Packers: ``face_flags`` with ``clip_dbg`` equals the JAX package's
  ``face_flags(with_debug=True)``, and ``pack_debug_planes`` its
  ``pack_faces(with_debug=True)[:, 34:52]`` (rtol 1e-6).
- K1 (both modes) and K7 with the debug planes, through their plain
  versions, against ``visibility_gbuffer_pallas``, ``visibility_pallas``
  and ``tidpass_pallas`` with ``with_debug=True`` in interpret mode, the
  sharded modes on a block of rows that does not start on a tile edge: tid
  >= 99.9% equal, z within rtol 1e-6 where tid agrees (XLA's CPU backend
  contracts a*b + c into fused multiply-adds, so z agrees to a few ulps;
  test_torch_modules.py). Faces wholly inside the main camera's frustum
  that only the debug planes cut take the per-pixel test and lose pixels.
- ``Scene(debug_camera=...)`` through the port against the JAX ``Scene``,
  general, gouraud and wireframe, with a debug camera that cuts the mesh
  and with one equal to the main camera, at the North-star bars (tid >=
  99.9%, stencil equal, frame >= 99.9%); the overlay-modified
  ``last_zbuf`` equals JAX's on every pixel the overlay wrote, and within
  rtol 1e-5 elsewhere where tid agrees.
- The float64 host matrices equal the JAX package's ``host=True`` ones
  under ``jax.enable_x64``; ``draw_view_frustum``, ``clipping``,
  ``bresenham_line`` and ``draw_line`` equal JAX's on seeded inputs.
- The reference renderer's own demo frame (obj/main.py,
  examples/demo.py:29-67: a directional light, shadow volumes, the main
  camera at near 1e-4, camera2 as the debug camera at near 1 and far 3)
  at 150², no multiple of the kernels' tiles, from main.py's camera and
  from a point of the benchmark's orbit, against JAX at the North-star
  bars (the stencil's outside the port's depth ties, as
  test_torch_configs.py holds it), the overlay's depths equal where it
  wrote.
- The ten-box golden scene (tests/test_golden2.py:228-294, 160²) against
  the cached NumPy-reference frame at ``compare()``'s default bar, and
  against JAX at the North-star bars; the light and camera gizmos
  (``show=True``) against JAX; ``dyn_from_numpy`` with a debug camera.
- Sharded (1, 2) and (2, 2) frames with a debug camera on gloo ranks
  against the port's one-device frame (test_torch_parallel.py's bars).

This module is imported by the spawned ranks: it imports JAX only inside
tests and fixtures.
"""
import datetime
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import tpu_renderer_torch as tt
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import raster_plain as rp

from chip_smoke import one_device_ids
from test_torch_kernels import (  # noqa: E402,F401
    DEBUG_CAM, RES, build_scene, one_torch_thread, textures)

H, W = RES
#: The module cases' block of rows, not aligned to the 16-row tiles.
ROW0 = 24
LH = H - ROW0
#: The main camera of build_scene, as a debug camera equal to it.
SAME_CAM = dict(position=(2, 2.5, 4), center=(0, 0, 0), fovy=60, near=0.01,
                far=50)
CAMERAS = {"distinct": DEBUG_CAM, "same": SAME_CAM}


def _np_tree(tree):
    import jax

    return jax.tree_util.tree_map(np.asarray, tree)


def _hold(got, want):
    """The North-star bars: tid >= 99.9% equal, stencil equal, frame >=
    99.9% identical pixels (got and want: frame, tid, stencil)."""
    frame, tid, stencil = got
    assert frame.shape == want[0].shape and frame.dtype == np.uint8
    assert (tid == want[1]).mean() >= 0.999
    np.testing.assert_array_equal(stencil, want[2])
    assert (frame == want[0]).all(-1).mean() >= 0.999
    assert (tid >= 0).any()


# ------------------------------------------------------------- modules

@pytest.fixture(scope="module")
def jax_faces():
    """The JAX package's face batch of the kernel-test scene with the
    distinct debug camera, and the port's tables packed from it."""
    import jax

    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax
    from tpu_renderer.ops import pipeline as pl_jax

    cfg, dyn = build_scene(tj, gz_jax,
                           debug_camera=tj.Camera(**DEBUG_CAM))._prepare()
    cam_m = pl_jax._cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    dbg_mvp = pl_jax._cam_matrices(cfg, dyn["debug_camera"],
                                   cfg.dbg_projection_type)["MVP"]
    faces, attrs = jax.jit(lambda d, c, m: pl_jax._build_face_batch(
        cfg, d, c, m))(dyn, cam_m, dbg_mvp)
    faces, attrs = _np_tree(faces), _np_tree(attrs)
    ft = {k: torch.from_numpy(np.array(v)) for k, v in faces.items()}
    return cfg, faces, attrs, ft


def test_packers_match_jax(jax_faces):
    from tpu_renderer.ops.raster_pallas import face_flags, pack_faces

    _, faces, _, ft = jax_faces
    flags = rc.face_flags(ft).numpy()
    np.testing.assert_array_equal(flags, np.asarray(face_flags(faces, True)))
    want = np.asarray(pack_faces(faces, True))
    np.testing.assert_allclose(rc.pack_debug_planes(ft).numpy(),
                               want[:, 34:52], rtol=1e-6)
    np.testing.assert_allclose(rc.pack_faces(ft).numpy(), want[:, :34],
                               rtol=1e-6)
    without = {k: v for k, v in ft.items() if k != "clip_dbg"}
    assert rc.pack_debug_planes(without) is None
    np.testing.assert_array_equal(rc.face_flags(without).numpy(),
                                  np.asarray(face_flags(faces, False)))


def test_debug_space_alone_sets_the_clip_test(jax_faces):
    """A face wholly inside the main camera's frustum that only the debug
    planes cut. In the scene, such faces exist: without the debug camera
    they skip the per-pixel test, with it they take it. Adversarially, in
    a debug space equal to the camera's, the inside face that wins most
    pixels gets two vertices past the debug frustum's right plane: it
    takes the test for the debug space alone and loses pixels, in the
    port's K1 as in visibility_pallas(with_debug=True)."""
    from tpu_renderer.ops.raster_pallas import visibility_pallas

    cfg, faces, _, ft = jax_faces
    flags = rc.face_flags(ft)
    without = rc.face_flags({k: v for k, v in ft.items() if k != "clip_dbg"})
    e_cam = rc._conds(ft["clip"]) * ft["inv_w"][..., None]
    inside = (e_cam > 0).all(2).all(1) & ft["clip_en"] & ft["valid"]
    by_debug = inside & ((flags & rp.FLAG_PPC) > 0) \
        & ((without & rp.FLAG_PPC) == 0)
    assert int(by_debug.sum()) >= 3

    fdata = rc.pack_faces(ft)
    _, tid0 = rc.visibility(fdata, without, H, W, cfg.system)
    won = torch.bincount(tid0[tid0 >= 0].long(), minlength=len(without))
    f = int(torch.where(inside & ((without & rp.FLAG_PPC) == 0), won,
                        -1).argmax())
    clip_dbg = faces["clip"].copy()
    clip_dbg[f, :2, 0] = 3.0 * clip_dbg[f, :2, 3]        # x = 3w: outside
    faces = dict(faces, clip_dbg=clip_dbg)
    ft = dict(ft, clip_dbg=torch.from_numpy(clip_dbg))
    flags, fdbg = rc.face_flags(ft), rc.pack_debug_planes(ft)
    assert flags[f] & rp.FLAG_PPC and not without[f] & rp.FLAG_PPC
    _, tid = rc.visibility(fdata, flags, H, W, cfg.system, fdbg=fdbg)
    assert ((tid0 == f) & (tid != f)).sum() > 20
    _, tid_j = visibility_pallas(faces, H, W, cfg.system, with_debug=True,
                                 interpret=True)
    tid_j = np.asarray(tid_j)
    assert (tid.numpy() == tid_j).mean() >= 0.999
    np.testing.assert_array_equal(tid.numpy() == f, tid_j == f)


def test_k1_matches_pallas(jax_faces):
    """K1's z and tid mode vs visibility_gbuffer_pallas (phase 0), with
    the debug camera."""
    from tpu_renderer.ops.raster_pallas import visibility_gbuffer_pallas

    cfg, faces, attrs, ft = jax_faces
    zb_j, tid_j, _ = (np.asarray(a) for a in visibility_gbuffer_pallas(
        faces, attrs, H, W, cfg.system, with_debug=True, interpret=True,
        with_tex_tables=True))
    zb_t, tid_t = (a.numpy() for a in rc.visibility(
        rc.pack_faces(ft), rc.face_flags(ft), H, W, cfg.system,
        fdbg=rc.pack_debug_planes(ft)))
    same = tid_t == tid_j
    assert same.mean() >= 0.999 and (tid_t >= 0).any()
    fin = same & np.isfinite(zb_j)
    np.testing.assert_allclose(zb_t[fin], zb_j[fin], rtol=1e-6, atol=0)


def test_k1_z_only_matches_pallas(jax_faces):
    """K1's z-only mode on the rows from ROW0 vs visibility_pallas
    (want_tid=False), with the debug camera."""
    from tpu_renderer.ops.raster_pallas import visibility_pallas

    cfg, faces, _, ft = jax_faces
    zb_j, none_j = visibility_pallas(faces, LH, W, cfg.system,
                                     with_debug=True, interpret=True,
                                     row0=ROW0, want_tid=False)
    zb_t, none_t = rc.visibility(rc.pack_faces(ft), rc.face_flags(ft), LH, W,
                                 cfg.system, row0=ROW0, want_tid=False,
                                 fdbg=rc.pack_debug_planes(ft))
    assert none_j is None and none_t is None
    zb_j, zb_t = np.asarray(zb_j), zb_t.numpy()
    fin = np.isfinite(zb_j)
    assert fin.sum() > 150
    np.testing.assert_array_equal(np.isinf(zb_t), ~fin)
    np.testing.assert_allclose(zb_t[fin], zb_j[fin], rtol=1e-6, atol=0)


def test_k7_matches_pallas(jax_faces):
    """K7's claim on the rows from ROW0 against K1's z-buffer, ids offset
    by gid0, vs tidpass_pallas with the debug camera."""
    from tpu_renderer.ops.raster_pallas import tidpass_pallas

    cfg, faces, _, ft = jax_faces
    fdata, flags, fdbg = (rc.pack_faces(ft), rc.face_flags(ft),
                          rc.pack_debug_planes(ft))
    zb, tid = rc.visibility(fdata, flags, H, W, cfg.system, fdbg=fdbg)
    gid0 = 40
    zb_block = zb[ROW0:].contiguous()
    want = np.asarray(tidpass_pallas(
        dict(faces, gid=faces["gid"] + np.int32(gid0)), zb_block.numpy(), LH,
        W, cfg.system, with_debug=True, interpret=True, row0=ROW0))
    got = rc.tidpass(fdata, flags, zb_block, cfg.system, row0=ROW0,
                     gid0=gid0, fdbg=fdbg)
    assert (want >= gid0).any()
    assert (got.numpy() == want).mean() >= 0.999
    block = tid[ROW0:]
    assert torch.equal(got, torch.where(block >= 0, block + gid0, block))


# ------------------------------------------------------------- host overlay

def _random_camera(rng, i):
    from tpu_renderer_torch.constants import (PROJECTION_TYPE, SUBSYSTEM,
                                              SYSTEM)

    combos = [(PROJECTION_TYPE.PERSPECTIVE, s, sub)
              for s in (SYSTEM.LH, SYSTEM.RH)
              for sub in (SUBSYSTEM.OPENGL, SUBSYSTEM.DIRECTX)]
    combos.append((PROJECTION_TYPE.ORTHOGRAPHIC, SYSTEM.LH, SUBSYSTEM.OPENGL))
    pt, system, sub = combos[i % len(combos)]
    args = (rng.uniform(-5, 5, 3).astype(np.float32),
            rng.uniform(-1, 1, 3).astype(np.float32),
            np.array([0, 1, 0], np.float32), float(rng.choice([45, 60, 75.5])),
            float(rng.choice([1e-4, 0.01, 0.5])), float(rng.choice([6, 50])))
    kw = dict(projection_type=pt, system=system, subsystem=sub,
              resolution=[(64, 128), (160, 160)][i % 2])
    return args, kw


def test_host_matrices_match_jax_x64():
    """camera_matrices(host=True, dtype=float64) equals the JAX package's
    host=True matrices under jax.enable_x64, bit for bit, on 60 seeded
    cameras over every projection, system and subsystem."""
    import jax

    from tpu_renderer.models.camera import camera_matrices as cm_jax
    from tpu_renderer_torch.models.camera import camera_matrices as cm_torch

    rng = np.random.default_rng(3)
    for i in range(60):
        args, kw = _random_camera(rng, i)
        with jax.enable_x64(True):
            want = {k: np.asarray(v)
                    for k, v in cm_jax(*args, host=True, **kw).items()}
        got = cm_torch(*args, host=True, dtype=torch.float64, **kw)
        for key, value in want.items():
            assert got[key].dtype == np.float64
            np.testing.assert_array_equal(got[key], value, err_msg=key)


def test_overlay_helpers_match_jax():
    """draw_view_frustum (both cameras' f64 host matrices, a seeded frame
    and z-buffer, the main camera inside and outside the debug frustum),
    clipping, bresenham_line and draw_line: equal to the JAX package's."""
    import jax

    from tpu_renderer.models.camera import camera_matrices as cm_jax
    from tpu_renderer.ops import frustum as fr_jax
    from tpu_renderer.ops import lines as ln_jax
    from tpu_renderer.ops import overlay as ov_jax
    from tpu_renderer_torch.constants import PROJECTION_TYPE, SUBSYSTEM, SYSTEM
    from tpu_renderer_torch.models.camera import camera_matrices as cm_torch
    from tpu_renderer_torch.ops import frustum as fr_torch
    from tpu_renderer_torch.ops import lines as ln_torch
    from tpu_renderer_torch.ops import overlay as ov_torch

    rng = np.random.default_rng(4)
    res = (96, 128)
    kw = dict(projection_type=PROJECTION_TYPE.PERSPECTIVE, system=SYSTEM.LH,
              subsystem=SUBSYSTEM.OPENGL, resolution=res)
    cam = (np.array([2, 2.5, 4], np.float32), np.zeros(3, np.float32),
           np.array([0, 1, 0], np.float32), 60.0, 0.01, 50.0)
    drawn = 0
    for dbg in [(np.array([1, 3, 1.5], np.float32),) + cam[1:3]
                + (50.0, 2.4, 3.8),
                (np.array([2.5, 3, 5], np.float32),) + cam[1:3]
                + (80.0, 0.5, 40.0), cam]:
        with jax.enable_x64(True):
            mj = [{k: np.asarray(v) for k, v in
                   cm_jax(*c, host=True, **kw).items()} for c in (cam, dbg)]
        mt = [cm_torch(*c, host=True, dtype=torch.float64, **kw)
              for c in (cam, dbg)]
        frame = rng.random((*res, 3))
        zb = rng.uniform(1.0, 30.0, res) * -1.0
        zb[rng.random(res) < 0.3] = -np.inf
        outs = []
        for ov, m in ((ov_jax, mj), (ov_torch, mt)):
            f, z = frame.copy(), zb.copy()
            ov.draw_view_frustum(f, m[0], m[1], cam[0], cam[4], cam[5], res,
                                 z, SYSTEM.LH)
            outs.append((f, z))
        np.testing.assert_array_equal(outs[1][0], outs[0][0])
        np.testing.assert_array_equal(outs[1][1], outs[0][1])
        drawn += int((outs[1][1] != zb).sum())
        poly = np.concatenate([rng.uniform(-3, 3, (5, 3)), np.ones((5, 1))],
                              1)
        np.testing.assert_array_equal(
            fr_torch.clipping(poly, mt[0]["frustum_planes"]),
            fr_jax.clipping(poly, mj[0]["frustum_planes"]))
    assert drawn > 100
    for _ in range(40):
        a, b = rng.uniform(-20, 150, 4), rng.uniform(-20, 150, 4)
        if rng.random() < 0.2:
            b = a.copy()
        np.testing.assert_array_equal(ln_torch.bresenham_line(a, b),
                                      ln_jax.bresenham_line(a, b))
    outs = []
    for ln, m in ((ln_jax, mj[0]), (ln_torch, mt[0])):
        f, z = np.zeros((*res, 3)), np.full(res, np.inf)
        z[40:50, 30:60] = 0.1
        for seg in ((np.array([70.0, 20.0, 0.4, 1.0]),
                     np.array([15.0, 80.0, 0.6, 1.0])),
                    (np.array([10.0, 44.0, 0.5, 1.0]),
                     np.array([90.0, 46.0, 0.5, 1.0])),
                    (np.array([50.0, 5.0, 0.2, 1.0]),
                     np.array([50.0, 140.0, 0.9, 1.0]))):
            ln.draw_line(*seg, m, res, z, f)
        outs.append((f, z))
    assert outs[1][0].max() > 0
    np.testing.assert_array_equal(outs[1][0], outs[0][0])
    np.testing.assert_array_equal(outs[1][1], outs[0][1])


# ------------------------------------------------------------- scenes

def _render(pkg, gizmos, shader, camera, **kw):
    scene = build_scene(pkg, gizmos, shader=shader,
                        debug_camera=pkg.Camera(**CAMERAS[camera]), **kw)
    frame = scene.render()
    return scene, frame


@pytest.fixture(scope="module")
def jax_scenes():
    """(shader, camera) -> the JAX Scene's (frame, zbuf, tid, stencil)."""
    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax

    out = {}
    for shader in ("general", "gouraud", "wireframe"):
        for camera in CAMERAS:
            scene, frame = _render(tj, gz_jax, shader, camera)
            out[shader, camera] = (frame, np.asarray(scene.last_zbuf),
                                   np.asarray(scene.last_tid),
                                   np.asarray(scene.last_stencil))
    return out


@pytest.mark.parametrize("camera", list(CAMERAS))
@pytest.mark.parametrize("shader", ["general", "gouraud", "wireframe"])
def test_scene_matches_jax(jax_scenes, shader, camera):
    frame_j, zb_j, tid_j, st_j = jax_scenes[shader, camera]
    scene, frame = _render(tt, gz_torch, shader, camera, device="cpu")
    tid = scene.last_tid.numpy()
    _hold((frame, tid, scene.last_stencil.numpy()), (frame_j, tid_j, st_j))
    zb = scene.last_zbuf.numpy()
    same = tid == tid_j
    assert (np.isinf(zb) == np.isinf(zb_j)).mean() >= 0.999
    fin = same & np.isfinite(zb_j) & np.isfinite(zb)
    np.testing.assert_allclose(zb[fin], zb_j[fin], rtol=1e-5, atol=0)
    if shader == "wireframe":
        assert scene.last_zbuf.dtype == torch.float32     # no overlay
        return
    # The overlay's own depths, where it wrote: bit-identical to JAX's.
    cfg, dyn = scene._prepare()
    before = pl.render_core(cfg, dyn)[1].numpy().astype(np.float64)
    wrote = (zb != before) & ~(np.isnan(zb) & np.isnan(before))
    assert scene.last_zbuf.dtype == torch.float64
    assert wrote.sum() > 100
    np.testing.assert_array_equal(zb[wrote], zb_j[wrote])
    red = (frame[..., 0] > 200) & (frame[..., 1] < 80)
    assert red.sum() > 50


def test_debug_camera_clips(jax_scenes):
    """The distinct debug camera takes pixels from the mesh (about half of
    the foreground) in JAX's frame; the one equal to the main camera only
    moves a few edge pixels (its clip space is computed by another product
    than the camera's, so values near 0 can change sign)."""
    scene = build_scene(tt, gz_torch, device="cpu")
    scene.render()
    plain = scene.last_tid.numpy()
    for camera, lo, hi in (("distinct", 0.2, 0.8), ("same", 0.0, 0.01)):
        tid = jax_scenes["general", camera][2]
        share = ((tid != plain) & (plain >= 0)).sum() / (plain >= 0).sum()
        assert lo <= share <= hi, (camera, share)


def test_gizmos_match_jax():
    """A light gizmo (test_overlay.py:47-57) and a shown debug camera's
    gizmo beside a cube: the same models as the JAX Scene, and its frame
    at the bars."""
    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax

    outs = []
    for pkg, gz, kw in ((tj, gz_jax, {}), (tt, gz_torch, {"device": "cpu"})):
        cam = pkg.Camera((2, 2, 4), center=(0, 0, 0), fovy=60, near=0.1,
                         far=50)
        light = pkg.Light((1.5, 1.5, 0), show=True, ambient_strength=0.2)
        dbg = pkg.Camera((-1.5, 1.0, 1.5), center=(0, 0, 0), fovy=40,
                         near=0.5, far=4, show=True)
        scene = pkg.Scene(cam, light, debug_camera=dbg, resolution=(96, 96),
                          system=pkg.SYSTEM.RH, subsystem=pkg.SUBSYSTEM.OPENGL,
                          shadows=True, **kw)
        scene.add_model(gz.make_cube(0.8))
        frame = scene.render()
        outs.append((scene, frame, np.asarray(scene.last_tid),
                     np.asarray(scene.last_stencil)))
    (sj, fj, tj_, stj), (st, ft, tt_, stt) = outs
    assert len(st.models) == len(sj.models) == 3
    for mj, mt in zip(sj.models, st.models):
        assert mt.clip == mj.clip
        np.testing.assert_allclose(mt.vertices, mj.vertices, rtol=1e-6,
                                   atol=1e-6)
        assert (mt.normals is None) == (mj.normals is None)
        if mt.normals is not None:
            np.testing.assert_allclose(mt.normals, mj.normals, rtol=1e-5,
                                       atol=1e-6)
    _hold((ft, tt_, stt), (fj, tj_, stj))
    # Both gizmos win pixels: ids count the sphere's padded faces first,
    # then the camera gizmo's.
    n_sphere = -(-st.models[0].num_faces // 8) * 8
    n_camera = -(-st.models[1].num_faces // 8) * 8
    assert ((tt_ >= 0) & (tt_ < n_sphere)).any()
    assert ((tt_ >= n_sphere) & (tt_ < n_sphere + n_camera)).any()


#: obj/main.py's cameras (main.py:76-92, examples/demo.py:50-55) and light.
MAIN_CAM = dict(center=(0, 0, 0), fovy=90, near=0.0001, far=400,
                backface_culling=False)
CAMERA2 = dict(position=(0, 3, 0.01), center=(0, 0, 0), fovy=80, near=1,
               far=3, backface_culling=True)
#: Where the main camera stands: main.py's own position, and a point of
#: the benchmark's orbit (radius 5.05 about (0.5, 3, 0)).
MAIN_POSITIONS = {"main": (0.5, 3.0, 5.0),
                  "orbit": (0.5 + 5.05 * np.sin(2.0), 3.0,
                            5.05 * np.cos(2.0))}
MAIN_RES = (150, 150)


def main_scene(pkg, gizmos, position, **kw):
    """main.py's frame at 150²: a shadowing sphere with a diffuse and a
    tangent normal map in place of diablo3_pose, over make_floor(2.0,
    y=-1.0) (main.py:48's floor.obj is absent), the directional light at
    (5, 5, 0) towards (0, 0.5, 0.5), LH/OpenGL, shadows, camera2 as the
    debug camera."""
    kd, nm, floor_kd = textures(1)
    mesh = gizmos.make_sphere(14, 20)
    mesh.shadowing = True
    mesh.materials["default"].map_Kd = kd
    mesh.materials["default"].norm = nm
    mesh.normal_map_is_tangent = True
    floor = gizmos.make_floor(2.0, y=-1.0)
    floor.materials["default"].map_Kd = floor_kd
    light = pkg.Light((5, 5, 0),
                      light_type=pkg.Lightning.DIRECTIONAL_LIGHTNING,
                      center=(0, 0.5, 0.5), fovy=90, linear=1e-9,
                      quadratic=1e-10, ambient_strength=0.1,
                      specular_strength=0.1)
    scene = pkg.Scene(pkg.Camera(position, **MAIN_CAM), light, shadows=True,
                      debug_camera=pkg.Camera(**CAMERA2),
                      resolution=MAIN_RES, system=pkg.SYSTEM.LH,
                      subsystem=pkg.SUBSYSTEM.OPENGL, **kw)
    scene.add_model(mesh)
    scene.add_model(floor)
    return scene


@pytest.fixture(scope="module")
def jax_main_frames():
    """position name -> the JAX Scene's (frame, zbuf, tid, stencil) of
    main.py's frame."""
    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax

    out = {}
    for name, position in MAIN_POSITIONS.items():
        scene = main_scene(tj, gz_jax, position)
        frame = scene.render()
        out[name] = (frame, np.asarray(scene.last_zbuf),
                     np.asarray(scene.last_tid),
                     np.asarray(scene.last_stencil))
    return out


@pytest.mark.parametrize("position", list(MAIN_POSITIONS))
def test_main_frame_matches_jax(jax_main_frames, position):
    """The port's Scene of main.py's frame against JAX's at the North-star
    bars. The debug camera keeps only the top of the sphere (the floor
    lies past its far plane); the overlay's depths are JAX's bit for bit
    where it wrote."""
    from test_torch_ssaa_stats import stencil_ties

    frame_j, zb_j, tid_j, st_j = jax_main_frames[position]
    scene = main_scene(tt, gz_torch, MAIN_POSITIONS[position], device="cpu")
    frame = scene.render()
    tid, stencil = scene.last_tid.numpy(), scene.last_stencil.numpy()
    assert (tid == tid_j).mean() >= 0.999 and (tid >= 0).any()
    assert (frame == frame_j).all(-1).mean() >= 0.999
    floor_ids = tid >= -(-scene.models[0].num_faces // 8) * 8
    assert not floor_ids.any()
    # At near = 1e-4 XLA's fused multiply-adds move JAX's linearized depth
    # by up to 4.4e-5 relative here (measured), which flips a pixel's
    # shadow test where it ties (test_torch_configs.py's bar): equal
    # outside the port's ties within that.
    cfg, dyn = scene._prepare()
    before = pl.render_core(cfg, dyn)[1].numpy()
    differ = stencil != st_j
    assert not (differ & ~stencil_ties(cfg, dyn, before, rtol=1e-4)).any()
    assert differ.mean() <= 0.001
    zb = scene.last_zbuf.numpy()
    assert zb.dtype == np.float64
    before = before.astype(np.float64)
    wrote = (zb != before) & ~(np.isnan(zb) & np.isnan(before))
    assert wrote.sum() > 100
    np.testing.assert_array_equal(zb[wrote], zb_j[wrote])
    same = (tid == tid_j) & np.isfinite(zb_j) & ~wrote
    np.testing.assert_allclose(zb[same], zb_j[same], rtol=1e-4, atol=0)


def test_ten_boxes_golden(ref_render, tmp_path):
    """The ten-box scene of tests/test_golden2.py:228-294 (a debug camera
    equal to the main camera) through the port at 160²: the cached NumPy
    reference frame at compare()'s default bar, and JAX's frame at the
    North-star bars."""
    import tpu_renderer as tj
    from test_golden import BORDER, compare
    from test_golden import RES as GOLDEN_RES
    from tpu_renderer_torch.ops.shadow import shadow_stencil
    from test_golden2 import TEN_CAM, _write_ten_boxes

    paths = _write_ten_boxes(str(tmp_path))

    def scene_of(pkg, **kw):
        scene = pkg.Scene(pkg.Camera(**TEN_CAM),
                          pkg.Light((3, 5, 2), ambient_strength=0.15),
                          shadows=True, debug_camera=pkg.Camera(**TEN_CAM),
                          resolution=GOLDEN_RES, system=pkg.SYSTEM.LH,
                          subsystem=pkg.SUBSYSTEM.OPENGL, **kw)
        for p in paths:
            scene.add_model(pkg.Model.load_model(p))
        return scene

    def missing():
        raise AssertionError("the cached reference frame is missing")

    ours = scene_of(tt, device="cpu")
    frame = ours.render()
    ref = ref_render("ten_models", dict(cam=TEN_CAM, res=GOLDEN_RES, n=10,
                                        boxes="imgpng-64-grid2x5-v1"), missing)
    compare(frame, ref, "ten_models_port")
    theirs = scene_of(tj)
    frame_j = theirs.render()
    tid, st = ours.last_tid.numpy(), ours.last_stencil.numpy()
    tid_j, st_j = np.asarray(theirs.last_tid), np.asarray(theirs.last_stencil)
    assert (tid == tid_j).mean() >= 0.999
    assert (frame == frame_j).all(-1).mean() >= 0.999
    # Stencil: at near = 1e-4, XLA's fused multiply-adds move JAX's
    # linearized depth by up to ~2e-5 relative (measured: 0.00020181084
    # against 0.00020181542 at pixel (74, 43)), which flips that one
    # pixel's shadow test. Given JAX's own z-buffer, the port's stencil is
    # JAX's, inside the border where the overlay (debug camera = main
    # camera) writes its own depths.
    assert (st == st_j).mean() >= 0.9999
    cfg, dyn = ours._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    zb_j = torch.from_numpy(np.asarray(theirs.last_zbuf, np.float32))
    st_on_j = shadow_stencil(cfg, dyn, cam_m, zb_j * cfg.system).numpy()
    inner = np.s_[BORDER:-BORDER, BORDER:-BORDER]
    np.testing.assert_array_equal(st_on_j[inner], st_j[inner])
    assert (st_j[inner] != 0).any()


def test_dyn_from_numpy_carries_the_debug_camera():
    """The JAX package's prepared scene with a debug camera, carried by
    dyn_from_numpy, renders as the port's own packing does."""
    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax
    from tpu_renderer_torch.interop import dyn_from_numpy

    _, dyn_j = build_scene(tj, gz_jax,
                           debug_camera=tj.Camera(**DEBUG_CAM))._prepare()
    dyn = dyn_from_numpy(_np_tree(dyn_j), "cpu")
    assert dyn["debug_camera"]["near"].dtype == torch.float32
    assert dyn["debug_camera"]["position"].device.type == "cpu"
    cfg, own = build_scene(tt, gz_torch, device="cpu",
                           debug_camera=tt.Camera(**DEBUG_CAM))._prepare()
    assert cfg.has_debug_camera
    got = [a.numpy() for a in pl.render_frame(cfg, dyn)]
    want = [a.numpy() for a in pl.render_frame(cfg, own)]
    _hold((got[0], got[2], got[3]), (want[0], want[2], want[3]))


# ------------------------------------------------------------- sharded

RES_P = (64, 64)
MESHES = {2: (1, 2), 4: (2, 2)}
#: Seconds a spawn of ranks may take before they are killed.
DEADLINE = 120


def _rank(rank, world, out_dir):
    """One gloo rank: the debug-camera scene's sharded gouraud frame."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        mesh = tt.make_render_mesh(MESHES[world][1], "cpu")
        scene = build_scene(tt, gz_torch, resolution=RES_P, shader="gouraud",
                            device="cpu",
                            debug_camera=tt.Camera(**DEBUG_CAM))
        cfg, dyn = scene._prepare()
        out = [t.numpy() for t in tt.render_frame_sharded(cfg, dyn, mesh)]
        np.savez(f"{out_dir}/rank{rank}", *out)
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("world", list(MESHES))
def test_sharded_matches_one_device(tmp_path, world):
    ctx = mp.spawn(_rank, args=(world, str(tmp_path)), nprocs=world,
                   join=False)
    deadline = time.monotonic() + DEADLINE
    try:
        while not ctx.join(timeout=1):
            if time.monotonic() > deadline:
                pytest.fail(f"{world} gloo ranks still running after "
                            f"{DEADLINE} s")
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
    ranks = []
    for r in range(world):
        z = np.load(tmp_path / f"rank{r}.npz")
        ranks.append([z[f"arr_{i}"] for i in range(4)])
    for other in ranks[1:]:
        for a, b in zip(ranks[0], other):
            np.testing.assert_array_equal(a, b)
    scene = build_scene(tt, gz_torch, resolution=RES_P, shader="gouraud",
                        device="cpu", debug_camera=tt.Camera(**DEBUG_CAM))
    cfg, dyn = scene._prepare()
    frame, zbuf, tid, stencil = (a.numpy() for a in pl.render_frame(cfg, dyn))
    ids = one_device_ids(cfg, MESHES[world][1])
    got_tid = ranks[0][2]
    got_tid = np.where(got_tid >= 0, ids[np.maximum(got_tid, 0)], -1)
    _hold((ranks[0][0], got_tid, ranks[0][3]), (frame, tid, stencil))
    same = got_tid == tid
    np.testing.assert_allclose(ranks[0][1][same], zbuf[same], rtol=1e-6)
    plain = build_scene(tt, gz_torch, resolution=RES_P, shader="gouraud",
                        device="cpu")
    plain.render()
    assert (plain.last_tid.numpy() != tid).sum() > 100
