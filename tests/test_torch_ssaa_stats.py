"""The port's supersampling (``pipeline.render_ssaa``, ``Scene.supersample``)
and per-model statistics (``pipeline.face_statistics``, ``Scene.stats()``)
against the JAX package, on the CPU.

- ``render_ssaa`` as a module: the JAX package's scene packed at ss times
  its resolution (``_prepare(resolution=...)``), carried into the port
  (``interop.dyn_from_numpy``), against ``render_ssaa_jit``, ss in {2, 3};
- ``Scene(supersample=2)`` end to end under general, gouraud, pbr and
  general over a cubemap, against the JAX package's Scene;
- the wireframe and points shaders and the debug camera ignore ss with the
  JAX package's RuntimeWarning and render the ss = 1 frame;
- ``supersample`` set after construction takes effect;
- ``face_statistics`` on the JAX package's tid equals its counters
  exactly, with backface culling on and off;
- ``Scene.stats()`` against the JAX package's on the scene of
  tests/test_model_io.py:135, after a plain and an SSAA render, and
  before any render (RuntimeError).

Their card counterparts (the SSAA scene and ``stats()`` on the card
against the CPU) are in test_torch_kernels.py, the file the card's host,
which has no JAX, runs.

Bars, the North star's: tid >= 99.9% equal, stencil equal, frame >= 99.9%
identical pixels, and zbuf within rtol 1e-5 where tid agrees (XLA's CPU
backend contracts multiply-adds, the port rounds op by op). The box filter
averages ss² floats, whose order of summation may differ by an ulp, so the
SSAA frame is held to the same frame bar.

The stencil is held equal everywhere but at depth ties (``stencil_ties``):
pixels where a shadow quad that covers them has a depth plane within 1e-5
(relative) of the surface's depth. A silhouette quad starts on the
occluder's surface, so along its first edge the two depths are equal up to
rounding, and XLA's contracted multiply-adds decide that comparison the
other way from the port's op-by-op rounding. Found at ss = 3: one pixel of
73,728, whose depth test misses by 3.2e-6 of its terms in the port and
passes in both the JAX package's XLA and Pallas paths; the port's kernel
and plain versions agree there bit for bit. At most 0.1% of the pixels may
be ties. ``rendered`` counts the faces
that own a pixel of tid, so it may differ only by faces all of whose pixels
lie where the two tids differ; the other counters must be equal.
"""
import jax
import numpy as np
import pytest
import torch

import tpu_renderer as tj
import tpu_renderer_torch as tt
from tpu_renderer.models import gizmos as gz_jax
from tpu_renderer.ops import cubemap as cm_jax
from tpu_renderer.ops import pipeline as pl_jax
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import pipeline as pl_torch

from test_torch_kernels import (  # noqa: E402,F401
    RES, build_scene, one_torch_thread, sky_faces)

H, W = RES
COUNTERS = ("total", "rendered", "backface_culled", "degenerate",
            "offscreen", "occluded_or_clipped")


class ArrayCubeMap(cm_jax.CubeMap):
    """The JAX package's CubeMap over in-memory faces."""

    @staticmethod
    def load_texture(face):
        return face


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _as_np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def stencil_ties(cfg, dyn, zbuf, rtol=1e-5):
    """(H, W) bool: pixels where an active shadow quad of the port's
    packing covers the pixel (its edge minimum is above -rtol of its terms)
    and its depth test ``zb*q - sign*nf2`` is within rtol of
    ``|zb*q| + |nf2|``."""
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops import raster_plain as rp
    from tpu_renderer_torch.ops.shadow import QUAD_PMAX, quad_tables

    h, w = cfg.resolution
    cam_m = pl_torch._cam_matrices(cfg, dyn["camera"], "cpu")
    dyn = pl_torch.with_face_tables(cfg, dyn)
    verts = pl_torch.stacked_vertices(dyn)
    _, attrs = pl_torch._build_face_batch(cfg, dyn, cam_m, verts=verts)
    qdata, qi, _ = quad_tables(cfg, dyn, cam_m, h, w, verts=verts,
                               world=attrs["world"])
    nf2, fpn, fmn = rc.stencil_scalars(dyn["camera"]["near"],
                                       dyn["camera"]["far"])
    rows, cols = rp._grid(h, w, "cpu", 0)
    zb = torch.as_tensor(zbuf, dtype=torch.float32) * cfg.system
    ties = torch.zeros((h, w), dtype=torch.bool)
    for q, words in zip(qdata[qi[:, 5] > 0].double(),
                        qi[qi[:, 5] > 0]):
        terms = [(q[i] * cols, q[12 + i] * rows, q[24 + i])
                 for i in range(QUAD_PMAX)]
        covers = torch.stack([(a + b + k) + rtol * (a.abs() + b.abs()
                                                    + k.abs())
                              for a, b, k in terms]).amin(0) > 0
        qden = fpn - (q[36] * cols + q[37] * rows + q[38]) * fmn
        test = zb * qden - cfg.system * nf2
        near = test.abs() <= rtol * ((zb * qden).abs() + abs(float(nf2)))
        ties |= covers & near & (zb < 3e38)
    return ties.numpy()


def hold(port, ref, shape, cfg, dyn):
    """The North star's bars on (frame, zbuf, tid, stencil) 4-tuples, the
    stencil's outside the port's depth ties (``cfg``, ``dyn``: the port's
    packed scene at the buffers' size)."""
    frame_t, zb_t, tid_t, st_t = (_as_np(a) for a in port)
    frame_j, zb_j, tid_j, st_j = (_as_np(a) for a in ref)
    assert frame_t.shape == frame_j.shape == (*RES, 3)
    assert frame_t.dtype == np.uint8
    assert tid_t.shape == tid_j.shape == shape
    assert (tid_t == tid_j).mean() >= 0.999
    ties = stencil_ties(cfg, dyn, zb_t)
    assert ties.mean() <= 0.001
    np.testing.assert_array_equal(st_t[~ties], st_j[~ties])
    assert (frame_t == frame_j).all(-1).mean() >= 0.999
    same = (tid_t == tid_j) & np.isfinite(zb_j)
    np.testing.assert_allclose(zb_t[same], zb_j[same], rtol=1e-5)
    assert (tid_t >= 0).any() and (tid_t < 0).any()


# ------------------------------------------------------------ render_ssaa

@pytest.mark.parametrize("ss", [2, 3])
def test_render_ssaa_module_matches_jax(ss):
    scene_j = build_scene(tj, gz_jax)
    scene_t = build_scene(tt, gz_torch, device="cpu")
    scaled = (H * ss, W * ss)
    cfg_j, dyn_j = scene_j._prepare(resolution=scaled)
    want = _np(pl_jax.render_ssaa_jit(cfg_j, dyn_j, ss))
    cfg_t, _ = scene_t._prepare(resolution=scaled)
    assert cfg_t.resolution == scaled
    dyn_t = dyn_from_numpy(_np(dyn_j), "cpu")
    got = pl_torch.render_ssaa(cfg_t, dyn_t, ss)
    hold(got, want, scaled, cfg_t, dyn_t)
    # The box filter has something to average: edge pixels differ from the
    # frame at the native size.
    native = pl_torch.render_frame(*scene_t._prepare())[0].numpy()
    assert (got[0].numpy() != native).any()


SCENES = {
    "general": {},
    "gouraud": {"shader": "gouraud"},
    "pbr": {"shader": "pbr"},
    "general_cubemap": {"skymap": "cubemap"},
}


def _scene_pair(kw, **extra):
    kw = dict(kw, **extra)
    kw_j, kw_t = dict(kw), dict(kw)
    if kw.get("skymap") == "cubemap":
        kw_j["skymap"] = ArrayCubeMap(**sky_faces())
        kw_t["skymap"] = tt.CubeMap(**sky_faces())
    return (build_scene(tj, gz_jax, **kw_j),
            build_scene(tt, gz_torch, device="cpu", **kw_t))


@pytest.mark.parametrize("name", list(SCENES))
def test_scene_supersample_matches_jax(name):
    scene_j, scene_t = _scene_pair(SCENES[name], supersample=2)
    out_j = scene_j.render()
    out_t = scene_t.render()
    hold((out_t, scene_t.last_zbuf, scene_t.last_tid, scene_t.last_stencil),
         (out_j, scene_j.last_zbuf, scene_j.last_tid, scene_j.last_stencil),
         (2 * H, 2 * W), *scene_t._prepare(resolution=(2 * H, 2 * W)))


def test_supersample_adds_colors_and_is_read_at_render_time():
    """Set after construction, ``supersample`` takes effect at the next
    render; the box filter adds edge colours (tests/test_shaders.py:296)."""
    scene = build_scene(tt, gz_torch, device="cpu")
    frame1 = scene.render()
    assert tuple(scene.last_tid.shape) == RES
    scene.supersample = 2
    frame2 = scene.render()
    assert frame2.shape == frame1.shape
    assert tuple(scene.last_tid.shape) == (2 * H, 2 * W)
    u1 = len(np.unique(frame1.reshape(-1, 3), axis=0))
    u2 = len(np.unique(frame2.reshape(-1, 3), axis=0))
    assert u2 > u1
    scene.supersample = 1
    np.testing.assert_array_equal(scene.render(), frame1)


@pytest.mark.parametrize("case", ["wireframe", "points", "debug_camera"])
def test_supersample_warns_and_renders_native(case):
    """The JAX package's RuntimeWarnings (tests/test_shaders.py:310), and
    the frame of ss = 1."""
    def make(pkg, gizmos, **kw):
        shader = "general" if case == "debug_camera" else case
        scene = build_scene(pkg, gizmos, shader=shader, **kw)
        if case == "debug_camera":
            scene.debug_camera = pkg.Camera((2, 2.5, 4), center=(0, 0, 0),
                                            fovy=60, near=0.01, far=50)
        return scene

    match = "debug-camera" if case == "debug_camera" else "supersample"
    scene_t = make(tt, gz_torch, device="cpu")
    want = scene_t.render()
    scene_t.supersample = 2
    with pytest.warns(RuntimeWarning, match=match) as rec_t:
        got = scene_t.render()
    np.testing.assert_array_equal(got, want)
    assert tuple(scene_t.last_tid.shape) == RES
    scene_j = make(tj, gz_jax)
    scene_j.supersample = 2
    with pytest.warns(RuntimeWarning, match=match) as rec_j:
        scene_j.render()
    assert ([str(w.message) for w in rec_t if w.category is RuntimeWarning]
            == [str(w.message) for w in rec_j
                if w.category is RuntimeWarning])


# --------------------------------------------------------------- statistics

def _stats_np(stats):
    return [{k: int(s[k]) for k in COUNTERS} for s in stats]


@pytest.mark.parametrize("culling", [True, False])
def test_face_statistics_on_jax_tid_match(culling):
    scene_j = build_scene(tj, gz_jax)
    scene_t = build_scene(tt, gz_torch, device="cpu")
    scene_j.camera.backface_culling = culling
    scene_t.camera.backface_culling = culling
    cfg_j, dyn_j = scene_j._prepare()
    tid_j = np.array(pl_jax.render_frame_jit(cfg_j, dyn_j)[2])
    cfg_t, dyn_t = scene_t._prepare()
    assert cfg_t.backface_culling is culling
    want = _stats_np(pl_jax.face_statistics(cfg_j, dyn_j, tid_j))
    got = pl_torch.face_statistics(cfg_t, dyn_t, torch.from_numpy(tid_j))
    assert all(v.dtype == torch.int64 and v.dim() == 0
               for s in got for v in s.values())
    assert _stats_np(got) == want
    assert sum(s["backface_culled"] for s in want) > (0 if culling else -1)
    assert all(s["rendered"] > 0 for s in want)


def stats_scene(pkg, **kw):
    """The scene of tests/test_model_io.py:135."""
    gizmos = gz_jax if pkg is tj else gz_torch
    scene = pkg.Scene(pkg.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60,
                                 near=0.01, far=50, backface_culling=True),
                      pkg.Light((3, 4, 2)), resolution=(64, 64),
                      system=pkg.SYSTEM.RH, subsystem=pkg.SUBSYSTEM.OPENGL,
                      **kw)
    scene.add_model(gizmos.make_cube(1.0))
    scene.add_model(gizmos.make_floor(2.0, y=-0.6))
    return scene


def hold_stats(scene_t, scene_j):
    """Equal counters, but for ``rendered``: a face may render in one
    package and not the other only if every pixel it owns in either tid is
    one where the tids differ."""
    st_t, st_j = scene_t.stats(), scene_j.stats()
    tid_t = scene_t.last_tid.numpy()
    tid_j = np.asarray(scene_j.last_tid)
    assert tid_t.shape == tid_j.shape
    assert (tid_t == tid_j).mean() >= 0.999
    differ = tid_t != tid_j
    faces_t, faces_j = set(np.unique(tid_t)) - {-1}, set(np.unique(tid_j)) - {-1}
    for f in faces_t ^ faces_j:
        assert differ[(tid_t == f) | (tid_j == f)].all(), f
    assert len(st_t) == len(st_j) == 2
    bounds = np.cumsum([0] + [m.num_faces for m in scene_t.models])
    padded = np.cumsum([0] + [-(-m.num_faces // 8) * 8
                              for m in scene_t.models])
    for i, (a, b) in enumerate(zip(st_t, st_j)):
        for k in ("total", "backface_culled", "degenerate", "offscreen"):
            assert a[k] == b[k], (i, k)
        in_model = lambda fs: sum(padded[i] <= f < padded[i + 1] for f in fs)
        assert a["rendered"] == in_model(faces_t)
        assert b["rendered"] == in_model(faces_j)
        assert a["total"] == bounds[i + 1] - bounds[i]
        assert set(a) == set(b)
        assert ({k.value: v for k, v in a["by_error"].items()}
                == {k.value: v for k, v in b["by_error"].items()})
        assert (a["rendered"] + a["backface_culled"] + a["degenerate"]
                + a["offscreen"] + a["occluded_or_clipped"]) >= a["total"] - 1
    return st_t


def test_scene_stats_match_jax():
    scene_t, scene_j = stats_scene(tt, device="cpu"), stats_scene(tj)
    scene_t.render()
    scene_j.render()
    st = hold_stats(scene_t, scene_j)
    assert st[0]["total"] == 12 and st[1]["total"] == 2
    assert 3 <= st[0]["backface_culled"] <= 9
    assert st[0]["rendered"] >= 1 and st[1]["rendered"] >= 1
    assert all(isinstance(v, int) for s in st for k, v in s.items()
               if k != "by_error")


def test_scene_stats_after_ssaa_match_jax():
    """After a supersampled render both packages count ``rendered`` on the
    scaled tid and the rest at the native resolution."""
    scene_t = stats_scene(tt, device="cpu", supersample=2)
    scene_j = stats_scene(tj, supersample=2)
    scene_t.render()
    scene_j.render()
    assert tuple(scene_t.last_tid.shape) == (128, 128)
    hold_stats(scene_t, scene_j)


def test_stats_before_render_raises():
    with pytest.raises(RuntimeError, match="render"):
        stats_scene(tt, device="cpu").stats()
