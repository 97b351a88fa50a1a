"""The port's flat, gouraud, pbr, wireframe and points shaders against the
JAX package.

End to end: the cube-over-floor scene of test_torch_kernels.build_scene is
built in both packages with each shader and rendered on the CPU. The port
renders from its own packing and from the JAX package's packed scene
(interop.dyn_from_numpy). flat/gouraud/pbr are held to render_frame_jit on
XLA and in Pallas interpret mode (its slim G-buffer kernel); wireframe and
points to render_debug_frame (lines_pallas in interpret mode). Bars: tid
>= 99.9% equal, stencil equal, frame >= 99.9% identical pixels — the bars
the JAX package holds its Pallas path to (test_pallas_interpret.py:46-49).

Module by module, from seeded numpy inputs or the JAX package's own
per-face tensors: the shading functions, pack_slim_attrs, pack_lines, K5's
plain version against gbuffer_pallas on the same tid, and K6's plain
version against lines_pallas.

Tolerances and why: XLA's CPU backend contracts a*b + c into fused
multiply-adds and evaluates powers and norms in its own way, while the port
rounds op by op (test_torch_modules.py), so float outputs agree to a few
ulps: rtol 1e-5 for the shaders, 1e-5 of each channel's magnitude for the
slim G-buffer. Packers that only subtract, divide, floor and clip agree
exactly, and so do K6's mask and the debug frames' drawn pixels (the
line and point colours), which the frame-level bar is too loose to hold.
tid and frames are held to the 99.9% bars.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import tpu_renderer as tj
import tpu_renderer_torch as tt
from tpu_renderer.models import gizmos as gz_jax
from tpu_renderer.ops import pipeline as pl_jax
from tpu_renderer.ops import raster_pallas as rp_jax
from tpu_renderer.ops import shading as sh_jax
from tpu_renderer.ops.pipeline import render_debug_frame, render_frame_jit
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import pipeline as pl_torch
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import shading as sh_torch

from test_torch_kernels import (  # noqa: E402,F401
    RES, build_scene, one_torch_thread)

H, W = RES
SLIM = ["flat", "gouraud", "pbr"]
DEBUG = ["wireframe", "points"]
#: Fewest drawn pixels a debug frame of the test scene must show for its
#: overlay comparison to mean something (the scene lights 187 line pixels
#: and 8 points).
MIN_DRAWN = {"wireframe": 100, "points": 5}

_renders = {}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def renders(shader):
    """{"xla"/"pallas"/"jax": JAX outputs, "own"/"interop": port outputs},
    each a list (frame_u8, zbuf, tid, stencil) of numpy arrays; rendered
    once per shader."""
    if shader not in _renders:
        scene_j = build_scene(tj, gz_jax, shader=shader)
        scene_t = build_scene(tt, gz_torch, shader=shader, device="cpu")
        cfg, dyn = scene_j._prepare()
        out = {}
        if shader in DEBUG:
            out["jax"] = _np(render_debug_frame(cfg, dyn, shader))
            draw = lambda c, d: pl_torch.render_debug_frame(c, d, shader)
        else:
            out["xla"] = _np(render_frame_jit(cfg, dyn))
            out["pallas"] = _np(render_frame_jit(dataclasses.replace(
                cfg, backend="pallas", pallas_interpret=True), dyn))
            draw = pl_torch.render_frame
        cfg_t, dyn_t = scene_t._prepare()
        out["own"] = [a.numpy() for a in draw(cfg_t, dyn_t)]
        out["interop"] = [a.numpy() for a in draw(
            cfg_t, dyn_from_numpy(_np(dyn), "cpu"))]
        _renders[shader] = out
    return _renders[shader]


def _hold(port, ref):
    frame_t, zb_t, tid_t, st_t = port
    frame_j, zb_j, tid_j, st_j = ref
    assert frame_t.shape == frame_j.shape == (*RES, 3)
    assert frame_t.dtype == np.uint8
    assert (tid_t == tid_j).mean() >= 0.999
    np.testing.assert_array_equal(st_t, st_j)
    assert (frame_t == frame_j).all(axis=-1).mean() >= 0.999
    assert (np.isinf(zb_t) == np.isinf(zb_j)).mean() >= 0.999
    assert (tid_t >= 0).any()


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("packing", ["own", "interop"])
@pytest.mark.parametrize("shader", SLIM)
def test_slim_shader_matches_jax(shader, packing, backend):
    out = renders(shader)
    _hold(out[packing], out[backend])
    # The slim shaders write foreground that differs from the background.
    frame, _, tid, _ = out[packing]
    assert (frame[::-1][tid >= 0] != frame[::-1][tid < 0][0]).any()


@pytest.mark.parametrize("packing", ["own", "interop"])
@pytest.mark.parametrize("shader", DEBUG)
def test_debug_shader_matches_jax(shader, packing):
    """render_debug_frame of both packages. The frame-level 99.9% bar would
    let a sparse overlay go wrong, so the drawn pixels (line colour, or the
    points' red and blue) are held on their own: at least MIN_DRAWN of them,
    and the same set in both packages. JAX's points scatter sends culled and
    off-frame writes to index -1, which its scatter normalizes to the last
    pixel instead of dropping (ROADMAP §C); the port drops them, so that one
    pixel (the flipped frame's top right) is left out of the comparison."""
    out = renders(shader)
    _hold(out[packing], out["jax"])
    drawn = {"wireframe": [[64, 64, 128]],
             "points": [[255, 0, 0], [0, 0, 255]]}[shader]

    def drawn_mask(frame):
        mask = np.zeros(frame.shape[:2], bool)
        for rgb in drawn:
            gamma = (np.clip((np.asarray(rgb) / 255.0) ** 0.8, 0, 1) * 255
                     ).astype(np.uint8)
            mask |= (frame == gamma).all(-1)
        mask[0, -1] = False
        return mask

    got, want = drawn_mask(out[packing][0]), drawn_mask(out["jax"][0])
    assert want.sum() >= MIN_DRAWN[shader]
    np.testing.assert_array_equal(got, want)


# ------------------------------------------------------------- modules

def _seeded_pixels(seed=0, shape=(16, 24)):
    rng = np.random.default_rng(seed)
    f32 = lambda a: np.asarray(a, np.float32)
    unit = lambda a: f32(a / np.linalg.norm(a, axis=-1, keepdims=True))
    return {
        "n": unit(rng.normal(size=shape + (3,))),
        "n_raw": f32(rng.normal(size=shape + (3,))),
        "screen_pos": f32(rng.uniform(0, 64, shape + (3,))),
        "metallic": f32(rng.uniform(0, 1, shape + (1,))),
        "roughness": f32(rng.uniform(0.05, 1, shape)),
        "ao": f32(rng.uniform(0, 0.5, shape + (3,))),
        "bar": f32(rng.dirichlet([1, 1, 1], shape)),
        "vn": unit(rng.normal(size=shape + (3, 3))),
        "cos": f32(rng.uniform(0, 1, shape)),
    }


def _lights():
    pos = np.asarray([30.0, 40.0, 20.0], np.float32)
    center = np.asarray([0.0, 0.5, 0.5], np.float32)
    d = (pos - center) / np.linalg.norm(pos - center)
    base = {"position": pos, "center": center,
            "color": np.asarray([1.0, 0.9, 0.8], np.float32),
            "direction": np.asarray(d, np.float32)}
    return ({k: jnp.asarray(v) for k, v in base.items()},
            {k: torch.from_numpy(v) for k, v in base.items()})


def _close(got, want):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=1e-5,
                               atol=1e-6)


def test_flat_and_gouraud_match():
    p = _seeded_pixels(1)
    lj, lt = _lights()
    t = lambda k: torch.from_numpy(p[k])
    _close(sh_torch.shade_flat(t("n"), lt), sh_jax.shade_flat(p["n"], lj))
    _close(sh_torch.shade_gouraud_n(t("n_raw"), lt),
           sh_jax.shade_gouraud_n(p["n_raw"], lj))
    _close(sh_torch.shade_gouraud(t("bar"), t("vn"), lt),
           sh_jax.shade_gouraud(p["bar"], p["vn"], lj))


def test_ggx_helpers_match():
    p = _seeded_pixels(2)
    t = lambda k: torch.from_numpy(p[k])
    n2 = _seeded_pixels(3)["n"]
    f0 = np.full(p["n"].shape, 0.04, np.float32)
    _close(sh_torch.mix(torch.from_numpy(f0), 1.0, t("metallic")),
           sh_jax.mix(f0, 1.0, p["metallic"]))
    _close(sh_torch.fresnel_schlick(t("cos"), torch.from_numpy(f0)),
           sh_jax.fresnel_schlick(p["cos"], f0))
    _close(sh_torch.distribution_ggx(t("n"), torch.from_numpy(n2),
                                     t("roughness")),
           sh_jax.distribution_ggx(p["n"], n2, p["roughness"]))
    _close(sh_torch.geometry_schlick_ggx(t("cos"), t("roughness")),
           sh_jax.geometry_schlick_ggx(p["cos"], p["roughness"]))
    v, l_ = _seeded_pixels(4)["n"], _seeded_pixels(5)["n"]
    _close(sh_torch.geometry_smith(t("n"), torch.from_numpy(v),
                                   torch.from_numpy(l_), t("roughness")),
           sh_jax.geometry_smith(p["n"], v, l_, p["roughness"]))


def test_shade_pbr_matches():
    p = _seeded_pixels(6)
    lj, lt = _lights()
    cam = np.asarray([32.0, 20.0, -5.0], np.float32)
    keys = {"normal_raw": "n", "screen_pos": "screen_pos",
            "metallic": "metallic", "roughness": "roughness", "ao": "ao"}
    got = sh_torch.shade_pbr({k: torch.from_numpy(p[v])
                              for k, v in keys.items()}, lt,
                             torch.from_numpy(cam))
    want = sh_jax.shade_pbr({k: p[v] for k, v in keys.items()}, lj, cam)
    assert got.shape == (16, 24, 3)
    _close(got, want)


@pytest.fixture(scope="module")
def jax_faces():
    """The JAX package's per-face tensors of the pbr scene (its attrs carry
    every slim layout's columns) and its final z-buffer."""
    scene = build_scene(tj, gz_jax, shader="pbr")
    cfg, dyn = scene._prepare()
    cam_m = pl_jax._cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    faces, attrs = jax.jit(
        lambda d, c: pl_jax._build_face_batch(cfg, d, c, None))(dyn, cam_m)
    _, zbuf, tid, _ = render_frame_jit(cfg, dyn)
    return cfg, _np(faces), _np(attrs), np.array(zbuf), np.array(tid)


def _t(tree):
    return {k: torch.from_numpy(np.array(v)) for k, v in tree.items()}


@pytest.mark.parametrize("layout", SLIM)
def test_pack_slim_attrs_matches(jax_faces, layout):
    _, _, attrs, _, _ = jax_faces
    want = np.asarray(rp_jax.pack_slim_attrs(attrs, layout))
    got = rc.pack_slim_attrs(_t(attrs), layout).numpy()
    assert got.shape == (want.shape[0], rc.SLIM_COLS[layout])
    np.testing.assert_array_equal(got, want)


def test_pack_lines_matches():
    """Seeded endpoints, with zero-length, sub-pixel, vertical, off-frame
    and non-finite edges among them: ldata and bbox agree bit for bit."""
    rng = np.random.default_rng(7)
    p0 = rng.uniform(-20, 150, (200, 3)).astype(np.float32)
    p1 = rng.uniform(-20, 150, (200, 3)).astype(np.float32)
    p1[:10] = p0[:10]                                  # zero length
    p1[10:20] = p0[10:20] + 0.4                        # sub-pixel
    p1[20:30, 0] = p0[20:30, 0]                        # vertical
    p0[30:35, 0] = np.inf
    p0[35:40, 1] = np.nan
    ld_j, bb_j, _ = rp_jax.pack_lines(jnp.asarray(p0), jnp.asarray(p1), H, W)
    ld_t, bb_t = rc.pack_lines(torch.from_numpy(p0), torch.from_numpy(p1),
                               H, W)
    np.testing.assert_array_equal(ld_t.numpy(),
                                  np.asarray(ld_j)[:, :rc.L_COLS])
    np.testing.assert_array_equal(bb_t.numpy(), np.asarray(bb_j))


@pytest.mark.parametrize("layout", SLIM)
def test_k5_gbuffer_slim_matches_pallas(jax_faces, layout):
    """K5's plain version against gbuffer_pallas (interpret mode) on the
    same tid and per-face tensors."""
    cfg, faces, attrs, _, tid = jax_faces
    want = np.asarray(rp_jax.gbuffer_pallas(
        faces, attrs, jnp.asarray(tid), H, W, interpret=True,
        gb_layout=layout))
    ft, at = _t(faces), _t(attrs)
    got = rc.gbuffer_slim(rc.pack_faces(ft), rc.pack_slim_attrs(at, layout),
                          torch.from_numpy(tid), layout).numpy()
    assert got.shape == want.shape == (rc.SLIM_CHANNELS[layout], H, W)
    win = tid >= 0
    assert win.any()
    for ch in range(got.shape[0]):
        scale = max(float(np.abs(want[ch]).max()), 1.0)
        np.testing.assert_allclose(got[ch][win], want[ch][win], rtol=1e-5,
                                   atol=1e-5 * scale, err_msg=f"channel {ch}")
    np.testing.assert_array_equal(got[:, ~win], 0.0)


def test_k6_lines_matches_pallas(jax_faces):
    """K6's plain version against lines_pallas (interpret mode) on the
    scene's wireframe edges and the JAX render's z-buffer: the same lit
    pixels exactly, of at least MIN_DRAWN["wireframe"]."""
    cfg, faces, attrs, zbuf, _ = jax_faces
    sx, sy, sz = attrs["sx"], attrs["sy"], attrs["szlin"]
    ia, ib = [0, 1, 2], [1, 2, 0]
    p0 = np.stack([sx[:, ia], sy[:, ia], sz[:, ia]], -1).reshape(-1, 3)
    p1 = np.stack([sx[:, ib], sy[:, ib], sz[:, ib]], -1).reshape(-1, 3)
    active = np.ones(len(p0), bool)
    ld_j, bb_j, coeffs = rp_jax.pack_lines(jnp.asarray(p0), jnp.asarray(p1),
                                           H, W)
    want = np.asarray(rp_jax.lines_pallas(ld_j, bb_j, jnp.asarray(active),
                                          coeffs, jnp.asarray(zbuf), H, W,
                                          interpret=True))
    ld_t, bb_t = rc.pack_lines(torch.from_numpy(p0), torch.from_numpy(p1),
                               H, W)
    got = rc.lines(ld_t, bb_t, torch.from_numpy(active),
                   torch.from_numpy(zbuf), H, W).numpy()
    assert want.sum() >= MIN_DRAWN["wireframe"]
    np.testing.assert_array_equal(got, want)
