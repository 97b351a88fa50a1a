"""The port's cubemap skybox (ops/cubemap.py) against the JAX package.

The six faces are seeded, 8-bit-quantized numpy arrays. The JAX package's
CubeMap reads image files, so the test builds it through a subclass whose
load_texture returns the array it is given; nothing in tpu_renderer
changes.

- CubeMap assembly (orientation fixups, packed texels), cubemap_index and
  both samplers agree exactly on seeded directions, ties and axis-aligned
  rays included;
- fill_frame_from_skybox agrees on >= 99.9% of the pixels: the port inverts
  the 4x4 view-projection with torch.linalg.inv on the host, XLA with its
  own LU, and the two differ by ulps, which can move a ray across a texel
  or face seam at a handful of pixels;
- a render over the cubemap (general, pbr and wireframe shaders, from the
  port's own packing and through interop.dyn_from_numpy) holds the JAX
  package's bars: tid >= 99.9% equal, stencil equal, frame >= 99.9%.
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
from tpu_renderer.ops import cubemap as cm_jax
from tpu_renderer.ops import pipeline as pl_jax
from tpu_renderer.ops.pipeline import render_debug_frame, render_frame_jit
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import cubemap as cm_torch
from tpu_renderer_torch.ops import pipeline as pl_torch

from test_torch_kernels import (  # noqa: E402,F401
    RES, build_scene, one_torch_thread)

SIDES = ("left", "right", "top", "bottom", "front", "back")


class ArrayCubeMap(cm_jax.CubeMap):
    """The JAX package's CubeMap over in-memory faces."""

    @staticmethod
    def load_texture(face):
        return face


def faces(seed=0, t=16):
    rng = np.random.default_rng(seed)
    return {s: (np.round(rng.random((t, t, 3)) * 255) / 255).astype(np.float32)
            for s in SIDES}


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


@pytest.mark.parametrize("normalize_input", [True, False])
def test_cubemap_textures_match(normalize_input):
    f = faces()
    cj = ArrayCubeMap(**f, normalize_input=normalize_input)
    ct = tt.CubeMap(**f, normalize_input=normalize_input)
    np.testing.assert_array_equal(ct.textures, cj.textures)
    arrays = ct.as_device_arrays("cpu")
    assert arrays["packed"].dtype == torch.int32
    np.testing.assert_array_equal(
        arrays["packed"].numpy(),
        np.asarray(cj.as_device_arrays()["packed"]).view(np.int32))
    assert ct.as_device_arrays("cpu") is arrays          # uploaded once


def directions(seed=1, n=4096):
    rng = np.random.default_rng(seed)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d[:64] = np.round(d[:64])                            # ties and zeros
    d[64:70] = np.concatenate([np.eye(3), -np.eye(3)]) * 2  # axis rays
    d[70] = [1, 1, 1]
    d[71] = [-1, 1, -1]
    return d


def test_cubemap_index_matches():
    d = directions()
    nonzero = np.abs(d).max(-1) > 0       # a zero ray has no face (NaN u/v)
    for t in (1, 7, 16):
        want = [np.asarray(a) for a in cm_jax.cubemap_index(t, jnp.asarray(d))]
        got = [a.numpy() for a in cm_torch.cubemap_index(t, torch.from_numpy(d))]
        for g, w, name in zip(got, want, ("side", "iu", "iv")):
            np.testing.assert_array_equal(g[nonzero], w[nonzero], err_msg=name)
        assert set(np.unique(got[0])) == set(range(6))


def test_sample_cubemap_matches():
    cj, ct = ArrayCubeMap(**faces()), tt.CubeMap(**faces())
    d = directions(2)
    d = d[np.abs(d).max(-1) > 0]
    np.testing.assert_array_equal(ct[d], cj[d])
    want = np.asarray(cm_jax.sample_cubemap_packed(
        cj.as_device_arrays()["packed"], jnp.asarray(d)))
    got = cm_torch.sample_cubemap_packed(ct.as_device_arrays("cpu")["packed"],
                                         torch.from_numpy(d)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def skybox_scenes():
    f = faces(3)
    return {"jax": lambda shader: build_scene(
                tj, gz_jax, shader=shader, skymap=ArrayCubeMap(**f)),
            "torch": lambda shader: build_scene(
                tt, gz_torch, shader=shader, skymap=tt.CubeMap(**f),
                device="cpu")}


def test_fill_frame_from_skybox_matches(skybox_scenes):
    scene_j = skybox_scenes["jax"]("general")
    scene_t = skybox_scenes["torch"]("general")
    cfg, dyn = scene_j._prepare()
    cam_m = pl_jax._cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    want = np.asarray(cm_jax.fill_frame_from_skybox(dyn["skybox"], cam_m, RES))
    cfg_t, dyn_t = scene_t._prepare()
    cam_host = pl_torch._cam_matrices(cfg_t, dyn_t["camera"], "cpu")
    got = cm_torch.fill_frame_from_skybox(dyn_t["skybox"], cam_host, RES,
                                          "cpu").numpy()
    assert got.shape == want.shape == (*RES, 3)
    assert (got == want).all(-1).mean() >= 0.999
    assert len(np.unique(got.reshape(-1, 3), axis=0)) > 16


_renders = {}


def renders(skybox_scenes, shader, backend):
    """JAX's render on ``backend`` and the port's from both packings, each
    (frame_u8, zbuf, tid, stencil) as numpy; cached per shader/backend."""
    scene_j = skybox_scenes["jax"](shader)
    cfg, dyn = scene_j._prepare()
    if (shader, backend) not in _renders:
        if shader == "wireframe":
            out = render_debug_frame(cfg, dyn, shader)
        else:
            out = render_frame_jit(dataclasses.replace(
                cfg, backend=backend, pallas_interpret=backend == "pallas"),
                dyn)
        _renders[shader, backend] = _np(out)
    if (shader, "port") not in _renders:
        if shader == "wireframe":
            draw = lambda c, d: pl_torch.render_debug_frame(c, d, shader)
        else:
            draw = pl_torch.render_frame
        cfg_t, dyn_t = skybox_scenes["torch"](shader)._prepare()
        assert cfg_t.background == "cubemap"
        _renders[shader, "port"] = {
            "own": [a.numpy() for a in draw(cfg_t, dyn_t)],
            "interop": [a.numpy() for a in draw(
                cfg_t, dyn_from_numpy(_np(dyn), "cpu"))]}
    return _renders[shader, backend], _renders[shader, "port"]


@pytest.mark.parametrize("packing", ["own", "interop"])
@pytest.mark.parametrize("shader,backend", [
    ("general", "xla"), ("general", "pallas"), ("pbr", "pallas"),
    ("wireframe", "xla")])
def test_render_over_cubemap_matches_jax(skybox_scenes, shader, backend,
                                         packing):
    ref, port = renders(skybox_scenes, shader, backend)
    frame_t, zb_t, tid_t, st_t = port[packing]
    frame_j, zb_j, tid_j, st_j = ref
    assert frame_t.shape == (*RES, 3) and frame_t.dtype == np.uint8
    assert (tid_t == tid_j).mean() >= 0.999
    np.testing.assert_array_equal(st_t, st_j)
    assert (frame_t == frame_j).all(-1).mean() >= 0.999
    # The skybox shows where no face won: many distinct background colors.
    bg = frame_t[::-1][tid_t < 0]
    assert len(np.unique(bg, axis=0)) > 16
