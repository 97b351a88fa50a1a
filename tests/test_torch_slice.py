"""The PyTorch port's main path against the JAX package, end to end.

One textured, normal-mapped, shadowed cube-over-floor scene (the
tests/test_pallas_interpret.py:17-32 scene, with in-memory textures and an
LH/OpenGL camera) is built in both packages from the same seeded numpy
arrays. The port renders it on the CPU, through its kernels' plain versions,
twice: from its own Scene packing and from the JAX package's packed scene
(interop.dyn_from_numpy). Each 4-tuple (frame_u8, zbuf, tid, stencil) is
held to the bars the JAX package holds its Pallas path to against its XLA
path (test_pallas_interpret.py:46-49): tid >= 99.9% equal, stencil equal,
frame >= 99.9% identical pixels.

The JAX package's split pipeline (visibility first, then phase1_keep's
prune, then the G-buffer against tid_in) renders a scene past its split
gate; the port, which always resolves visibility before its G-buffer
kernels read each pixel's winner, must match it at the same bars.
"""
import dataclasses

import jax
import numpy as np
import pytest
import torch

import tpu_renderer as tj
import tpu_renderer_torch as tt
from tpu_renderer.models import gizmos as gz_jax
from tpu_renderer.ops.pipeline import render_frame_jit
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops.pipeline import render_frame

from test_torch_kernels import (  # noqa: E402,F401
    RES, build_scene, one_torch_thread)


@pytest.fixture(scope="module")
def jax_scene():
    return build_scene(tj, gz_jax)


@pytest.fixture(scope="module")
def torch_scene():
    return build_scene(tt, gz_torch, device="cpu")


@pytest.fixture(scope="module")
def jax_outputs(jax_scene):
    cfg, dyn = jax_scene._prepare()
    xla = render_frame_jit(cfg, dyn)
    cfg_p = dataclasses.replace(cfg, backend="pallas", pallas_interpret=True)
    pallas = render_frame_jit(cfg_p, dyn)
    return {"xla": [np.asarray(a) for a in xla],
            "pallas": [np.asarray(a) for a in pallas]}


@pytest.fixture(scope="module")
def torch_outputs(jax_scene, torch_scene):
    cfg, dyn = torch_scene._prepare()
    own = render_frame(cfg, dyn)
    _, dyn_j = jax_scene._prepare()
    dyn_np = jax.tree_util.tree_map(np.asarray, dyn_j)
    via_jax = render_frame(cfg, dyn_from_numpy(dyn_np, "cpu"))
    return {"own": [a.numpy() for a in own],
            "interop": [a.numpy() for a in via_jax]}


@pytest.mark.parametrize("backend", ["xla", "pallas"])
@pytest.mark.parametrize("packing", ["own", "interop"])
def test_slice_matches_jax(jax_outputs, torch_outputs, backend, packing):
    frame_j, zb_j, tid_j, st_j = jax_outputs[backend]
    frame_t, zb_t, tid_t, st_t = torch_outputs[packing]
    assert frame_t.shape == frame_j.shape == (*RES, 3)
    assert frame_t.dtype == np.uint8
    assert (tid_t == tid_j).mean() >= 0.999
    np.testing.assert_array_equal(st_t, st_j)
    assert (frame_t == frame_j).all(axis=-1).mean() >= 0.999
    # Background (z = ±inf) agrees wherever tid does; the scene has
    # foreground and shadow.
    assert (np.isinf(zb_t) == np.isinf(zb_j)).mean() >= 0.999
    assert (tid_t >= 0).any() and (st_t != 0).any()


def _split_scene(pkg, gizmos, **kw):
    """Two overlapping spheres over a floor with a seeded in-memory diffuse
    map, backface culling off: about 600 faces, several FACE_CHUNKs of 128.
    The tests/test_split_pipeline.py scene with a 1.5 floor instead of 3.0:
    that floor crosses the frame's first row, where pixel centres lie on
    the frustum's bottom plane and the per-pixel clip test compares a value
    of about 0, whose sign XLA's fused multiply-adds flip on a row segment
    (ROADMAP watch list)."""
    s1 = gizmos.make_sphere(10, 14)
    s1.shadowing = True
    s2 = (gizmos.make_sphere(10, 14) @ pkg.scale(0.9)
          @ pkg.translation([0.3, 0.1, -0.8]))
    floor = gizmos.make_floor(1.5, y=-1.1)
    rng = np.random.default_rng(7)
    floor.materials["default"].map_Kd = (
        np.round(rng.random((32, 32, 3)) * 255) / 255).astype(np.float32)
    scene = pkg.Scene(
        pkg.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60, near=0.01, far=50,
                   backface_culling=False),
        pkg.Light((3, 4, 2), light_type=pkg.Lightning.POINT_LIGHTNING,
                  ambient_strength=0.1),
        shadows=True, resolution=(64, 128), system=pkg.SYSTEM.RH,
        subsystem=pkg.SUBSYSTEM.OPENGL, **kw)
    for m in (s1, s2, floor):
        scene.add_model(m)
    return scene


def test_split_pipeline_matches_port(monkeypatch):
    """JAX's split pipeline (FACE_CHUNK 128, culling off: past the default
    gate of pipeline._split_use; TPU_RENDERER_SPLIT=2 forces it) against
    the port's one-device render of the same scene, at the bars above."""
    from tpu_renderer.ops import pipeline as pl_jax
    from tpu_renderer.ops import raster_pallas as rp

    monkeypatch.setattr(rp, "FACE_CHUNK", 128)
    monkeypatch.setenv("TPU_RENDERER_SPLIT", "2")
    cfg, dyn = _split_scene(tj, gz_jax)._prepare()
    n_faces = sum(mc.num_faces for mc in cfg.models)
    assert pl_jax._split_use(cfg, {"sx": np.zeros(n_faces)}, "1")
    cfg = dataclasses.replace(cfg, backend="pallas", pallas_interpret=True,
                              tex_kernel=True)
    frame_j, _, tid_j, st_j = (np.asarray(a)
                               for a in pl_jax.render_frame(cfg, dyn))
    cfg_t, dyn_t = _split_scene(tt, gz_torch, device="cpu")._prepare()
    frame_t, _, tid_t, st_t = (a.numpy() for a in render_frame(cfg_t, dyn_t))
    assert (tid_t == tid_j).mean() >= 0.999
    np.testing.assert_array_equal(st_t, st_j)
    assert (frame_t == frame_j).all(axis=-1).mean() >= 0.999
    assert (tid_t >= 0).mean() > 0.05 and (st_t != 0).any()


def test_scene_render_returns_frame(torch_scene, torch_outputs):
    """Scene.render() is render_frame's frame, on the host as numpy, with
    the buffers kept as tensors on the scene's device."""
    frame = torch_scene.render()
    np.testing.assert_array_equal(frame, torch_outputs["own"][0])
    assert isinstance(torch_scene.last_tid, torch.Tensor)
    assert torch_scene.last_tid.device.type == "cpu"
