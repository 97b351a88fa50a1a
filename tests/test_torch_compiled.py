"""The compiled frame (ops/compiled.py and the ``*_jit`` entry points of
ops/pipeline.py) on the CPU, where a program runs its staged body eagerly
over its static buffers through the kernels' plain versions.

- On the test_torch_kernels scene, for general, flat, gouraud, pbr,
  wireframe, points, general over a cubemap, ss = 2 and the debug
  camera's ``render_core``: the staged body, through the eager entry
  points and through the compiled ones, gives the four outputs of the
  eager path before the frame was staged, bit for bit (``PRE_STAGING``:
  SHA-256 digests of that path's outputs on this scene, one torch thread),
  and the compiled outputs equal the eager ones (``torch.equal``).
- ``render_frame_jit``, ``render_ssaa_jit``, ``render_core_jit``,
  ``render_debug_frame_jit`` and ``face_statistics_jit`` against the JAX
  package's ``render_frame_jit``, ``render_ssaa_jit``, ``render_core_jit``
  and jitted ``render_debug_frame`` and ``face_statistics``, at the North
  star's bars: tid >= 99.9% equal, stencil equal, frame >= 99.9%
  identical pixels; the face counters exactly.
- The counterpart of tests/test_model_io.py's
  ``test_animated_vertices_no_recompile``: over an orbit that moves the
  camera and the light, then new vertex positions and a new texture of the
  same shape, one program serves every frame (one build), and each frame
  equals the eager frame of the same inputs; a new resolution or shader
  builds a new program.
- The cache drops its least recently used program past its bound, and
  ``clear_compiled()`` empties it.

Their card counterparts (replay against eager with ``torch.equal``, launch
counts per replay, K4's pointer constants) are in test_torch_kernels.py.
"""
import hashlib

import jax
import numpy as np
import pytest
import torch

import tpu_renderer as tj
import tpu_renderer_torch as tt
from tpu_renderer.models import gizmos as gz_jax
from tpu_renderer.ops import pipeline as pl_jax
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import pipeline as pl

from test_torch_kernels import (  # noqa: E402,F401
    PATHS, RES, eager_outputs, jit_outputs, one_torch_thread, path_scene,
    prepared, sky_faces)
from test_torch_shaders import _hold as hold_debug  # noqa: E402
from test_torch_ssaa_stats import ArrayCubeMap, hold  # noqa: E402

H, W = RES
#: SHA-256 of the four outputs' bytes (frame, zbuf, tid, stencil, each
#: C-ordered) of each path on the CPU, taken from the eager path before the
#: frame was staged (the parent of the commit that added this file). flat
#: and gouraud agree: the cube's vertex normals are its face normals.
PRE_STAGING = {
    "general":
        "f65e753297bfae9679acfd024025a6973a2bedf6e0088e4605d7c2cd49e8cae2",
    "flat":
        "ba9ac665cb2639ffc466795464afff1ce0461defbf4fff09af4b166c6e5a5028",
    "gouraud":
        "ba9ac665cb2639ffc466795464afff1ce0461defbf4fff09af4b166c6e5a5028",
    "pbr":
        "f3339c16d469c9a3fffaa5352e470a0740048f644bbf43bf94d3dea179b7ab0f",
    "wireframe":
        "bfb36169214b0a68f036df2431c4747ad48d25733f91b79809fba2fb9ee239d3",
    "points":
        "f667d3c659234d3c13f49150ef75a9d35c9e31192086fc1f7b8529cf71ee9060",
    "cubemap":
        "5ecffd3a54bb336f3fe1a9561b14940627cafe110b53fca0ad6292639eb1e79b",
    "ssaa2":
        "e44cd6482fc3dce5afd3e973b42a43ca25fce3a3c3a30472098d672fdb77b9b3",
    "debug_core":
        "278647887a749d080dbe25e1b9a7a2b9659968ff946136311f3dddd21d96cf96",
}


def digest(outputs):
    h = hashlib.sha256()
    for t in outputs:
        h.update(np.ascontiguousarray(t.numpy()).tobytes())
    return h.hexdigest()


def _np(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def _equal(a, b):
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(x, y) for x, y in zip(a, b))


# ------------------------------------------------------ against the eager path

@pytest.mark.parametrize("path", PATHS)
def test_staged_body_equals_pre_staging_path(path):
    cfg, dyn = prepared(path_scene(tt, gz_torch, path, device="cpu"), path)
    assert digest(eager_outputs(cfg, dyn, path)) == PRE_STAGING[path]
    assert digest(jit_outputs(cfg, dyn, path)) == PRE_STAGING[path]


@pytest.mark.parametrize("path", PATHS)
def test_compiled_equals_eager(path):
    """The program (static buffers, then the body) and the eager path (the
    staged buffer moved, then the body) on the same inputs."""
    cfg, dyn = prepared(path_scene(tt, gz_torch, path, device="cpu"), path)
    want = eager_outputs(cfg, dyn, path)
    got = jit_outputs(cfg, dyn, path)
    assert len(got) == 4 and _equal(got, want)
    # Foreground everywhere; shadow too, but where the debug camera's
    # frustum (near 2.4, far 3.8) clips the shadowed floor away.
    assert (got[2] >= 0).any()
    assert (got[3] != 0).any() or path == "debug_core"


def test_face_statistics_jit_equals_eager():
    scene = path_scene(tt, gz_torch, "general", device="cpu")
    scene.render()
    cfg, dyn = scene._prepare()
    want = pl.face_statistics(cfg, dyn, scene.last_tid)
    got = pl.face_statistics_jit(cfg, dyn, scene.last_tid)
    assert [{k: int(v) for k, v in s.items()} for s in got] == \
        [{k: int(v) for k, v in s.items()} for s in want]
    assert [int(s["total"]) for s in got] == [12, 2]


# ------------------------------------------------------ against JAX

def _pair(path):
    scene_j = path_scene(tj, gz_jax, path,
                         skymap=ArrayCubeMap(**sky_faces()))
    scene_t = path_scene(tt, gz_torch, path, device="cpu")
    cfg_j, dyn_j = prepared(scene_j, path)
    cfg_t, dyn_t = prepared(scene_t, path)
    return cfg_j, dyn_j, cfg_t, dyn_t


@pytest.mark.parametrize("packing", ["own", "interop"])
def test_render_frame_jit_matches_jax(packing):
    cfg_j, dyn_j, cfg_t, dyn_t = _pair("general")
    if packing == "interop":
        dyn_t = dyn_from_numpy(_np(dyn_j), "cpu")
    want = _np(pl_jax.render_frame_jit(cfg_j, dyn_j))
    hold(pl.render_frame_jit(cfg_t, dyn_t), want, RES, cfg_t, dyn_t)


def test_render_ssaa_jit_matches_jax():
    cfg_j, dyn_j, cfg_t, dyn_t = _pair("ssaa2")
    want = _np(pl_jax.render_ssaa_jit(cfg_j, dyn_j, 2))
    hold(pl.render_ssaa_jit(cfg_t, dyn_t, 2), want, (2 * H, 2 * W), cfg_t,
         dyn_t)


def test_render_core_jit_matches_jax():
    """The debug camera's pre-flip float frame and buffers: the frame held
    after the same flip, gamma and quantize in numpy."""
    cfg_j, dyn_j, cfg_t, dyn_t = _pair("debug_core")
    quantize = lambda f: (np.clip(np.asarray(f)[::-1] ** 0.8, 0, 1)
                          * 255).astype(np.uint8)
    frame_j, *rest_j = _np(pl_jax.render_core_jit(cfg_j, dyn_j))
    frame_t, *rest_t = pl.render_core_jit(cfg_t, dyn_t)
    assert frame_t.dtype == torch.float32 and frame_t.shape == (H, W, 3)
    hold((quantize(frame_t.numpy()), *rest_t),
         (quantize(frame_j), *rest_j), RES, cfg_t, dyn_t)


@pytest.mark.parametrize("kind", ["wireframe", "points"])
def test_render_debug_frame_jit_matches_jax(kind):
    cfg_j, dyn_j, cfg_t, dyn_t = _pair(kind)
    want = _np(pl_jax.render_debug_frame(cfg_j, dyn_j, kind))
    got = [a.numpy() for a in pl.render_debug_frame_jit(cfg_t, dyn_t, kind)]
    hold_debug(got, want)


def test_face_statistics_jit_matches_jax():
    """Both packages' counters on JAX's tid, exactly."""
    cfg_j, dyn_j, cfg_t, dyn_t = _pair("general")
    tid = np.asarray(pl_jax.render_frame_jit(cfg_j, dyn_j)[2])
    want = pl_jax.face_statistics(cfg_j, dyn_j, tid)
    got = pl.face_statistics_jit(cfg_t, dyn_t, torch.from_numpy(tid.copy()))
    assert [{k: int(v) for k, v in s.items()} for s in got] == \
        [{k: int(v) for k, v in s.items()} for s in want]


# ------------------------------------------------------ the cache

def test_orbit_serves_one_program():
    """Camera and light orbit, then the cube's vertices move and its
    diffuse map is replaced by another of the same shape: one build, and
    every frame equals the eager frame of the same inputs."""
    from tpu_renderer_torch.ops import compiled

    compiled.clear_compiled()
    scene = path_scene(tt, gz_torch, "general", device="cpu")
    cube = scene.models[0]
    frames = []

    def check():
        frame = scene.render()
        cfg, dyn = scene._prepare()
        want = pl.render_frame(cfg, dyn)
        np.testing.assert_array_equal(frame, want[0].numpy())
        assert _equal((scene.last_zbuf, scene.last_tid, scene.last_stencil),
                      want[1:])
        frames.append(frame)

    builds = compiled.CACHE.builds
    for i in range(4):
        t = 2 * np.pi * i / 4
        scene.camera.set_position((4 * np.cos(t), 2.5, 4 * np.sin(t)))
        scene.light.set_position((3 * np.cos(-t), 4, 3 * np.sin(-t)))
        check()
    cube.vertices = (cube @ tt.translation([0.3, 0.1, 0])).vertices
    check()
    shape = cube.materials["default"].map_Kd.shape
    rng = np.random.default_rng(1)
    cube.materials["default"].map_Kd = (
        np.round(rng.random(shape) * 255) / 255).astype(np.float32)
    cube.bump_version()
    check()
    assert compiled.CACHE.builds == builds + 1
    assert compiled.CACHE.last.calls == len(frames)
    assert all((a != b).any() for a, b in zip(frames, frames[1:]))

    scene.resolution = (H // 2, W // 2)
    scene.render()
    assert compiled.CACHE.builds == builds + 2
    scene.resolution = RES
    scene.shader = "gouraud"
    scene.render()
    assert compiled.CACHE.builds == builds + 3
    scene.shader = "general"
    np.testing.assert_array_equal(scene.render(), frames[-1])
    assert compiled.CACHE.builds == builds + 3


def test_cache_evicts_and_clears(monkeypatch):
    from tpu_renderer_torch.ops import compiled

    compiled.clear_compiled()
    monkeypatch.setattr(compiled.CACHE, "max_programs", 2)
    scene = path_scene(tt, gz_torch, "flat", device="cpu")
    keys = []
    for shader in ("flat", "gouraud", "pbr"):
        scene.shader = shader
        scene.render()
        keys.append(next(reversed(compiled.CACHE.programs)))
    assert list(compiled.CACHE.programs) == keys[1:]
    scene.shader = "flat"
    builds = compiled.CACHE.builds
    scene.render()
    assert compiled.CACHE.builds == builds + 1
    assert list(compiled.CACHE.programs) == [keys[2], keys[0]]
    compiled.clear_compiled()
    assert not compiled.CACHE.programs and compiled.CACHE.last is None
