"""Package rules and host code of the PyTorch port.

- importing tpu_renderer_torch pulls in neither JAX nor tpu_renderer;
- Scene renders on CUDA by default, so without CUDA both
  Scene(device="cuda") and Scene() raise, and device="cpu" is an explicit
  request; the one feature not ported, the sharded wireframe frame (the
  JAX package has none either), raises NotImplementedError, also in a
  scene with gizmos; supersampling and ``stats()`` work in scenes with a
  debug camera or gizmos (tests/test_torch_ssaa_stats.py holds them to the
  JAX package);
- the numpy host code (OBJ loader, EdgeTable, gizmos, texture stacks,
  transforms) matches the JAX package's.

The kernel wrappers are tested in test_torch_kernels.py.
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import tpu_renderer as tj
import tpu_renderer_torch as tt
from tpu_renderer.models import gizmos as gz_jax
from tpu_renderer.models import scene as scene_jax
from tpu_renderer.ops import transforms as tf_jax
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.models import scene as scene_torch
from tpu_renderer_torch.ops import transforms as tf_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_import_pulls_in_no_jax():
    code = ("import sys, tpu_renderer_torch, tpu_renderer_torch.interop, "
            "tpu_renderer_torch.ops.pipeline, tpu_renderer_torch.ops.cubemap, "
            "tpu_renderer_torch.ops.overlay, tpu_renderer_torch.ops.lines, "
            "tpu_renderer_torch.parallel.mesh, "
            "tpu_renderer_torch.parallel.sharded, "
            "tpu_renderer_torch.models.face, tpu_renderer_torch.models.native, "
            "tpu_renderer_torch.utils.image, "
            "tpu_renderer_torch.utils.objwrite, "
            "tpu_renderer_torch.utils.profiling, "
            "tpu_renderer_torch.transformation, "
            "tpu_renderer_torch.plane_intersection\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'tpu_renderer.')) or m == 'tpu_renderer']\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_scene_on_cuda_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError):
        tt.Scene(tt.Camera((0, 0, 3)), tt.Light((1, 1, 1)), device="cuda")


def test_scene_needs_explicit_device():
    """The default device is CUDA: without it, only an explicit
    device="cpu" renders."""
    if torch.cuda.is_available():
        pytest.skip("this host has CUDA")
    with pytest.raises(RuntimeError):
        tt.Scene(tt.Camera((0, 0, 3)), tt.Light((1, 1, 1)))


def _sharded_wireframe_with_gizmo():
    scene = tt.Scene(device="cpu", light=tt.Light((1, 1, 1), show=True),
                     shader="wireframe")
    tt.render_frame_sharded(*scene._prepare(), None)


@pytest.mark.parametrize("make", [
    _sharded_wireframe_with_gizmo,
], ids=["gizmo"])
def test_unported_features_raise(make):
    with pytest.raises(NotImplementedError):
        make()


def _small_scene(camera=None, **kw):
    scene = tt.Scene(camera or tt.Camera((2, 2.5, 4), near=0.01, far=50),
                     resolution=(24, 32), device="cpu", **kw)
    scene.add_model(gz_torch.make_cube())
    scene.add_model(gz_torch.make_floor(2.0, y=-0.6))
    return scene


def _debug_camera_supersample_warns():
    scene = _small_scene(debug_camera=tt.Camera((1, 1, 1)), supersample=2)
    with pytest.warns(RuntimeWarning, match="debug-camera"):
        assert scene.render().shape == (24, 32, 3)


def _stats_before_render_raises():
    with pytest.raises(RuntimeError, match="render"):
        _small_scene(camera=tt.Camera((0, 0, 3), show=True)).stats()


def _supersample_renders_native_shape():
    scene = _small_scene(supersample=2)
    assert scene.render().shape == (24, 32, 3)
    assert tuple(scene.last_tid.shape) == (48, 64)


def _stats_after_render():
    scene = _small_scene()
    scene.render()
    stats = scene.stats()
    assert [s["total"] for s in stats] == [12, 2]
    assert all(set(s["by_error"]) and isinstance(s["rendered"], int)
               for s in stats)


@pytest.mark.parametrize("check", [
    _debug_camera_supersample_warns, _stats_before_render_raises,
    _supersample_renders_native_shape, _stats_after_render,
], ids=["debug_camera_supersample", "stats_before_render",
        "supersample_shape", "stats_after_render"])
def test_ported_features(check):
    """Supersampling and stats() work; what they cannot do is refused as
    the JAX package refuses it."""
    check()


def test_obj_loader_and_edge_table_match(tmp_path):
    obj = tmp_path / "quad.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 0.5 1\n"
                   "vt 0 0\nvt 1 0\nvt 1 1\nvt 0 1\nvn 0 0 1\n"
                   "f 1/1/1 2/2/1 3/3/1 4/4/1\nf 1/1/1 2/2/1 5/3/1\n"
                   "f -1/1/1 3/3/1 4/4/1\n")
    mj = tj.Model.load_model(str(obj), use_native=False)
    mt = tt.Model.load_model(str(obj))
    for attr in ("vertices", "uv", "normals", "face_array"):
        np.testing.assert_array_equal(getattr(mt, attr), getattr(mj, attr))
    for attr in ("incidence_edge", "incidence_dir"):
        np.testing.assert_array_equal(getattr(mt.edge_table, attr),
                                      getattr(mj.edge_table, attr))
    assert mt.silhouette((0, 0, 5)) == mj.silhouette((0, 0, 5))


@pytest.mark.parametrize("make", ["make_floor", "make_sphere", "make_cube",
                                  "make_camera_gizmo"])
def test_gizmos_match(make):
    mj, mt = getattr(gz_jax, make)(), getattr(gz_torch, make)()
    for attr in ("vertices", "uv", "normals", "face_array"):
        a, b = getattr(mt, attr), getattr(mj, attr)
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_array_equal(a, b)


def test_texture_stack_matches_and_interop_keeps_bits():
    rng = np.random.default_rng(5)
    model_j, model_t = gz_jax.make_cube(), gz_torch.make_cube()
    nm = np.asarray(rng.random((8, 8, 3)) * 2 - 1, dtype=np.dtype(
        np.float32, metadata={"tangent": True}))
    model_j.materials["default"].norm = nm
    model_t.materials["default"].norm = nm
    sj = scene_jax._texture_stack(model_j, "norm")
    st = scene_torch._texture_stack(model_t, "norm")
    np.testing.assert_array_equal(st[0], sj[0].view(np.int32))
    for a, b in zip(st[1:], sj[1:]):
        np.testing.assert_array_equal(a, b)
    dyn = {"models": [{"norm_stack": sj[0]}],
           "camera": {"near": np.float32(1)}, "light": {},
           "background_color": np.zeros(3, np.float32)}
    out = dyn_from_numpy(dyn, "cpu")["models"][0]["norm_stack"]
    assert out.dtype == torch.int32
    np.testing.assert_array_equal(out.numpy(), sj[0].view(np.int32))


def test_model_transforms_match():
    for fn, arg in ((tf_jax.scale, 1.7), (tf_jax.translation, [1, -2, 3]),
                    (tf_jax.rotate_xyz, [10, 25, -40])):
        want = np.asarray(fn(arg))
        got = getattr(tf_torch, fn.__name__)(arg).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    base = gz_torch.make_cube()
    moved = base @ tf_torch.scale(2.0) @ tf_torch.translation([0, 1, 0])
    np.testing.assert_allclose(moved.vertices[:, 1], base.vertices[:, 1] * 2 + 1)
