"""bench_torch's configurations (bench.py's ``bench_all``, 1-6) at a small
size, each through the port and the JAX package.

Each case builds one configuration in both packages from the same numpy
arrays (``bench_torch.build_config(pkg=...)``: the stand-in mesh on
``make_sphere(10, 14)``, 32² maps, 96² frames), renders it with
``Scene.render()`` (the port on the CPU, through its compiled program over
the kernels' plain versions; JAX on XLA) and holds the port's outputs to
JAX's at the North star's bars (``hold``). The cases: 1 (gouraud), 2
perspective and orthographic (culling), 3 under its spot light and under a
directional light (the first port tests of either against JAX), 3 under
SYSTEM.RH and SUBSYSTEM.DIRECTX with shadows (the spot light's w = 2
extrusion), 4 (the skybox, chained transforms) and 6 (ten distinct
textured boxes, shadows). The crowd (5) is test_torch_instancing.py's.

Two places where the packages' arithmetic differs, not their results, set
the bars' scope (ROADMAP watch list):

- the frame's first row lies on the frustum's bottom plane: its per-pixel
  clip test, and the skybox ray there, compare a value of about 0, whose
  sign XLA's fused multiply-adds flip on a row segment (13 of 96 pixels of
  row 0 in case 3). The bars hold on every other row;
- at near = 1e-4 (cases 1, 2, 5, 6) the linearized depth moves by up to
  about 5e-5 relative under XLA's fused multiply-adds, which flips shadow
  tests that sit on their threshold. The stencil is held equal outside the
  port's depth ties (``stencil_ties``, rtol 1e-5), where it may differ on
  at most 0.1% of pixels.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

import tpu_renderer as tj
import tpu_renderer_torch as tt

import bench_torch as bt
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_ssaa_stats import ArrayCubeMap, stencil_ties

SMALL = dict(resolution=(96, 96), tex=32, mesh=(10, 14))
SKY = bt.cubemap_faces(16)


def hold(scene_t, frame_t, scene_j, frame_j):
    """The North star's bars on two rendered scenes of one configuration,
    from the frame's second row on (module docstring): tid >= 99.9% equal,
    the stencil equal outside the port's depth ties and differing on at
    most 0.1% of pixels, frame >= 99.9% identical pixels; both have
    foreground and background."""
    rows = np.s_[1:]                       # tid rows; the frame is flipped
    tid_t, tid_j = scene_t.last_tid.numpy(), np.asarray(scene_j.last_tid)
    st_t, st_j = scene_t.last_stencil.numpy(), np.asarray(
        scene_j.last_stencil)
    assert frame_t.shape == frame_j.shape == (*scene_t.resolution, 3)
    assert frame_t.dtype == np.uint8 and tid_t.shape == tid_j.shape
    assert (tid_t[rows] == tid_j[rows]).mean() >= 0.999
    cfg, dyn = scene_t._prepare()
    differ = st_t != st_j
    if cfg.shadows:
        ties = stencil_ties(cfg, dyn, scene_t.last_zbuf.numpy())
        assert not (differ & ~ties)[rows].any()
    assert differ[rows].mean() <= 0.001
    assert (frame_t[::-1] == frame_j[::-1]).all(-1)[rows].mean() >= 0.999
    assert (tid_t >= 0).any() and (tid_t < 0).any()


def build(name, pkg):
    if pkg is tt:
        return bt.build_config(name, device="cpu", pkg=tt,
                               skymap=tt.CubeMap(**SKY), **SMALL)
    return bt.build_config(name, device=None, pkg=tj,
                           skymap=ArrayCubeMap(**SKY), **SMALL)


CASES = {"cfg1": None, "cfg2-persp": None, "cfg2-ortho": None,
         "cfg3": None, "cfg3-directional": "DIRECTIONAL_LIGHTNING",
         "cfg3-rh-shadows": None, "cfg4": None, "cfg6": None}


@pytest.mark.parametrize("case", CASES)
def test_configuration_matches_jax(case):
    name = case.replace("-directional", "")
    scene_t, scene_j = build(name, tt), build(name, tj)
    if CASES[case]:
        for scene, pkg in ((scene_t, tt), (scene_j, tj)):
            scene.light = pkg.Light(
                (3, 4, 2), light_type=getattr(pkg.Lightning, CASES[case]),
                ambient_strength=0.1)
    hold(scene_t, scene_t.render(), scene_j, scene_j.render())
    cfg, _ = scene_t._prepare()
    assert cfg.light_type.name == (CASES[case] or (
        "SPOT_LIGHTNING" if name.startswith("cfg3") else "POINT_LIGHTNING"))
    if name == "cfg3-rh-shadows":
        assert cfg.system == tt.SYSTEM.RH and cfg.shadows
        assert (scene_t.last_stencil != 0).any()
    if name == "cfg6":
        assert len(cfg.models) == 10 and (scene_t.last_stencil != 0).any()


@pytest.mark.parametrize("name", bt.CONFIGS)
def test_configuration_shapes(name):
    """bench_torch builds every configuration at its own size: faces,
    models, resolution and the path's static facts."""
    scene = bt.build_config(name, device="cpu", tex=32, mesh=(10, 14),
                            skymap=tt.CubeMap(**SKY))
    cfg, dyn = scene._prepare()
    want = {"cfg1": ((512, 512), 1, "gouraud"),
            "cfg5-merged": ((1024, 1024), 2, "general"),
            "cfg5-instances": ((1024, 1024), 21, "general"),
            "cfg6": ((512, 512), 10, "general")}
    res, n_models, shader = want.get(name, ((512, 512), 2 - name.startswith(
        "cfg2"), "general"))
    assert (cfg.resolution, len(cfg.models), cfg.shader) == (
        res, n_models, shader)
    assert cfg.backface_culling
    assert cfg.shadows == (name in ("cfg3-rh-shadows", "cfg5-merged",
                                    "cfg5-instances", "cfg6"))
    assert cfg.background == ("cubemap" if name == "cfg4" else "color")
    assert cfg.cam_projection_type == (
        tt.PROJECTION_TYPE.ORTHOGRAPHIC if name == "cfg2-ortho"
        else tt.PROJECTION_TYPE.PERSPECTIVE)


def test_bench_and_chip_smoke_pull_in_no_jax():
    """bench_torch.py and chip_smoke.py, which the card's host runs without
    JAX, build and render a configuration without importing it."""
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    code = ("import sys, bench_torch, chip_smoke\n"
            "bench_torch.build_config('cfg3-rh-shadows', device='cpu', "
            "resolution=(32, 32), tex=16).render()\n"
            "bad = [m for m in sys.modules if m == 'jax' or m.startswith("
            "('jax.', 'tpu_renderer.')) or m == 'tpu_renderer']\n"
            "print(bad)\nsys.exit(1 if bad else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=repo,
                          env=dict(os.environ, PYTHONPATH=repo),
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
