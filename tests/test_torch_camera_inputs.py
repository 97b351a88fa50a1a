"""The frame's camera entries (``pipeline.frame_inputs``) against the
composition they replaced, and the cache of the camera constants.

- bit for bit: the staging buffer and its layout equal what
  ``pipeline._cam_matrices``, ``raster_cuda.stencil_scalars`` and one
  ``torch.cat`` built before, for every system, subsystem and projection
  type of ``transforms.perspectives`` at three resolutions, 500 seeded
  cameras each (parameters as float32 tensors, as a Scene stages them, or
  as float64 arrays and numbers), with and without a debug camera, over a
  colour and over a cubemap background, and for a camera whose ``up`` is
  its forward axis (a zero cross product) and one that stands on its
  centre (a zero forward axis, NaN frustum planes);
- the cache: an orbit builds the constants once per camera and hits on
  every later frame; another fovy, near, far, resolution or projection
  type builds again, and the buffer stays the oracle's; the cache keeps
  at most ``pipeline.MAX_CAMERA_CONSTANTS`` entries, the least recently
  used dropped first;
- torch's matrix product and norm round numpy-backed views as they round
  torch's own allocations, at every 4-byte offset.

No JAX: the file also runs on the card's host, whose CPU kernels torch
picks by its own instruction set.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.constants import PROJECTION_TYPE, SYSTEM
from tpu_renderer_torch.models import gizmos
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import transforms as T
from tpu_renderer_torch.ops.cubemap import skybox_inputs
from tpu_renderer_torch.ops.lightning import Lightning

from test_torch_kernels import one_torch_thread  # noqa: F401

#: Every (subsystem, projection type, system) of the projection registry.
PROJECTIONS = [(sub, ptype, system)
               for sub, by_type in T.perspectives.items()
               for ptype, by_system in by_type.items()
               for system in by_system]
RESOLUTIONS = [(1024, 1024), (512, 768), (97, 131)]
CAMERAS = 500
#: (debug camera, background) of the i-th camera: i % 4.
VARIANTS = [(False, "color"), (True, "color"), (False, "cubemap"),
            (True, "cubemap")]


def config(subsystem, projection_type, system, resolution, debug=False,
           background="color"):
    return pl.SceneConfig(
        resolution=resolution, system=system, subsystem=subsystem,
        shadows=False, cam_projection_type=projection_type,
        backface_culling=False, light_type=Lightning.POINT_LIGHTNING,
        models=(), background=background, has_debug_camera=debug,
        dbg_projection_type=PROJECTION_TYPE.PERSPECTIVE)


def oracle_inputs(cfg, dyn):
    """The staging buffer and layout as :func:`pipeline.frame_inputs` built
    them before the camera constants were kept: the camera matrices of
    ``_cam_matrices``, the stencil's constants, one ``torch.cat``."""
    cam = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    parts = [(k, cam[k]) for k in ("MVP", "viewport", "frustum_planes",
                                   "near", "far")]
    parts.append(("position", torch.as_tensor(dyn["camera"]["position"],
                                              dtype=torch.float32)))
    parts.append(("zc", torch.tensor(rc.stencil_scalars(cam["near"],
                                                        cam["far"]))))
    if cfg.has_debug_camera:
        parts.append(("dbg_MVP", pl._cam_matrices(
            cfg, dyn["debug_camera"], "cpu", cfg.dbg_projection_type)["MVP"]))
    if cfg.background == "cubemap":
        rays, tri = skybox_inputs(cam)
        parts += [("sky_rays", rays), ("sky_tri", tri)]
    layout = tuple((name, tuple(t.shape)) for name, t in parts)
    buf = torch.cat([t.reshape(-1).to(torch.float32) for _, t in parts])
    return buf, layout


def assert_same_bits(cfg, dyn, what=""):
    """The buffer of :func:`pipeline.frame_inputs` equals the oracle's, its
    NaNs included, bit for bit; where the oracle raises (a skybox over a
    camera whose view is singular), so does it."""
    try:
        want, want_layout = oracle_inputs(cfg, dyn)
    except torch.linalg.LinAlgError:
        with pytest.raises(torch.linalg.LinAlgError):
            pl.frame_inputs(cfg, dyn)
        return None
    buf, layout = pl.frame_inputs(cfg, dyn)
    assert layout == want_layout, what
    assert buf.dtype == torch.float32 and buf.device.type == "cpu", what
    assert torch.equal(buf.view(torch.int32), want.view(torch.int32)), what
    return buf


def as_scene_stages(cam):
    """Camera parameters as float32 CPU tensors (Scene._cam_dyn)."""
    return {k: torch.as_tensor(np.asarray(v, np.float32))
            for k, v in cam.items()}


def as_raw(cam):
    """Camera parameters as float64 arrays and Python floats."""
    return {k: (np.asarray(v, np.float64) if np.ndim(v) else float(v))
            for k, v in cam.items()}


def seeded_cameras(rng, n):
    """``n`` cameras: two whose geometry degenerates, then random ones
    whose fovy, near and far come from a pool of eight, so that the cache
    both builds and hits."""
    pool = [(rng.uniform(10, 150), near, near * rng.uniform(1.5, 1e5))
            for near in rng.uniform(1e-4, 3, 8)]
    cams = []
    for i in range(n):
        fovy, near, far = pool[i % len(pool)]
        position = rng.uniform(-20, 20, 3)
        center = rng.uniform(-5, 5, 3)
        up = rng.normal(size=3)
        if i == 0:      # up along the forward axis: a zero cross product
            position, center, up = (0.0, 5.0, 0.0), (0.0, 0.0, 0.0), (0, 1, 0)
        elif i == 1:    # the camera on its centre: a zero forward axis
            center = position
        elif i == 2:    # up nearly along the forward axis
            up = 2.5 * (position - center)
        cams.append(dict(position=position, center=center, up=up, fovy=fovy,
                         near=near, far=far))
    return cams


@pytest.mark.parametrize("resolution", RESOLUTIONS,
                         ids=lambda r: f"{r[0]}x{r[1]}")
@pytest.mark.parametrize("subsystem,projection_type,system", PROJECTIONS,
                         ids=lambda v: str(v))
def test_frame_inputs_equal_the_composition_they_replaced(
        subsystem, projection_type, system, resolution):
    rng = np.random.default_rng(
        [subsystem, projection_type, system + 1, *resolution])
    cams = seeded_cameras(rng, CAMERAS)
    debug_cams = seeded_cameras(rng, CAMERAS)
    for i, (cam, dbg) in enumerate(zip(cams, debug_cams)):
        debug, background = VARIANTS[i % len(VARIANTS)]
        cfg = config(subsystem, projection_type, system, resolution, debug,
                     background)
        form = as_scene_stages if (i // len(VARIANTS)) % 2 == 0 else as_raw
        dyn = {"camera": form(cam)}
        if debug:
            dyn["debug_camera"] = form(dbg)
        assert_same_bits(cfg, dyn, f"camera {i}: {cam}")


def test_the_degenerate_cameras_give_zero_axes_and_nan_planes():
    cfg = config(*PROJECTIONS[0], (97, 131))
    on_axis, on_centre = seeded_cameras(np.random.default_rng(0), 2)
    for cam, nan_planes in ((on_axis, False), (on_centre, True)):
        dyn = {"camera": as_scene_stages(cam)}
        buf = assert_same_bits(cfg, dyn)
        planes = pl.staged(buf, pl.frame_inputs(cfg, dyn)[1])["frustum_planes"]
        assert bool(torch.isnan(planes).any()) == nan_planes


@pytest.mark.parametrize("op", ["mm", "vector_norm"])
def test_torch_kernels_round_numpy_views_as_their_own_tensors(op):
    """frame_inputs hands torch's matrix product and norm views of numpy
    arrays, wherever numpy placed them: at every 4-byte offset from a
    64-byte boundary they round as on torch's own (64-byte aligned)
    allocations."""
    rng = np.random.default_rng(19)
    pool = np.empty(2 * 64, np.float32)
    for trial in range(1024):
        at = trial % 16
        if op == "mm":
            a = np.eye(4, dtype=np.float32)
            a[3, :3] = rng.normal(size=3) * 10
            b = rng.normal(size=(4, 4)).astype(np.float32)
            want = torch.mm(torch.tensor(a), torch.tensor(b))
            va = pool[at:at + 16].reshape(4, 4)
            vb = pool[64 + at:64 + at + 16].reshape(4, 4)
            va[...], vb[...] = a, b
            got = torch.mm(torch.from_numpy(va), torch.from_numpy(vb))
        else:
            shape = (6, 4) if trial % 2 else (3,)
            v = (rng.normal(size=shape) * rng.uniform(1e-3, 1e3)).astype(
                np.float32)
            want = torch.linalg.vector_norm(torch.tensor(v), dim=-1,
                                            keepdim=True)
            view = pool[at:at + v.size].reshape(shape)
            view[...] = v
            got = torch.linalg.vector_norm(torch.from_numpy(view), dim=-1,
                                           keepdim=True)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32)), at


# ---------------------------------------------------------------- the cache

class Lookups:
    """The look-ups of ``pipeline._camera_constants``, told apart by the
    cache itself: one that returns an entry the cache already held is a
    hit, any other a build."""

    def __init__(self, monkeypatch):
        self.reset()
        look = pl._camera_constants

        def counted(*args):
            held = {id(e) for e in pl._CAMERA_CONSTANTS.values()}
            entry = look(*args)
            if id(entry) in held:
                self.hits += 1
            else:
                self.builds += 1
            return entry

        monkeypatch.setattr(pl, "_camera_constants", counted)

    def reset(self):
        self.builds = self.hits = 0

    def counts(self):
        return {"builds": self.builds, "hits": self.hits}


@pytest.fixture
def empty_cache(monkeypatch):
    pl._CAMERA_CONSTANTS.clear()
    return Lookups(monkeypatch)


def orbit_scene(debug_camera=None):
    scene = tt.Scene(camera=tt.Camera((0.5, 3, 5), center=(0, 0, 0)),
                     debug_camera=debug_camera, resolution=(16, 16),
                     device="cpu", shadows=False)
    scene.add_model(gizmos.make_floor(2.0, y=-1.0))
    return scene


@pytest.mark.parametrize("debug", [False, True], ids=["camera", "debug"])
def test_an_orbit_builds_once_per_camera(empty_cache, debug):
    counts = empty_cache.counts
    frames = 50
    scene = orbit_scene(tt.Camera((1.0, 3.0, 1.5), center=(0, 0, 0), fovy=50,
                                  near=2.4, far=3.8) if debug else None)
    cams = 2 if debug else 1
    orbit = [np.float32([5 * np.sin(t) + 0.5, 3, 5 * np.cos(t)])
             for t in np.linspace(0, 2 * np.pi, frames, endpoint=False)]
    for position in orbit:
        scene.camera.position = position
        scene.render()
    assert counts() == {"builds": cams, "hits": cams * (frames - 1)}
    for i, position in enumerate(orbit):
        scene.camera.position = position
        assert_same_bits(*scene._prepare(), f"frame {i}")
    assert counts() == {"builds": cams, "hits": cams * (2 * frames - 1)}


def test_a_changed_camera_or_scene_builds_again(empty_cache):
    counts = empty_cache.counts
    gl, lh, persp = 2, SYSTEM.LH, PROJECTION_TYPE.PERSPECTIVE
    base = dict(position=(0.5, 3.0, 5.0), center=(0, 0, 0), up=(0, 1, 0),
                fovy=90.0, near=1e-4, far=400.0)
    steps = [({}, {}), ({"fovy": 60.0}, {}), ({"near": 0.5}, {}),
             ({"far": 40.0}, {}), ({}, {"resolution": (512, 768)}),
             ({}, {"projection_type": PROJECTION_TYPE.ORTHOGRAPHIC})]
    cam = dict(base)
    view = dict(resolution=(1024, 1024), projection_type=persp)
    seen = []
    for n, (cam_change, view_change) in enumerate(steps, start=1):
        cam.update(cam_change)
        view.update(view_change)
        cfg = config(gl, view["projection_type"], lh, view["resolution"])
        dyn = {"camera": as_scene_stages(cam)}
        assert_same_bits(cfg, dyn, f"{cam_change} {view_change}")
        assert counts() == {"builds": n, "hits": n - 1}
        buf, layout = pl.frame_inputs(cfg, dyn)       # the same camera: kept
        assert counts() == {"builds": n, "hits": n}
        views = pl.staged(buf, layout)
        seen.append({k: views[k].clone() for k in ("viewport", "zc")})
    # Another near or far moves the viewport's depth and the stencil's
    # constants: an entry kept for the old ones would be stale.
    for i in (2, 3):
        assert not torch.equal(seen[i]["zc"], seen[i - 1]["zc"])
        assert not torch.equal(seen[i]["viewport"], seen[i - 1]["viewport"])
    # Back to the first camera: kept, so a hit, and still the oracle's.
    empty_cache.reset()
    assert_same_bits(config(gl, persp, lh, (1024, 1024)),
                     {"camera": as_scene_stages(base)})
    assert counts() == {"builds": 0, "hits": 1}


def test_the_cache_is_bounded(empty_cache):
    counts = empty_cache.counts
    cfg = config(2, PROJECTION_TYPE.PERSPECTIVE, SYSTEM.RH, (97, 131))
    cap = pl.MAX_CAMERA_CONSTANTS

    def dyn(k):
        return {"camera": as_scene_stages(dict(
            position=(1.0, 2.0, 3.0), center=(0, 0, 0), up=(0, 1, 0),
            fovy=30.0 + k, near=0.1, far=50.0))}

    for k in range(cap + 5):
        assert_same_bits(cfg, dyn(k))
        assert len(pl._CAMERA_CONSTANTS) <= cap
    assert len(pl._CAMERA_CONSTANTS) == cap
    empty_cache.reset()
    pl.frame_inputs(cfg, dyn(cap + 4))       # the newest is kept
    assert counts() == {"builds": 0, "hits": 1}
    pl.frame_inputs(cfg, dyn(0))             # the oldest was dropped
    assert counts() == {"builds": 1, "hits": 1}
    assert len(pl._CAMERA_CONSTANTS) == cap
