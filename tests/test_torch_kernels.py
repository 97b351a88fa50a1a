"""The port's kernel wrappers (ops/raster_cuda.py), without JAX.

This file imports no JAX, so it also runs on the card's host:

    python -m pytest tests/test_torch_kernels.py -q

- on the CPU each wrapper runs its plain version (launch count stays 0) and
  a tensor on any other device than the CPU or CUDA raises;
- tile_bins lists every bbox overlap in primitive order;
- on a CUDA card (marker ``cuda``, skipped elsewhere) each kernel (K5 in
  its three layouts) is bit-identical to its plain version on the same
  tensors, and a Scene rendered on the card matches the CPU render under
  every shader;
- the same holds for the sharded modes, on the inputs of rank (1, 1) of a
  2x2 (rows, tris) mesh (``chip_smoke.shard_inputs``, at a row0 > 0): K1 z
  only, K7, the owned ranges of K2, K5 and K3, and K4.

``build_scene`` is the shared procedural test scene: test_torch_slice.py
and test_torch_modules.py build the same scene in the JAX package.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import raster_cuda as rc

from chip_smoke import shard_inputs

RES = (64, 128)


def textures(seed=0):
    """Seeded in-memory maps: cube diffuse, cube tangent normal map, floor
    diffuse — 8-bit-quantized like images loaded from disk."""
    rng = np.random.default_rng(seed)
    q = lambda a: (np.round(a * 255) / 255).astype(np.float32)
    nm = q(rng.random((16, 16, 3))) * 2 - 1
    nm = np.asarray(nm, dtype=np.dtype(np.float32, metadata={"tangent": True}))
    return q(rng.random((16, 16, 3))), nm, q(rng.random((32, 48, 3)))


def build_scene(pkg, gizmos, resolution=RES, **scene_kw):
    """The cube-over-floor scene in either package (``pkg`` is
    tpu_renderer or tpu_renderer_torch)."""
    cube_kd, cube_nm, floor_kd = textures()
    cube = gizmos.make_cube(1.0)
    cube.shadowing = True
    cube.materials["default"].map_Kd = cube_kd
    cube.materials["default"].norm = cube_nm
    cube.normal_map_is_tangent = True
    floor = gizmos.make_floor(2.0, y=-0.6)
    floor.materials["default"].map_Kd = floor_kd
    scene = pkg.Scene(
        pkg.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60, near=0.01, far=50,
                   backface_culling=True),
        pkg.Light((3, 4, 2), light_type=pkg.Lightning.POINT_LIGHTNING,
                  ambient_strength=0.1),
        shadows=True, resolution=resolution, system=pkg.SYSTEM.LH,
        subsystem=pkg.SUBSYSTEM.OPENGL, **scene_kw)
    scene.add_model(cube)
    scene.add_model(floor)
    return scene


#: Kernel cases: case id -> (wrapper name in raster_cuda, the LAUNCHES key
#: its launch counts under); K5 once per layout, and the sharded modes.
CASES = {"visibility": ("visibility", "visibility"),
         "gbuffer": ("gbuffer", "gbuffer"),
         "sample_textures": ("sample_textures", "sample_textures"),
         "stencil": ("stencil", "stencil"),
         "gbuffer_slim-flat": ("gbuffer_slim", "gbuffer_slim"),
         "gbuffer_slim-gouraud": ("gbuffer_slim", "gbuffer_slim"),
         "gbuffer_slim-pbr": ("gbuffer_slim", "gbuffer_slim"),
         "lines": ("lines", "lines"),
         "visibility_z-shard": ("visibility", "visibility_z"),
         "tidpass-shard": ("tidpass", "tidpass"),
         "gbuffer-owned": ("gbuffer", "gbuffer"),
         "gbuffer_slim-gouraud-owned": ("gbuffer_slim", "gbuffer_slim"),
         "gbuffer_slim-pbr-owned": ("gbuffer_slim", "gbuffer_slim"),
         "sample_textures-owned": ("sample_textures", "sample_textures"),
         "stencil-row0": ("stencil", "stencil")}


#: chip_smoke.shard_inputs' case names -> the sharded cases' ids here.
SHARD_CASES = {"visibility_z": "visibility_z-shard",
               "tidpass": "tidpass-shard",
               "gbuffer_owned": "gbuffer-owned",
               "gbuffer_slim_gouraud_owned": "gbuffer_slim-gouraud-owned",
               "gbuffer_slim_pbr_owned": "gbuffer_slim-pbr-owned",
               "sample_textures_owned": "sample_textures-owned"}


@pytest.fixture(scope="module")
def stage_inputs():
    """The kernels' inputs for the test_torch_slice scene (CPU), keyed by
    case id, as (args, kwargs)."""
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops.shadow import prepare_quads

    scene = build_scene(tt, gz_torch, device="cpu")
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    faces, attrs = pl._build_face_batch(cfg, dyn, cam_m)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    zb, tid = rc.visibility_plain(fdata, flags, h, w, cfg.system)
    adata = rc.pack_face_attrs(attrs)
    gb = rc.gbuffer_plain(fdata, adata, tid)
    qdata, qi = rc.pack_quads(*prepare_quads(cfg, dyn, cam_m), h, w)
    zc = rc.stencil_scalars(dyn["camera"]["near"], dyn["camera"]["far"])
    inputs = {
        "visibility": (fdata, flags, h, w, cfg.system),
        "gbuffer": (fdata, adata, tid),
        "sample_textures": (tid, gb[rc.GB_IU].contiguous(),
                            gb[rc.GB_IV].contiguous(),
                            *pl.texture_tables(cfg, dyn, attrs)),
        "stencil": (qdata, qi, zb, cfg.system, *zc),
        "lines": pl._wireframe_lines(
            *pl._debug_vertices(dyn, cam_m)[:3],
            torch.cat([md["pad_valid"] for md in dyn["models"]]),
            zb * cfg.system, h, w),
    }
    for layout in rc.SLIM_CHANNELS:
        inputs[f"gbuffer_slim-{layout}"] = (
            fdata, rc.pack_slim_attrs(attrs, layout), tid, layout)
    inputs = {case: (args, {}) for case, args in inputs.items()}
    shard = shard_inputs(cfg, dyn, zb, mesh=(2, 2), at=(1, 1))
    for case, args_kw in shard.items():
        inputs[SHARD_CASES[case]] = args_kw
    (_, _, zb_rows, _), kw = shard["tidpass"]
    inputs["stencil-row0"] = ((qdata, qi, zb_rows, cfg.system, *zc),
                              {"row0": kw["row0"]})
    return inputs


def _equal(a, b):
    if a is None or b is None:
        return a is b
    if isinstance(a, tuple):
        return all(_equal(x, y) for x, y in zip(a, b))
    return torch.equal(a, b)


def test_cases_cover_every_wrapper():
    assert {key for _, key in CASES.values()} == set(rc.LAUNCHES)


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_on_cpu_runs_plain_version(stage_inputs, name):
    rc.reset_launches()
    args, kw = stage_inputs[name]
    fn, key = CASES[name]
    got = getattr(rc, fn)(*args, **kw)
    want = getattr(rc, f"{fn}_plain")(*args, **kw)
    assert _equal(got, want)
    assert rc.LAUNCHES[key] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_refuses_other_devices(stage_inputs, name):
    """No silent path: tensors on a device that is neither the CPU nor CUDA
    (here PyTorch's shape-only 'meta' device) raise."""
    args, kw = stage_inputs[name]
    args = tuple(a.to("meta") if isinstance(a, torch.Tensor) else a
                 for a in args)
    with pytest.raises(RuntimeError):
        getattr(rc, CASES[name][0])(*args, **kw)


def test_stage_inputs_are_not_degenerate(stage_inputs):
    """The slim G-buffers carry foreground, and the wireframe lights pixels
    of the scene (edges of faces behind the visible surface pass the LH
    z test)."""
    for layout in rc.SLIM_CHANNELS:
        gb = rc.gbuffer_slim(*stage_inputs[f"gbuffer_slim-{layout}"][0])
        assert gb.shape == (rc.SLIM_CHANNELS[layout], *RES)
        assert (gb != 0).any()
    assert rc.lines(*stage_inputs["lines"][0]).sum() > 0


def test_shard_inputs_are_not_degenerate(stage_inputs):
    """The sharded cases' shard owns some foreground of its block of rows,
    the other shard owns some too, its owned planes are zero elsewhere, and
    its quads shadow some of its rows."""
    call = lambda name, fn: fn(*stage_inputs[name][0], **stage_inputs[name][1])
    (fdata, _, tid), kw = stage_inputs["gbuffer-owned"]
    own = (tid >= kw["gid0"]) & (tid < kw["gid0"] + fdata.shape[0])
    assert kw["row0"] > 0 and kw["gid0"] > 0
    assert own.any() and ((tid >= 0) & ~own).any()
    gb = call("gbuffer-owned", rc.gbuffer)
    assert (gb[:, own] != 0).any() and (gb[:, ~own] == 0).all()
    samp, mask = call("sample_textures-owned", rc.sample_textures)
    assert (mask[own] != 0).any() and (mask[~own] == 0).all()
    assert (call("stencil-row0", rc.stencil) != 0).any()


def test_tile_bins_list_every_overlap_in_order():
    rng = np.random.default_rng(3)
    x0 = rng.integers(0, 60, 200)
    y0 = rng.integers(0, 40, 200)
    bbox = np.stack([x0, x0 + rng.integers(0, 20, 200),
                     y0, y0 + rng.integers(0, 20, 200)], 1)
    active = rng.random(200) > 0.2
    off, items = rc.tile_bins(torch.from_numpy(bbox), torch.from_numpy(active),
                              40, 60, tile=16)
    off, items = off.numpy(), items.numpy()
    n_tx = 4
    for t in range(len(off) - 1):
        ty, tx = divmod(t, n_tx)
        want = [i for i in range(200) if active[i]
                and bbox[i, 0] < (tx + 1) * 16 and bbox[i, 1] > tx * 16
                and bbox[i, 2] < (ty + 1) * 16 and bbox[i, 3] > ty * 16]
        assert items[off[t]:off[t + 1]].tolist() == want


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_inputs(stage_inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return {name: (tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                         for a in args), kw)
            for name, (args, kw) in stage_inputs.items()}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_inputs, name):
    """The hand-written kernel against its plain version on the same CUDA
    tensors: bit-identical (both round op by op)."""
    rc.reset_launches()
    args, kw = cuda_inputs[name]
    fn, key = CASES[name]
    got = getattr(rc, fn)(*args, **kw)
    torch.cuda.synchronize()
    assert rc.LAUNCHES[key] == 1
    want = getattr(rc, f"{fn}_plain")(*args, **kw)
    assert _equal(got, want)


@pytest.mark.cuda
def test_render_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    frame_gpu = build_scene(tt, gz_torch, device="cuda").render()
    frame_cpu = build_scene(tt, gz_torch, device="cpu").render()
    assert frame_gpu.shape == (*RES, 3)
    assert (frame_gpu == frame_cpu).all(-1).mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("shader", ["flat", "gouraud", "pbr", "wireframe",
                                    "points"])
def test_shader_render_on_card_matches_cpu(shader):
    """Every shader on the card (Scene's default device) against the CPU."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    rc.reset_launches()
    scene = build_scene(tt, gz_torch, shader=shader)
    assert scene.device.type == "cuda"
    frame_gpu = scene.render()
    assert rc.LAUNCHES["gbuffer_slim"] == 1
    assert rc.LAUNCHES["lines"] == (1 if shader == "wireframe" else 0)
    frame_cpu = build_scene(tt, gz_torch, shader=shader, device="cpu").render()
    assert (frame_gpu == frame_cpu).all(-1).mean() >= 0.999
