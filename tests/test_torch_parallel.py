"""The port's multi-rank render path against the JAX package, on the CPU.

The cube-over-floor scene of test_torch_kernels.build_scene at 64x64 is
rendered by ``tpu_renderer_torch.render_frame_sharded`` on gloo ranks
(``torch.multiprocessing`` spawn, a FileStore under the test's tmp dir, one
CPU thread per rank) on (rows, tris) meshes (2, 1), (1, 2) and (2, 2) with
the general shader, and (1, 2) with gouraud and pbr. Each frame is held,
at the bars the JAX package holds its own sharded frames to
(tests/test_parallel.py:49-54) — tid >= 99.9% equal, stencil equal, frame
>= 99.9% identical pixels, zbuf within rtol 1e-6 —

- to the JAX package's render_frame_sharded on the same mesh shape
  (virtual CPU devices, Pallas interpret mode, the texture sampler kernel
  on), whose global face ids it shares;
- to the port's own one-device render, its shard-major ids mapped back to
  one-device face indices (``chip_smoke.one_device_ids``).

Every rank must return the same four buffers. The tris shards' shadow
quads must partition the one-device silhouette set. The sharded modes of
the kernels' plain versions (z only, K7, the owned ranges) are held to the
JAX functions they replace, in interpret mode.

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

from chip_smoke import one_device_ids
from test_torch_kernels import (  # noqa: E402,F401
    RES, build_scene, one_torch_thread)

RES_P = (64, 64)
#: The sharded renders, (shader, (n_rows, n_tris)), by world size: one
#: spawn of gloo ranks per world size.
RUNS = {2: (("general", (2, 1)), ("general", (1, 2)), ("gouraud", (1, 2)),
            ("pbr", (1, 2))),
        4: (("general", (2, 2)),)}
CASES = [run for runs in RUNS.values() for run in runs]
#: Seconds a spawn of ranks may take before they are killed.
DEADLINE = 120


def _name(shader, shape):
    return f"{shader}_{shape[0]}x{shape[1]}"


def _rank(rank, world, out_dir, runs):
    """One gloo rank: every run's four buffers, and for a triangle-sharded
    general run its shard's quad tables and count, saved per rank."""
    import torch.distributed as dist

    from tpu_renderer_torch.ops.shadow import quad_tables
    from tpu_renderer_torch.parallel.sharded import (pad_models_for_tris,
                                                     shard_dyn)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        for shader, (n_rows, n_tris) in runs:
            mesh = tt.make_render_mesh(n_tris, "cpu")
            scene = build_scene(tt, gz_torch, resolution=RES_P, shader=shader,
                                device="cpu")
            cfg, dyn = scene._prepare()
            out = [t.numpy() for t in tt.render_frame_sharded(cfg, dyn, mesh)]
            if n_tris > 1 and shader == "general":
                idx = mesh.get_local_rank("tris")
                shard = pl.with_face_tables(cfg, shard_dyn(
                    pad_models_for_tris(dyn, n_tris), n_tris, idx))
                cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
                verts = pl.stacked_vertices(shard)
                _, attrs = pl._build_face_batch(cfg, shard, cam_m,
                                                verts=verts)
                out += [t.numpy() for t in quad_tables(
                    cfg, shard, cam_m, *RES_P, group=mesh.get_group("tris"),
                    shard_idx=idx, verts=verts, world=attrs["world"])]
            np.savez(f"{out_dir}/{_name(shader, (n_rows, n_tris))}_{rank}",
                     *out)
    finally:
        dist.destroy_process_group()


def _spawn(world, out_dir, runs):
    """Run ``world`` ranks of :func:`_rank`; kill them and fail after
    DEADLINE seconds."""
    ctx = mp.spawn(_rank, args=(world, str(out_dir), runs), nprocs=world,
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


@pytest.fixture(scope="module")
def port_sharded(tmp_path_factory):
    """(shader, shape) -> per rank, the list of its saved arrays."""
    out = {}
    for world, runs in RUNS.items():
        d = tmp_path_factory.mktemp(f"ranks{world}")
        _spawn(world, d, runs)
        for shader, shape in runs:
            out[shader, shape] = []
            for r in range(world):
                z = np.load(d / f"{_name(shader, shape)}_{r}.npz")
                out[shader, shape].append([z[f"arr_{i}"]
                                           for i in range(len(z.files))])
    return out


@pytest.fixture(scope="module")
def port_one_device():
    """shader -> (cfg, the one-device render_frame's four buffers)."""
    out = {}
    for shader in {s for s, _ in CASES}:
        scene = build_scene(tt, gz_torch, resolution=RES_P, shader=shader,
                            device="cpu")
        cfg, dyn = scene._prepare()
        out[shader] = cfg, [t.numpy() for t in pl.render_frame(cfg, dyn)]
    return out


@pytest.fixture(scope="module")
def jax_sharded():
    """(shader, shape) -> the JAX package's render_frame_sharded buffers."""
    import jax

    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax
    from tpu_renderer.parallel.mesh import make_render_mesh
    from tpu_renderer.parallel.sharded import render_frame_sharded

    out = {}
    for shader, (n_rows, n_tris) in CASES:
        scene = build_scene(tj, gz_jax, resolution=RES_P, shader=shader)
        scene.backend = "pallas"
        scene.tex_kernel = True
        cfg, dyn = scene._prepare()
        assert cfg.pallas_interpret
        mesh = make_render_mesh(jax.devices()[:n_rows * n_tris],
                                n_tris=n_tris)
        out[shader, (n_rows, n_tris)] = [
            np.asarray(a) for a in render_frame_sharded(cfg, dyn, mesh)]
    return out


def _hold(got, want, tid_map=None, rtol=1e-6):
    """The JAX package's sharded bars (test_parallel.py:49-54) and tid >=
    99.9% equal, after mapping got's ids through ``tid_map``. zbuf is held
    to ``rtol`` where tid agrees: at the few edge pixels where two renders
    disagree on coverage one side may see background."""
    frame, zbuf, tid, stencil = got[:4]
    if tid_map is not None:
        tid = np.where(tid >= 0, tid_map[np.maximum(tid, 0)], -1)
    assert frame.shape == want[0].shape == (*RES_P, 3)
    same = tid == want[2]
    assert same.mean() >= 0.999
    np.testing.assert_array_equal(stencil, want[3])
    assert (frame == want[0]).all(-1).mean() >= 0.999
    np.testing.assert_allclose(zbuf[same], want[1][same], rtol=rtol)
    assert (tid >= 0).any() and (stencil != 0).any()


@pytest.mark.parametrize("shader,shape", CASES)
def test_sharded_matches_jax(port_sharded, jax_sharded, shader, shape):
    """Against JAX's sharded frame the z-buffer is held to rtol 1e-5, not
    1e-6: XLA's CPU backend contracts a*b + c into fused multiply-adds, and
    the linearized depth amplifies its inputs' ulps ~10x (measured here:
    5.7e-6 at most; test_torch_modules.py holds szlin to 1e-5 for the same
    reason). The port's own sharded and one-device z-buffers agree to 1e-6
    (test_sharded_matches_one_device)."""
    _hold(port_sharded[shader, shape][0], jax_sharded[shader, shape],
          rtol=1e-5)


@pytest.mark.parametrize("shader,shape", CASES)
def test_sharded_matches_one_device(port_sharded, port_one_device, shader,
                                    shape):
    """Every rank returns the same buffers, and they hold to the port's
    one-device frame."""
    ranks = port_sharded[shader, shape]
    for other in ranks[1:]:
        for a, b in zip(ranks[0][:4], other[:4]):
            np.testing.assert_array_equal(a, b)
    cfg, want = port_one_device[shader]
    _hold(ranks[0], want, one_device_ids(cfg, shape[1]))


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
def test_silhouette_shards_partition(port_sharded, port_one_device, shape):
    """The tris shards' compact rows (quad_tables under the group: rank r
    prepares rows [r*c, min(n_sil, (r+1)*c)) of the global
    silhouette-first order, c = ceil(n_sil / n)) partition the one-device
    rows: in rank order they are the one-device table's first n_sil rows,
    each once, and every shard's rows past its count are zero (the port's
    form of test_parallel.py:206-283)."""
    from tpu_renderer_torch.ops.shadow import quad_tables

    scene = build_scene(tt, gz_torch, resolution=RES_P, device="cpu")
    cfg, dyn = scene._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    verts = pl.stacked_vertices(dyn)
    _, attrs = pl._build_face_batch(cfg, dyn, cam_m, verts=verts)
    qdata, qi, n_sil = quad_tables(cfg, dyn, cam_m, *RES_P, verts=verts,
                                   world=attrs["world"])
    n_sil = int(n_sil)
    c = -(-n_sil // shape[1])
    ranks = port_sharded["general", shape][:shape[1]]    # row block 0
    assert n_sil > 0 and [int(r[6]) for r in ranks] == [
        max(0, min(n_sil, (t + 1) * c) - t * c) for t in range(shape[1])]
    for cols, want in ((4, qdata.numpy()), (5, qi.numpy())):
        got = np.concatenate([r[cols][:int(r[6])] for r in ranks])
        np.testing.assert_array_equal(got, want[:n_sil])
        for r in ranks:
            assert (r[cols][int(r[6]):] == 0).all()


def test_shard_dyn_matches_jax_padding():
    """pad_models_for_tris + shard_dyn slice the JAX package's scene, carried
    by interop.dyn_from_numpy with its incidence arrays, as the JAX
    package's pad_models_for_tris + dyn_partition_specs shard it."""
    import jax

    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax
    from tpu_renderer.parallel.sharded import pad_models_for_tris as pad_jax
    from tpu_renderer_torch.interop import dyn_from_numpy
    from tpu_renderer_torch.parallel.sharded import (_FACE_KEYS, _INC_KEYS,
                                                     pad_models_for_tris,
                                                     shard_dyn)

    _, dyn = build_scene(tj, gz_jax, resolution=RES_P)._prepare()
    n_tris = 4
    want = jax.tree_util.tree_map(np.asarray, pad_jax(dyn, n_tris))
    padded = pad_models_for_tris(
        dyn_from_numpy(jax.tree_util.tree_map(np.asarray, dyn), "cpu"),
        n_tris)
    for i in range(n_tris):
        for mw, mg in zip(want["models"], shard_dyn(padded, n_tris,
                                                    i)["models"]):
            assert set(_INC_KEYS) <= set(mg)
            for k in set(_FACE_KEYS + _INC_KEYS) & set(mg):
                n = mw[k].shape[0] // n_tris
                np.testing.assert_array_equal(mg[k].numpy(),
                                              mw[k][i * n:(i + 1) * n],
                                              err_msg=k)


# --------------------------------------------- sharded modes, module by module

#: A block of rows not aligned to the 16-row tiles, for the module cases.
ROW0 = 24
LH = RES[0] - ROW0


@pytest.fixture(scope="module")
def jax_faces():
    """The JAX package's face batch of the test_torch_kernels scene, its
    one-device visibility, and the port's tables packed from that batch."""
    import jax

    import tpu_renderer as tj
    from tpu_renderer.models import gizmos as gz_jax
    from tpu_renderer.ops import pipeline as pl_jax
    from tpu_renderer.ops.raster_xla import render_visibility

    cfg, dyn = build_scene(tj, gz_jax)._prepare()
    cam_m = pl_jax._cam_matrices(cfg, dyn["camera"], cfg.cam_projection_type)
    faces, attrs = jax.jit(
        lambda d, c: pl_jax._build_face_batch(cfg, d, c, None))(dyn, cam_m)
    faces = jax.tree_util.tree_map(np.asarray, faces)
    attrs = jax.tree_util.tree_map(np.asarray, attrs)
    zb, tid = (np.asarray(a) for a in render_visibility(
        faces, *RES, cfg.system))
    t = lambda tree: {k: torch.from_numpy(np.array(v)) for k, v in
                      tree.items()}
    ft, at = t(faces), t(attrs)
    return cfg, faces, attrs, zb, tid, (rc.pack_faces(ft), rc.face_flags(ft),
                                        at)


def _shift(faces, gid0):
    return dict(faces, gid=faces["gid"] + np.int32(gid0))


def test_visibility_z_only_matches_jax(jax_faces):
    """K1's z-only mode on a block of rows from ROW0 vs visibility_pallas
    (want_tid=False); a few ulps apart, because XLA's CPU backend contracts
    a*b + c into fused multiply-adds (test_torch_modules.py)."""
    from tpu_renderer.ops.raster_pallas import visibility_pallas

    cfg, faces, _, _, _, (fdata, flags, _) = jax_faces
    zb_j, none_j = visibility_pallas(faces, LH, RES[1], cfg.system,
                                     interpret=True, row0=ROW0,
                                     want_tid=False)
    zb_t, none_t = rc.visibility(fdata, flags, LH, RES[1], cfg.system,
                                 row0=ROW0, want_tid=False)
    assert none_j is None and none_t is None
    zb_j, zb_t = np.asarray(zb_j), zb_t.numpy()
    fin = np.isfinite(zb_j)
    assert fin.sum() > 500
    np.testing.assert_array_equal(np.isinf(zb_t), ~fin)
    np.testing.assert_allclose(zb_t[fin], zb_j[fin], rtol=5e-7, atol=0)


def test_tidpass_matches_jax(jax_faces):
    """K7's plain version vs tidpass_pallas on the same merged z-buffer
    block, ids offset by gid0: >= 99.9% equal (fused multiply-adds, as
    above), and equal to K1's claim offset by gid0 where the z-buffer is
    K1's own."""
    from tpu_renderer.ops.raster_pallas import tidpass_pallas

    cfg, faces, _, zb, tid, (fdata, flags, _) = jax_faces
    gid0 = 40
    zb_block = zb[ROW0:] * cfg.system
    want = np.asarray(tidpass_pallas(_shift(faces, gid0), zb_block, LH,
                                     RES[1], cfg.system, interpret=True,
                                     row0=ROW0))
    got = rc.tidpass(fdata, flags, torch.from_numpy(zb_block.copy()),
                     cfg.system, row0=ROW0, gid0=gid0).numpy()
    assert (want >= gid0).any()
    assert (got == want).mean() >= 0.999
    zb_t, tid_t = rc.visibility(fdata, flags, LH, RES[1], cfg.system,
                                row0=ROW0)
    np.testing.assert_array_equal(
        rc.tidpass(fdata, flags, zb_t, cfg.system, row0=ROW0,
                   gid0=gid0).numpy(),
        torch.where(tid_t >= 0, tid_t + gid0, tid_t).numpy())


@pytest.mark.parametrize("layout", ["general", "flat", "gouraud", "pbr"])
def test_owned_gbuffer_matches_jax(jax_faces, layout):
    """K2's and K5's owned range vs gbuffer_pallas with faces["gid"]
    offset by gid0 = G: the pixels of even faces carry ids in the shard's
    range [G, 2G), those of odd faces another shard's ids; only the
    former are written, within 1e-5 (fused multiply-adds), the rest zero."""
    from tpu_renderer.ops.raster_pallas import gbuffer_pallas

    cfg, faces, attrs, _, tid, (fdata, _, at) = jax_faces
    g = fdata.shape[0]
    block = tid[ROW0:]
    merged = np.where((block >= 0) & (block % 2 == 0), block + g, block)
    want = np.asarray(gbuffer_pallas(
        _shift(faces, g), attrs, merged, LH, RES[1], interpret=True,
        row0=ROW0, gb_layout=layout))
    m = torch.from_numpy(merged)
    if layout == "general":
        got = rc.gbuffer(fdata, rc.pack_face_attrs(at), m, row0=ROW0, gid0=g)
    else:
        got = rc.gbuffer_slim(fdata, rc.pack_slim_attrs(at, layout), m,
                              layout, row0=ROW0, gid0=g)
    got = got.numpy()
    own = merged >= g
    assert own.any() and ((merged >= 0) & ~own).any()
    np.testing.assert_allclose(got[:, own], want[:, own], rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_array_equal(got[:, ~own], 0.0)
    np.testing.assert_array_equal(want[:, ~own], 0.0)
