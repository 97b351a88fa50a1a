"""Silhouette compaction in the port's shadow body, on the CPU.

``shadow.prepare_quads`` puts the edges in JAX's stable silhouette-first
order with their count ``n_sil`` on the device, and only those rows are
clipped, projected and packed (``raster_cuda.quad_prep``, K8, whose plain
version runs here) and binned by K4 (``n_rows``). Held here:

- against the JAX package's ``prepare_quads`` on scenes where JAX compacts
  (``caps`` is not None): the flagship stand-in (bench_torch.build_scene)
  at 96² and a crowd of 4 instances: ``n_sil`` equal, the first ``n_sil``
  rows' ``ok`` and clip counts equal, their screen vertices equal at rtol
  1e-5 and ``SCREEN_ATOL`` (XLA contracts multiply-adds, so the rows are
  not bit-equal), and the rendered frames at the North star's bars
  (``test_torch_configs.hold``);
- against the old full-E route (every edge clipped, projected and packed
  by ``pack_quads``, then ``stencil_plain``): the pipeline's shadow stage
  gives exactly its silhouette rows, in the silhouette-first order, zero
  rows after them, and the same stencil, on the flagship, the crowd, the
  ten boxes (cfg6) and cfg3-rh-shadows (sign +1, the spot light's w = 2
  extrusion); a compiled Scene.render() over two frames whose light moves
  so that n_sil shrinks gives that stencil on both;
- on meshes of gloo ranks (1, 2) and (2, 2): the ranks' rows partition the
  one-device rows (rank r the compact rows [r*c, min(n_sil, (r+1)*c)),
  c = ceil(n_sil / n)), and the stencil merged over the tris ranks equals
  the one-device stencil exactly.

This module is imported by the spawned ranks: it imports JAX only inside
tests.
"""
import datetime
import time

import numpy as np
import pytest
import torch
import torch.multiprocessing as mp

import tpu_renderer_torch as tt
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import shadow as sh

import bench_torch as bt
import chip_smoke
from test_torch_kernels import one_torch_thread  # noqa: F401

RES = (96, 96)
SMALL = dict(resolution=RES, tex=32)
#: Frames of the old-route comparison: bench_torch's flagship, a crowd of
#: 4 instances, and two of bench.py's configurations.
FRAMES = ("flagship", "crowd", "cfg6", "cfg3-rh-shadows")
#: Absolute tolerance of the screen vertices against JAX's, beside rtol
#: 1e-5: x and y in pixels, z (viewport depth, about 5e-3 here), w. The
#: shadow quads reach 1000 units from the light, so the clip intersects
#: long edges: XLA's fused multiply-adds in the clip's dot products move a
#: clipped vertex by up to 3.6e-4 world units on the same inputs, and the
#: extrusion's normalize differs by one ulp at 1000 (6.1e-5) on 2% of the
#: coordinates. Measured at 96²: x, y up to 7.4e-4 px, z up to 6.1e-5, w
#: equal; the full-E route differs from JAX by the same rows, compaction
#: changes no arithmetic.
SCREEN_ATOL = (2e-3, 2e-3, 2e-4, 0.0)
#: Mesh shapes (n_rows, n_tris) of the gloo runs, and seconds a spawn may
#: take before its ranks are killed.
MESHES = ((1, 2), (2, 2))
DEADLINE = 120


def build(name, pkg=tt):
    """A frame of FRAMES (the JAX package's Scene for ``pkg=tj``)."""
    device = "cpu" if pkg is tt else None
    if name == "flagship":
        return bt.build_scene(device, pkg=pkg, **SMALL)
    if name == "crowd":
        return bt.build_highpoly_scene(4, merged=True, device=device,
                                       pkg=pkg, mesh=(10, 14), **SMALL)
    return bt.build_config(name, device=device, pkg=pkg, mesh=(10, 14),
                           **SMALL)


def full_route(cfg, dyn, cam_m):
    """The shadow stage before compaction: every edge clipped, projected and
    packed, ok = silhouette and count >= 3. Returns (qdata, qi, sil)."""
    quads, sils = [], []
    for mc, md in zip(cfg.models, dyn["models"]):
        if mc.shadowing and mc.num_edges:
            sil, a, b = sh.silhouette_edges(
                md["verts"], md["vid"], md["pad_valid"], md["inc_edge"],
                md["inc_dir"], md["inc_valid"], dyn["light"]["position"],
                mc.num_edges)
            quads.append(sh.extrude_quads(md["verts"], a, b, dyn["light"],
                                          cfg.light_type))
            sils.append(sil)
    sil = torch.cat(sils)
    screen, counts = sh.clip_project(torch.cat(quads), cam_m)
    qdata, qi = rc.pack_quads(screen, counts, sil & (counts >= 3),
                              *cfg.resolution)
    return qdata, qi, sil


@pytest.mark.parametrize("name", ["flagship", "crowd"])
def test_prepare_quads_matches_jax(name):
    """n_sil, the compacted rows' ok and clip counts, and their screen
    vertices against the JAX package's compacted prepare_quads; then both
    rendered frames at the North star's bars."""
    import jax

    import tpu_renderer as tj
    from tpu_renderer.ops.pipeline import _cam_matrices as cam_jax
    from tpu_renderer.ops.shadow import prepare_quads as prepare_jax

    from test_torch_configs import hold

    scene_j = build(name, tj)
    cfg_j, dyn_j = scene_j._prepare()
    cam_j = cam_jax(cfg_j, dyn_j["camera"], cfg_j.cam_projection_type)
    screen_j, counts_j, ok_j, n_sil_j, caps = jax.jit(
        lambda d: prepare_jax(cfg_j, d, cam_j))(dyn_j)
    assert caps is not None

    scene_t = build(name)
    cfg, dyn = scene_t._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    quad, order, n_sil = sh.prepare_quads(
        cfg, dyn, **chip_smoke.vertex_stage(cfg, dyn, cam_m)[2])
    n = int(n_sil)
    assert n == int(n_sil_j) > 0 and n < quad.shape[0]
    screen, counts = sh.clip_project(quad[order[:n].long()], cam_m)
    np.testing.assert_array_equal(counts.numpy() >= 3,
                                  np.asarray(ok_j)[:n])
    np.testing.assert_array_equal(counts.numpy(), np.asarray(counts_j)[:n])
    slots = np.arange(sh.QUAD_PMAX)[None, :] < counts.numpy()[:, None]
    got, want = screen.numpy()[slots], np.asarray(screen_j)[:n][slots]
    for k, atol in enumerate(SCREEN_ATOL):
        np.testing.assert_allclose(got[:, k], want[:, k], rtol=1e-5,
                                   atol=atol)
    hold(scene_t, scene_t.render(), scene_j, scene_j.render())
    assert (scene_t.last_stencil != 0).any()


@pytest.mark.parametrize("name", FRAMES)
def test_shadow_stage_equals_full_route(name):
    """The pipeline's shadow stage (quad_tables, then K4 with the count)
    against the full-E route: its first n_sil rows are the full route's
    silhouette rows in the silhouette-first order, the rest zero; every
    other row of the full route is inactive; the stencils are equal, and
    so is the rendered frame's."""
    scene = build(name)
    frame = scene.render()
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    qd_full, qi_full, sil = full_route(cfg, dyn, cam_m)
    faces, _, stage = chip_smoke.vertex_stage(cfg, dyn, cam_m)
    qdata, qi, n_sil = sh.quad_tables(cfg, dyn, cam_m, h, w, **stage)
    n = int(n_sil)
    rows = torch.nonzero(sil)[:, 0]
    assert n == len(rows) > 0 and qi.shape[0] == sil.shape[0]
    assert chip_smoke._same((qdata[:n], qi[:n]), (qd_full[rows],
                                                   qi_full[rows]))
    assert (qdata[n:] == 0).all() and (qi[n:] == 0).all()
    assert (qi_full[~sil, 5] == 0).all()
    zb, _ = rc.visibility_plain(rc.pack_faces(faces), rc.face_flags(faces),
                                h, w, cfg.system)
    zc = rc.stencil_scalars(dyn["camera"]["near"], dyn["camera"]["far"])
    want = rc.stencil_plain(qd_full, qi_full, zb, cfg.system, zc)
    assert (want != 0).any()
    assert torch.equal(rc.stencil(qdata, qi, zb, cfg.system,
                                  torch.tensor(zc), n_rows=n_sil), want)
    assert torch.equal(scene.last_stencil, want)
    assert frame.shape == (*RES, 3)
    if name == "cfg3-rh-shadows":
        assert cfg.system == 1


def test_compiled_frames_follow_a_shrinking_count():
    """Scene.render() (one compiled program) over two frames of the
    flagship whose light moves so that n_sil shrinks: each frame's stencil
    equals the full-E route's of that frame, and each frame equals the
    eager frame in all four outputs."""
    from test_torch_kernels import SHRINKING_LIGHTS

    compiled.clear_compiled()
    builds = compiled.CACHE.builds
    scene = build("flagship")
    counts = []
    for pos in SHRINKING_LIGHTS[:2]:
        scene.light.set_position(pos)
        frame = scene.render()
        cfg, dyn = scene._prepare()
        h, w = cfg.resolution
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
        qd_full, qi_full, sil = full_route(cfg, dyn, cam_m)
        counts.append(int(sil.sum()))
        faces, _, _ = chip_smoke.vertex_stage(cfg, dyn, cam_m)
        zb, _ = rc.visibility_plain(rc.pack_faces(faces),
                                    rc.face_flags(faces), h, w, cfg.system)
        zc = rc.stencil_scalars(dyn["camera"]["near"], dyn["camera"]["far"])
        assert torch.equal(scene.last_stencil, rc.stencil_plain(
            qd_full, qi_full, zb, cfg.system, zc))
        want = pl.render_frame(cfg, dyn)
        got = (torch.from_numpy(frame), scene.last_zbuf, scene.last_tid,
               scene.last_stencil)
        assert chip_smoke._same(got, tuple(want))
    assert compiled.CACHE.builds == builds + 1
    assert counts[0] > counts[1] > 0


# ------------------------------------------------------------- ranks

def _rank(rank, world, out_dir, shape):
    """One gloo rank of a ``shape`` = (n_rows, n_tris) mesh: its shard's
    quad tables and count (quad_tables under the tris group), and its
    block of rows of the stencil merged over the tris group (K4's plain
    version on the one-device z-buffer's rows, then SUM), saved."""
    import torch.distributed as dist

    from tpu_renderer_torch.parallel.mesh import all_reduce
    from tpu_renderer_torch.parallel.sharded import (pad_models_for_tris,
                                                     shard_dyn)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        n_rows, n_tris = shape
        mesh = tt.make_render_mesh(n_tris, "cpu")
        row_idx, tris_idx = (mesh.get_local_rank("rows"),
                             mesh.get_local_rank("tris"))
        cfg, dyn = build("flagship")._prepare()
        h, w = cfg.resolution
        lh = h // n_rows
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
        faces, _, _ = chip_smoke.vertex_stage(cfg, dyn, cam_m)
        zb, _ = rc.visibility_plain(rc.pack_faces(faces),
                                    rc.face_flags(faces), h, w, cfg.system)
        group = mesh.get_group("tris")
        shard = pl.with_face_tables(cfg, shard_dyn(
            pad_models_for_tris(dyn, n_tris), n_tris, tris_idx))
        qdata, qi, n = sh.quad_tables(
            cfg, shard, cam_m, h, w, group=group, shard_idx=tris_idx,
            **chip_smoke.vertex_stage(cfg, shard, cam_m)[2])
        zc = torch.tensor(rc.stencil_scalars(dyn["camera"]["near"],
                                             dyn["camera"]["far"]))
        row0 = row_idx * lh
        st = rc.stencil(qdata, qi, zb[row0:row0 + lh].contiguous(),
                        cfg.system, zc, row0=row0, n_rows=n)
        st = all_reduce(st, "sum", group, "stencil")
        np.savez(f"{out_dir}/rank{rank}", qdata.numpy(), qi.numpy(),
                 n.numpy(), st.numpy(), np.array([row_idx, tris_idx, row0]))
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """shape -> per rank, (qdata, qi, count, merged stencil rows, (row_idx,
    tris_idx, row0))."""
    out = {}
    for shape in MESHES:
        d = tmp_path_factory.mktemp(f"mesh{shape[0]}x{shape[1]}")
        world = shape[0] * shape[1]
        ctx = mp.spawn(_rank, args=(world, str(d), shape), nprocs=world,
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
        out[shape] = []
        for r in range(world):
            z = np.load(d / f"rank{r}.npz")
            out[shape].append([z[f"arr_{i}"] for i in range(len(z.files))])
    return out


@pytest.fixture(scope="module")
def one_device():
    """The flagship's one-device tables, count and stencil."""
    scene = build("flagship")
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    faces, _, stage = chip_smoke.vertex_stage(cfg, dyn, cam_m)
    qdata, qi, n = sh.quad_tables(cfg, dyn, cam_m, h, w, **stage)
    zb, _ = rc.visibility_plain(rc.pack_faces(faces), rc.face_flags(faces),
                                h, w, cfg.system)
    zc = rc.stencil_scalars(dyn["camera"]["near"], dyn["camera"]["far"])
    st = rc.stencil_plain(qdata, qi, zb, cfg.system, zc, n_rows=n)
    return qdata.numpy(), qi.numpy(), int(n), st.numpy()


@pytest.mark.parametrize("shape", MESHES)
def test_rank_rows_partition_one_device_rows(ranks, one_device, shape):
    """On each block of rows, the tris ranks' rows below their counts are,
    in rank order, the one-device table's first n_sil rows, each once; each
    rank's count is its stretch of [r*c, min(n_sil, (r+1)*c)); every row
    past a count is zero."""
    qdata, qi, n_sil, _ = one_device
    n_tris = shape[1]
    c = -(-n_sil // n_tris)
    for row_idx in range(shape[0]):
        block = sorted((r for r in ranks[shape] if r[4][0] == row_idx),
                       key=lambda r: r[4][1])
        assert [int(r[2]) for r in block] == [
            max(0, min(n_sil, (t + 1) * c) - t * c) for t in range(n_tris)]
        for col, want in ((0, qdata), (1, qi)):
            got = np.concatenate([r[col][:int(r[2])] for r in block])
            np.testing.assert_array_equal(got, want[:n_sil])
            for r in block:
                assert r[col].shape[0] == -(-qi.shape[0] // n_tris)
                assert (r[col][int(r[2]):] == 0).all()


@pytest.mark.parametrize("shape", MESHES)
def test_merged_stencil_equals_one_device(ranks, one_device, shape):
    """The stencil merged over each block's tris ranks, the blocks stacked
    by row0, equals the one-device stencil exactly; every tris rank of a
    block holds the same merged rows."""
    want = one_device[3]
    assert (want != 0).any()
    blocks = {}
    for r in ranks[shape]:
        row_idx, _, row0 = (int(v) for v in r[4])
        if row_idx in blocks:
            np.testing.assert_array_equal(r[3], blocks[row_idx][1])
        blocks[row_idx] = (row0, r[3])
    got = np.concatenate([st for _, st in sorted(blocks.values(),
                                                 key=lambda b: b[0])])
    np.testing.assert_array_equal(got, want)
