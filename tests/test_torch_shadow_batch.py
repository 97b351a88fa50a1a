"""The shadow pass over every shadowing model at once
(``shadow.prepare_quads``, ``shadow.quad_tables``) against the per-model
loop it replaced.

- the batched pass returns, bit for bit and in every row (the rows of
  edges off the silhouette too), what the loop over the models returned:
  20 instances and a floor that casts no shadow, a model that casts none
  between two that do, a shadowing model without edges, no shadowing
  model at all; a point and a directional light; culling on and off; with
  the Scene's edge tables (``dyn["faces"]["edges"]``) and with the tables
  of ``pipeline.with_face_tables``; and so do its quad tables, and the
  stage as ``pipeline.render_core`` runs it, on the vertex stage's
  stacked vertices and face positions;
- the Scene keeps its edge tables, and the compiled program that reads
  them, across a texture change, and builds new ones, and one new
  program, for a change of shadowing or of mesh;
- the number of ATen operations in the ``tr.shadow_quads`` span of a
  frame, eager or compiled, does not grow with the number of models;
- on two gloo ranks that each hold a shard of a crowd's faces, every rank
  sees the one-device quads in every row and the one-device order, and
  the ranks' rows partition the one-device rows;
- on the card, at the crowd's size, the quad tables and the stencil equal
  the loop's.
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
from tpu_renderer_torch.ops.lightning import Lightning

import bench_torch as bt
from test_torch_kernels import one_torch_thread  # noqa: F401

SMALL = dict(resolution=(48, 48), tex=16, mesh=(6, 8))
LIGHTS = {"point": Lightning.POINT_LIGHTNING,
          "directional": Lightning.DIRECTIONAL_LIGHTNING}
#: Seconds the gloo ranks may take before they are killed.
DEADLINE = 120


def loop_silhouette(verts, vid, pad_valid, inc_edge, inc_dir, inc_valid,
                    light_position, num_edges):
    """One model's silhouette as the per-model pass computed it."""
    world = verts[vid.long()][..., :3]
    n = sh._cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
    light_facing = (sh._dot3(n, light_position) > 0) & pad_valid
    inc_lf = light_facing[:, None].expand(-1, 3).reshape(-1) & inc_valid
    edge = inc_edge.long()
    parity = torch.zeros(num_edges, dtype=torch.int32, device=verts.device)
    parity.index_add_(0, edge, inc_lf.to(torch.int32))
    order = torch.where(inc_lf, torch.arange(inc_lf.shape[0],
                                             device=verts.device),
                        torch.full_like(edge, -1))
    last = torch.full((num_edges,), -1, dtype=torch.int64,
                      device=verts.device)
    last.scatter_reduce_(0, edge, order, reduce="amax", include_self=True)
    silhouette = (parity & 1) == 1
    ab = inc_dir.long()[torch.clamp(last, 0, inc_dir.shape[0] - 1)]
    return silhouette, ab[:, 0], ab[:, 1]


def loop_prepare_quads(cfg, dyn):
    """The per-model loop of the shadow pass, as it was before the batched
    pass: the plain version the batched pass is held to."""
    light = dyn["light"]
    quads, flags = [], []
    for mc, md in zip(cfg.models, dyn["models"]):
        if not mc.shadowing or mc.num_edges == 0:
            continue
        sil, a_vid, b_vid = loop_silhouette(
            md["verts"], md["vid"], md["pad_valid"], md["inc_edge"],
            md["inc_dir"], md["inc_valid"], light["position"], mc.num_edges)
        quads.append(sh.extrude_quads(md["verts"], a_vid, b_vid, light,
                                      cfg.light_type))
        flags.append(sil)
    if not quads:
        return None
    return (torch.cat(quads, dim=0),
            *sh.silhouette_order(torch.cat(flags, dim=0)))


def loop_quad_tables(cfg, dyn, cam_m):
    """K8's tables of :func:`loop_prepare_quads`: (qdata, qi, count)."""
    prepared = loop_prepare_quads(cfg, dyn)
    if prepared is None:
        return None
    qdata, qi = rc.quad_prep(*prepared, cam_m["frustum_planes"],
                              cam_m["MVP"], cam_m["viewport"],
                              *cfg.resolution)
    return qdata, qi, prepared[2]


def crowd(n, cull=True, device="cpu", **kw):
    """bench_torch's crowd of ``n`` separate instances and its floor."""
    return bt.build_highpoly_scene(n, merged=False, cull=cull, device=device,
                                   **{**SMALL, **kw})


def scene_of(kind, cull, light):
    """The scene of a case of the equality test."""
    if kind == "crowd":
        scene = crowd(20, cull)
    else:
        scene = crowd(3, cull)
        if kind == "between":
            scene.models[1].shadowing = False
        elif kind == "none":
            for m in scene.models:
                m.shadowing = False
        else:                                   # "no_edges"
            m = scene.models[1]
            scene.models.insert(1, tt.Model(
                m.vertices, m.uv, m.normals, m.face_array[:0],
                shadowing=True, materials=m.materials,
                material_group=m.material_group))
    scene.light.light_type = LIGHTS[light]
    return scene


def bits(t):
    """A tensor's elements as bits: float32 read as int32, so that -0.0 and
    every NaN compare exactly."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    """Two tuples of tensors (or both None) are equal element for element,
    each tensor with the same dtype and shape and bit for bit."""
    if want is None:
        assert got is None
        return
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), i
        assert torch.equal(bits(g), bits(w)), i


@pytest.mark.parametrize("tables", ["cached", "built"])
@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
@pytest.mark.parametrize("light", sorted(LIGHTS))
@pytest.mark.parametrize("kind", ["crowd", "between", "no_edges", "none"])
def test_batched_shadow_pass_equals_the_per_model_loop(kind, light, cull,
                                                       tables):
    scene = scene_of(kind, cull, light)
    cfg, dyn = scene._prepare()
    shadowing = [mc.shadowing and mc.num_edges > 0 for mc in cfg.models]
    if kind == "crowd":
        assert len(cfg.models) == 21 and shadowing == [True] * 20 + [False]
    elif kind == "between":
        assert shadowing == [True, False, True, False]
    elif kind == "no_edges":
        assert cfg.models[1].shadowing and cfg.models[1].num_edges == 0
        assert shadowing == [True, False, True, True, False]
    else:
        assert not any(shadowing) and "edges" not in dyn["faces"]
    assert cfg.light_type == LIGHTS[light] and cfg.backface_culling == cull
    if tables == "built":
        dyn = pl.with_face_tables(
            cfg, {k: v for k, v in dyn.items() if k != "faces"})
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    want = loop_prepare_quads(cfg, dyn)
    assert want is None or 0 < int(want[2]) < want[0].shape[0]
    verts = pl.stacked_vertices(dyn)
    _, attrs = pl._build_face_batch(cfg, dyn, cam_m, verts=verts)
    assert_same(sh.prepare_quads(cfg, dyn, verts=verts, world=attrs["world"]),
                want)
    assert_same(sh.quad_tables(cfg, dyn, cam_m, *cfg.resolution,
                               verts=verts, world=attrs["world"]),
                loop_quad_tables(cfg, dyn, cam_m))


def test_edge_tables_follow_the_packing():
    """A texture change keeps the Scene's edge tables and its program; a
    change of shadowing and a change of mesh each make new tables and one
    new program, which the next frame reads."""
    compiled.clear_compiled()
    scene = crowd(3)
    _, dyn = scene._prepare()
    edges = dyn["faces"]["edges"]
    scene.render()
    builds = compiled.CACHE.builds

    def check():
        frame = scene.render()
        cfg, dyn = scene._prepare()
        np.testing.assert_array_equal(frame,
                                      pl.render_frame(cfg, dyn)[0].numpy())
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
        verts = pl.stacked_vertices(dyn)
        _, attrs = pl._build_face_batch(cfg, dyn, cam_m, verts=verts)
        assert_same(sh.quad_tables(cfg, dyn, cam_m, *cfg.resolution,
                                   verts=verts, world=attrs["world"]),
                    loop_quad_tables(cfg, dyn, cam_m))
        return frame, dyn

    rng = np.random.default_rng(3)
    material = scene.models[0].materials["default"]
    material.map_Kd = rng.random(material.map_Kd.shape).astype(np.float32)
    for m in scene.models[:3]:
        m.bump_version()
    painted, dyn = check()
    assert dyn["faces"]["edges"] is edges
    assert compiled.CACHE.builds == builds

    scene.models[1].shadowing = False
    scene.models[1].bump_version()
    unshadowed, dyn = check()
    assert dyn["faces"]["edges"] is not edges
    assert (dyn["faces"]["edges"]["edge_first"].shape[0]
            < edges["edge_first"].shape[0])
    assert compiled.CACHE.builds == builds + 1
    assert (painted != unshadowed).any()
    edges = dyn["faces"]["edges"]

    # The same vertices and faces, each face wound the other way: the
    # same shapes, another mesh.
    m = scene.models[0]
    scene.models[0] = tt.Model(m.vertices, m.uv, m.normals,
                               m.face_array[:, [0, 2, 1]], shadowing=True,
                               materials=m.materials,
                               material_group=m.material_group)
    _, dyn = check()
    assert dyn["faces"]["edges"] is not edges
    assert not torch.equal(dyn["faces"]["edges"]["inc_dir"],
                           edges["inc_dir"])
    assert compiled.CACHE.builds == builds + 2


def shadow_ops(run):
    """The ATen operations that the ``tr.shadow_quads`` span of ``run()``
    calls, by name, counted under torch.profiler on the CPU. Operations
    that another ATen operation calls are left out: which ones a CPU
    kernel calls depends on its tensors' sizes (``zeros`` fills a large
    tensor through ``fill_``, a small one without)."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    counts = {}
    for evt in prof.events():
        if not evt.name.startswith("aten::"):
            continue
        parent = evt.cpu_parent
        while parent is not None and parent.name != "tr.shadow_quads":
            if parent.name.startswith("aten::"):
                break
            parent = parent.cpu_parent
        if parent is not None and parent.name == "tr.shadow_quads":
            counts[evt.name] = counts.get(evt.name, 0) + 1
    return counts


@pytest.mark.parametrize("path", ["eager", "compiled"])
def test_shadow_span_ops_do_not_grow_with_models(path):
    """The shadow stage of 1 and of 20 instances (and the floor) runs the
    same ATen operations, as many of each: nothing in it loops over the
    models."""
    counts = []
    for n in (1, 20):
        scene = crowd(n)
        if path == "eager":
            cfg, dyn = scene._prepare()
            run = lambda: pl.render_frame(cfg, dyn)
        else:
            compiled.clear_compiled()
            scene.render()
            run = scene.render
        counts.append(shadow_ops(run))
    assert counts[0] and counts[0] == counts[1]


# ------------------------------------------------------------- ranks

def _rank(rank, world, out_dir):
    """One of ``world`` gloo ranks over a tris group: its shard of a crowd
    of 3 instances, and the pass under the group, saved."""
    import torch.distributed as dist

    from tpu_renderer_torch.parallel.sharded import (pad_models_for_tris,
                                                     shard_dyn)

    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(f"{out_dir}/store", world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=DEADLINE))
    try:
        scene = crowd(3)
        cfg, dyn = scene._prepare()
        group = dist.new_group(list(range(world)))
        shard = shard_dyn(pad_models_for_tris(dyn, world), world, rank)
        assert "faces" not in shard
        shard = pl.with_face_tables(cfg, shard)
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
        verts = pl.stacked_vertices(shard)
        _, attrs = pl._build_face_batch(cfg, shard, cam_m, verts=verts)
        stage = {"verts": verts, "world": attrs["world"]}
        quad, order, count = sh.prepare_quads(cfg, shard, group, rank,
                                              **stage)
        qdata, qi, n = sh.quad_tables(cfg, shard, cam_m, *cfg.resolution,
                                      group=group, shard_idx=rank, **stage)
        np.savez(f"{out_dir}/rank{rank}", quad.numpy(), order.numpy(),
                 count.numpy(), qdata.numpy(), qi.numpy(), n.numpy())
    finally:
        dist.destroy_process_group()


def test_sharded_pass_sees_the_one_device_quads(tmp_path):
    """Two ranks, each with a shard of every model's faces: every rank's
    quads equal the one-device quads in every row, its order is its
    stretch of the one-device order, and the ranks' quad-table rows below
    their counts are, in rank order, the one-device rows."""
    world = 2
    ctx = mp.spawn(_rank, args=(world, str(tmp_path)), nprocs=world,
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
    ranks = []
    for r in range(world):
        z = np.load(tmp_path / f"rank{r}.npz")
        ranks.append([z[f"arr_{i}"] for i in range(len(z.files))])

    cfg, dyn = crowd(3)._prepare()
    quad, order, n_sil = (t.numpy() for t in loop_prepare_quads(cfg, dyn))
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    qdata, qi, _ = (t.numpy() for t in loop_quad_tables(cfg, dyn, cam_m))
    n_sil = int(n_sil)
    c = -(-n_sil // world)
    assert n_sil > 0
    for r, (q, o, count, *_rest) in enumerate(ranks):
        np.testing.assert_array_equal(q.view(np.int32),
                                      quad.view(np.int32))
        assert int(count) == max(0, min(n_sil, (r + 1) * c) - r * c)
        np.testing.assert_array_equal(o[:int(count)],
                                      order[r * c:r * c + int(count)])
    for col, want in ((3, qdata), (4, qi)):
        got = np.concatenate([r[col][:int(r[5])] for r in ranks])
        np.testing.assert_array_equal(got, want[:n_sil])
        for r in ranks:
            assert (r[col][int(r[5]):] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("light", sorted(LIGHTS))
def test_batched_shadow_tables_equal_the_loop_on_card(light):
    """At the crowd's size on the card (20 instances of the 4,992-face
    stand-in and the floor, 1024²): the pass as render_core runs it gives
    the loop's quads, order and count, K8's quad tables and K4's stencil,
    bit for bit; so does the compiled frame's stencil."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    scene = bt.build_highpoly_scene(20, merged=False, device="cuda")
    scene.light.light_type = LIGHTS[light]
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cuda")
    verts = pl.stacked_vertices(dyn)
    faces, attrs = pl._build_face_batch(cfg, dyn, cam_m, verts=verts)
    assert_same(sh.prepare_quads(cfg, dyn, verts=verts, world=attrs["world"]),
                loop_prepare_quads(cfg, dyn))
    got = sh.quad_tables(cfg, dyn, cam_m, h, w, verts=verts,
                         world=attrs["world"])
    want = loop_quad_tables(cfg, dyn, cam_m)
    assert_same(got, want)
    assert int(want[2]) > 0
    zb, _ = rc.visibility(rc.pack_faces(faces), rc.face_flags(faces), h, w,
                          cfg.system)
    zc = torch.tensor(rc.stencil_scalars(dyn["camera"]["near"],
                                         dyn["camera"]["far"]),
                      device="cuda")
    stencil = rc.stencil(want[0], want[1], zb, cfg.system, zc,
                         n_rows=want[2])
    assert (stencil != 0).any()
    assert torch.equal(rc.stencil(got[0], got[1], zb, cfg.system, zc,
                                  n_rows=got[2]), stencil)
    scene.render()
    torch.cuda.synchronize()
    assert torch.equal(scene.last_stencil, stencil)
