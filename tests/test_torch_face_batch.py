"""The vertex stage over every model at once
(``pipeline._build_face_batch``) against the per-model loop it replaced.

- the batched stage returns, key for key and bit for bit, what the loop
  over the models returned: 20 instances and a floor, an instance
  without vertex normals, one with ``clip`` and
  ``depth_test`` off; culling on and off; with and without a debug
  camera; with the Scene's face tables (``dyn["faces"]``) and with the
  tables of ``pipeline.with_face_tables``;
- so do the statistics (``pipeline._stats``, eager and compiled) and the
  debug shaders' vertex pass (``pipeline._debug_vertices``), which read
  the same pass, against frozen copies of their per-model loops;
- the Scene keeps its face tables, and the compiled program that reads
  them, across a texture change, and builds new ones for a material change;
  a texture changed every frame leaves one shared part per mesh in use;
- a Scene program's inputs are each model's vertices and texture maps, the
  light and the background, and nothing else: no per-face table is a
  static buffer; no Scene frame, eager or compiled, builds face tables,
  and a dyn without them (interop.dyn_from_numpy) builds them once a frame;
- the number of ATen operations in the ``tr.vertex`` span of a frame, eager
  or compiled, does not grow with the number of models.

The sharded path's face batch stays covered by tests/test_torch_parallel.py.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.interop import dyn_from_numpy
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops.shadow import _cross
from tpu_renderer_torch.ops.transforms import bound_box_batch, normalize
from tpu_renderer_torch.ops.vertex import (_rowvec, gather_faces,
                                           screen_normal_z,
                                           transform_vertices)

import bench_torch as bt
from test_torch_kernels import one_torch_thread  # noqa: F401

SMALL = dict(resolution=(48, 48), tex=16, mesh=(6, 8))


def loop_face_batch(cfg, dyn, cam_m, dbg_mvp=None):
    """The per-model loop of the vertex stage, as it was before the batched
    pass: the plain version the batched stage is held to."""
    height, width = cfg.resolution
    near, far = cam_m["near"], cam_m["far"]
    raster_parts, attr_parts = [], []
    for m_i, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        va = transform_vertices(md["verts"], cam_m["MVP"], cam_m["viewport"],
                                near, far)
        f = gather_faces(va, md["vid"], height, width, cfg.backface_culling)
        F = md["vid"].shape[0]
        world = f["world"]
        face_normal = normalize(_cross(world[:, 1] - world[:, 0],
                                       world[:, 2] - world[:, 0]))
        vn = md["vn"] if mc.has_vn else face_normal[:, None, :].expand(F, 3, 3)
        dev = world.device
        raster_parts.append({
            "sx": f["sx"], "sy": f["sy"], "inv_w": f["inv_w"], "aff": f["aff"],
            "clip": f["clip"], "bbox": f["bbox"],
            "valid": f["valid"] & md["pad_valid"],
            "clip_en": torch.full((F,), mc.clip, device=dev),
            "z_write": torch.full((F,), mc.depth_test, device=dev),
        })
        if dbg_mvp is not None:
            raster_parts[-1]["clip_dbg"] = _rowvec(
                md["verts"].to(torch.float32), dbg_mvp)[md["vid"].long()]
        attr_parts.append({
            "sx": f["sx"], "sy": f["sy"], "szlin": f["szlin"],
            "world": world, "vn": vn, "face_normal": face_normal,
            "uv": md["uv"], "kd": md["kd"], "ks": md["ks"], "ns": md["ns"],
            "pm": md["pm"], "pr": md["pr"], "ka": md["ka"],
            "kd_slot": md["kd_slot"], "ks_slot": md["ks_slot"],
            "norm_slot": md["norm_slot"], "norm_tangent": md["norm_tangent"],
            "kd_shape": md["kd_shape"], "ks_shape": md["ks_shape"],
            "norm_shape": md["norm_shape"],
            "model_id": torch.full((F,), m_i, dtype=torch.int32, device=dev),
        })
    cat = lambda parts: {k: torch.cat([p[k] for p in parts], dim=0)
                         for k in parts[0]}
    return cat(raster_parts), cat(attr_parts)


def loop_stats(cfg, dyn, cam_m, tid):
    """The per-model loop of ``pipeline._stats``, as it was before it read
    the one vertex pass: the plain version the statistics are held to."""
    height, width = cfg.resolution
    device = tid.device
    g_total = sum(md["vid"].shape[0] for md in dyn["models"])
    ids = tid.reshape(-1).long()
    fg = ids >= 0
    owned = torch.zeros(g_total + 1, dtype=torch.int32, device=device)
    owned.index_add_(0, torch.where(fg, ids, g_total), fg.to(torch.int32))

    stats = []
    offset = 0
    for md in dyn["models"]:
        va = transform_vertices(md["verts"], cam_m["MVP"], cam_m["viewport"],
                                cam_m["near"], cam_m["far"])
        vid = md["vid"].long()
        n = vid.shape[0]
        screen = va["screen"][vid]
        sx, sy, sz = screen[..., 0], screen[..., 1], screen[..., 2]
        real = md["pad_valid"]
        culled = (real & (screen_normal_z(sx, sy, sz) < 0)
                  if cfg.backface_culling else torch.zeros_like(real))
        v0x, v0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
        v1x, v1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
        d01 = v0x * v1x + v0y * v1y
        denom = ((v0x * v0x + v0y * v0y) * (v1x * v1x + v1y * v1y)
                 - d01 * d01)
        degenerate = real & ~culled & (denom == 0)
        _, box_valid = bound_box_batch(torch.stack([sx, sy], -1), height,
                                       width)
        offscreen = real & ~culled & ~degenerate & ~box_valid
        rendered = real & (owned[offset:offset + n] > 0)
        leftover = real & ~culled & ~degenerate & ~offscreen & ~rendered
        stats.append({"total": real.sum(), "rendered": rendered.sum(),
                      "backface_culled": culled.sum(),
                      "degenerate": degenerate.sum(),
                      "offscreen": offscreen.sum(),
                      "occluded_or_clipped": leftover.sum()})
        offset += n
    return stats


def loop_debug_vertices(dyn, cam_m):
    """The per-model loop of ``pipeline._debug_vertices``, as it was before
    it read the one vertex pass."""
    sxs, sys_, szs, fns, valids = [], [], [], [], []
    for md in dyn["models"]:
        va = transform_vertices(md["verts"], cam_m["MVP"], cam_m["viewport"],
                                cam_m["near"], cam_m["far"])
        vid = md["vid"].long()
        screen = va["screen"][vid]
        sxs.append(screen[..., 0])
        sys_.append(screen[..., 1])
        szs.append(va["zlin"][vid])
        world = va["world"][vid]
        n = _cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
        nn = torch.linalg.vector_norm(n, dim=1, keepdim=True)
        fns.append(n / torch.where(nn == 0, torch.ones_like(nn), nn))
        valids.append(md["pad_valid"])
    return (torch.cat(sxs), torch.cat(sys_), torch.cat(szs), torch.cat(fns),
            torch.cat(valids))


def crowd(n, cull=True, device="cpu"):
    """bench_torch's crowd of ``n`` separate instances and its floor, small."""
    return bt.build_highpoly_scene(n, merged=False, cull=cull, device=device,
                                   **SMALL)


def scene_of(kind, cull, debug, device="cpu"):
    if kind == "crowd":
        scene = crowd(20, cull, device)
    else:
        scene = crowd(4, cull, device)
        model = scene.models[1 if kind == "no_normals" else 2]
        if kind == "no_normals":
            model.normals = None
        else:
            model.clip = model.depth_test = False
    if debug:
        scene.debug_camera = tt.Camera((6.0, 5.0, 2.0), center=(0, 0, 0),
                                       near=0.5, far=30)
    return scene


def bits(t):
    """A tensor's elements as bits: float32 read as int32, so that -0.0 and
    every NaN compare exactly."""
    t = t.contiguous()
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def assert_same(got, want):
    """Two (raster, attrs) pairs are equal key for key, in order, each
    tensor with the same dtype and shape and bit for bit."""
    for g, w in zip(got, want):
        assert list(g) == list(w)
        for k in w:
            assert (g[k].dtype, g[k].shape) == (w[k].dtype, w[k].shape), k
            assert torch.equal(bits(g[k]), bits(w[k])), k


def face_batch_cases(cfg, dyn, device):
    """(cam_m, dbg_mvp, the loop's batch, ``dyn`` with the face tables of
    ``with_face_tables`` in place of the Scene's)."""
    cam_m = pl._cam_matrices(cfg, dyn["camera"], device)
    dbg = pl._debug_mvp(cfg, dyn, device)
    want = loop_face_batch(cfg, dyn, cam_m, dbg)
    built = dict(dyn)
    del built["faces"]
    built = pl.with_face_tables(cfg, built)
    assert built["faces"] is not dyn["faces"]
    return cam_m, dbg, want, built


def face_batch(cfg, dyn, cam_m, dbg=None):
    """The vertex stage as render_core runs it."""
    return pl._build_face_batch(cfg, dyn, cam_m, dbg,
                                verts=pl.stacked_vertices(dyn))


@pytest.mark.parametrize("debug", [False, True], ids=["", "debug"])
@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
@pytest.mark.parametrize("kind", ["crowd", "no_normals", "no_clip_depth"])
def test_batched_face_batch_equals_the_per_model_loop(kind, cull, debug):
    scene = scene_of(kind, cull, debug)
    cfg, dyn = scene._prepare()
    if kind == "crowd":
        assert len(cfg.models) == 21
    elif kind == "no_normals":
        assert not cfg.models[1].has_vn and cfg.models[0].has_vn
    else:
        assert not (cfg.models[2].clip or cfg.models[2].depth_test)
    assert cfg.backface_culling == cull and cfg.has_debug_camera == debug
    cam_m, dbg, want, built = face_batch_cases(cfg, dyn, "cpu")
    assert_same(face_batch(cfg, dyn, cam_m, dbg), want)
    assert_same(face_batch(cfg, built, cam_m, dbg), want)


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
@pytest.mark.parametrize("kind", ["crowd", "no_normals", "no_clip_depth"])
def test_stats_equal_the_per_model_loop(kind, cull):
    """``face_statistics`` and its compiled program, which read the one
    vertex pass and sum per model over ``model_id``, return what the loop
    over the models returned: the same list of dicts, keys in the same
    order, each value a 0-d int64 tensor of the same count."""
    scene = scene_of(kind, cull, False)
    scene.render()
    cfg, dyn = scene._prepare()
    tid = scene.last_tid
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    want = loop_stats(cfg, dyn, cam_m, tid)
    assert sum(int(s["rendered"]) for s in want) > 0
    if cull:
        assert sum(int(s["backface_culled"]) for s in want) > 0
    for got in (pl.face_statistics(cfg, dyn, tid),
                pl.face_statistics_jit(cfg, dyn, tid)):
        assert len(got) == len(want) == len(cfg.models)
        for g, w in zip(got, want):
            assert list(g) == list(w)
            for k in w:
                assert (g[k].dtype, g[k].shape) == (torch.int64, ()), k
                assert int(g[k]) == int(w[k]), k


@pytest.mark.parametrize("cull", [True, False], ids=["cull", "nocull"])
@pytest.mark.parametrize("kind", ["crowd", "no_normals", "no_clip_depth"])
def test_debug_vertices_equal_the_per_model_loop(kind, cull):
    """The wireframe and points shaders' vertex pass returns, bit for bit,
    what the loop over the models returned, whatever the culling: every
    face's screen x, y, linearized z, unit face normal and padding mask;
    and the wireframe frame is the same, eager and compiled."""
    scene = scene_of(kind, cull, False)
    cfg, dyn = scene._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    got = pl._debug_vertices(cfg, dyn, cam_m)
    want = loop_debug_vertices(dyn, cam_m)
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), i
        assert torch.equal(bits(g), bits(w)), i
    scene.shader = "wireframe"
    cfg, dyn = scene._prepare()
    eager = pl.render_debug_frame(cfg, dyn, "wireframe")
    for g, w in zip(pl.render_debug_frame_jit(cfg, dyn, "wireframe"), eager):
        assert torch.equal(g, w)


@pytest.mark.cuda
@pytest.mark.parametrize("debug", [False, True], ids=["", "debug"])
def test_batched_face_batch_equals_the_per_model_loop_on_card(debug):
    """The same at the crowd's size on the card: 20 instances of the
    4,992-face stand-in and the floor, at 1024²."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    scene = bt.build_highpoly_scene(20, merged=False, device="cuda")
    if debug:
        scene.debug_camera = tt.Camera((6.0, 5.0, 2.0), center=(0, 0, 0),
                                       near=0.5, far=30)
    cfg, dyn = scene._prepare()
    cam_m, dbg, want, built = face_batch_cases(cfg, dyn, "cuda")
    assert_same(face_batch(cfg, dyn, cam_m, dbg), want)
    assert_same(face_batch(cfg, built, cam_m, dbg), want)


def test_face_tables_follow_the_packing():
    """A texture change keeps the Scene's face tables and its program; a
    material change makes new tables, which the next frame reads."""
    compiled.clear_compiled()
    scene = crowd(3)
    _, dyn = scene._prepare()
    faces = dyn["faces"]
    scene.render()
    builds = compiled.CACHE.builds
    material = scene.models[0].materials["default"]

    def check():
        frame = scene.render()
        cfg, dyn = scene._prepare()
        np.testing.assert_array_equal(frame,
                                      pl.render_frame(cfg, dyn)[0].numpy())
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
        assert_same(face_batch(cfg, dyn, cam_m),
                    loop_face_batch(cfg, dyn, cam_m))
        return frame, dyn

    rng = np.random.default_rng(3)
    material.map_Kd = rng.random(material.map_Kd.shape).astype(np.float32)
    for m in scene.models[:3]:
        m.bump_version()
    painted, dyn = check()
    assert dyn["faces"] is faces
    assert compiled.CACHE.builds == builds

    # The diffuse map hides Kd; a strong Ks shows in the highlights.
    material.Ks = np.array([8.0, 8.0, 8.0], np.float32)
    for m in scene.models[:3]:
        m.bump_version()
    recoloured, dyn = check()
    assert dyn["faces"] is not faces
    assert torch.equal(dyn["faces"]["ks"][0], torch.tensor([8.0, 8.0, 8.0]))
    assert compiled.CACHE.builds == builds + 1
    assert (painted != recoloured).any()


def test_texture_changed_every_frame_keeps_one_part():
    """A diffuse map changed before every frame, as a user paints, leaves
    the Scene one shared part per mesh (not one per frame), each frame as
    the eager path renders it; a model taken out of the scene and put back
    renders from the packet it left."""
    compiled.clear_compiled()
    scene = crowd(3)
    scene.render()
    builds = compiled.CACHE.builds
    parts = len(scene._shared)
    material = scene.models[0].materials["default"]
    rng = np.random.default_rng(5)
    for _ in range(6):
        material.map_Kd = rng.random(material.map_Kd.shape).astype(np.float32)
        for m in scene.models[:3]:
            m.bump_version()
        frame = scene.render()
        assert len(scene._shared) == parts
        cfg, dyn = scene._prepare()
        np.testing.assert_array_equal(frame,
                                      pl.render_frame(cfg, dyn)[0].numpy())
    assert compiled.CACHE.builds == builds
    floor = scene.models.pop()
    scene.render()
    scene.models.append(floor)
    frame = scene.render()
    assert len(scene._shared) == parts
    cfg, dyn = scene._prepare()
    np.testing.assert_array_equal(frame, pl.render_frame(cfg, dyn)[0].numpy())


def program_leaves(dyn):
    """The tensors a program of ``dyn`` may take as inputs, by their place:
    each model's vertices and texture maps (stack and scale, offset), the
    light, and the background colour or the skybox."""
    maps = [f"{kind}_{part}" for kind in ("kd", "norm", "ks")
            for part in ("stack", "scale_off")]
    models = [{k: md[k] for k in ["verts"] + maps if k in md}
              for md in dyn["models"]]
    return {"models": models,
            **{k: dyn[k] for k in ("light", "background_color", "skybox")
               if k in dyn}}


@pytest.mark.parametrize("shader", ["general", "gouraud", "points"])
@pytest.mark.parametrize("background", ["color", "cubemap"])
def test_scene_program_inputs_are_what_a_frame_changes(background, shader):
    """The input tree of a Scene's program is exactly each model's vertices
    and texture maps, the light and the background; its static buffers are
    those tensors', one per distinct tensor, so no per-face table is a
    static buffer or a copy of a frame."""
    compiled.clear_compiled()
    scene = crowd(3)
    scene.shader = shader
    if background == "cubemap":
        scene.skybox = tt.CubeMap(**bt.cubemap_faces(8))
    scene.render()
    prog = compiled.CACHE.last
    _, dyn = scene._prepare()
    want = program_leaves(dyn)
    assert prog._tree == compiled._structure((want, ()))
    leaves = list(compiled._leaves(want))
    distinct = {id(t): t for t in leaves}
    assert len(prog._static) == len(distinct) < len(leaves)
    for buf, t in zip(prog._static, distinct.values()):
        assert (buf.shape, buf.dtype) == (t.shape, t.dtype)
    n_faces = dyn["faces"]["vid"].shape[0]
    assert not any(b.shape[:1] == (n_faces,) for b in prog._static)


def interop_dyn(dyn):
    """``dyn`` carried through ``interop.dyn_from_numpy``, as a dyn of the
    JAX package arrives: numpy leaves, no face tables."""
    np_tree = lambda t: ({k: np_tree(v) for k, v in t.items()}
                         if isinstance(t, dict) else t.numpy())
    out = dyn_from_numpy({"models": [np_tree(md) for md in dyn["models"]],
                          "camera": np_tree(dyn["camera"]),
                          "light": np_tree(dyn["light"]),
                          "background_color": dyn["background_color"]
                          .numpy()}, "cpu")
    assert "faces" not in out
    return out


@pytest.mark.parametrize("path, builds", [
    ("scene-eager", 0), ("scene-compiled", 0), ("interop-eager", 1),
    ("interop-compiled", 1)])
def test_face_tables_are_built_before_the_body(path, builds, monkeypatch):
    """With ``pipeline.face_tables`` counting its calls: a Scene frame,
    eager or compiled, builds no tables once the Scene has packed; a dyn
    without them builds them once per frame, and renders the Scene's
    frame."""
    compiled.clear_compiled()
    scene = crowd(3)
    cfg, dyn = scene._prepare()
    want = pl.render_frame(cfg, dyn)
    calls = []
    build = pl.face_tables
    monkeypatch.setattr(pl, "face_tables",
                        lambda *a: calls.append(1) or build(*a))
    if path.startswith("interop"):
        dyn = interop_dyn(dyn)
    got = (pl.render_frame(cfg, dyn) if path.endswith("eager")
           else pl.render_frame_jit(cfg, dyn))
    if path == "scene-compiled":
        # Scene.render packs from its caches and replays the program.
        scene.render()
    assert len(calls) == builds
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def vertex_ops(run):
    """The ATen operations inside the ``tr.vertex`` span of ``run()``, by
    name, counted under torch.profiler on the CPU."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        run()
    counts = {}
    for evt in prof.events():
        if not evt.name.startswith("aten::"):
            continue
        parent = evt.cpu_parent
        while parent is not None and parent.name != "tr.vertex":
            parent = parent.cpu_parent
        if parent is not None:
            counts[evt.name] = counts.get(evt.name, 0) + 1
    return counts


@pytest.mark.parametrize("path", ["eager", "compiled"])
def test_vertex_span_ops_do_not_grow_with_models(path):
    """The vertex stage of 1 and of 20 instances (and the floor) runs the
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
        counts.append(vertex_ops(run))
    assert counts[0] and counts[0] == counts[1]
