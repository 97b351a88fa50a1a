"""The vertex stage over every model at once
(``pipeline._build_face_batch``) against the per-model loop it replaced.

- the batched stage returns, key for key and bit for bit, what the loop
  over the models returned: 20 instances and a floor, an instance
  without vertex normals, one with ``clip`` and
  ``depth_test`` off; culling on and off; with and without a debug
  camera; with the Scene's face tables (``dyn["faces"]``) and with tables
  built from the models on the spot;
- the Scene keeps its face tables, and the compiled program that reads
  them, across a texture change, and builds new ones for a material change;
- the number of ATen operations in the ``tr.vertex`` span of a frame, eager
  or compiled, does not grow with the number of models.

The sharded path's face batch stays covered by tests/test_torch_parallel.py.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops.shadow import _cross
from tpu_renderer_torch.ops.transforms import normalize
from tpu_renderer_torch.ops.vertex import (_rowvec, gather_faces,
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
    cam_m = pl._cam_matrices(cfg, dyn["camera"], device)
    dbg = pl._debug_mvp(cfg, dyn, device)
    want = loop_face_batch(cfg, dyn, cam_m, dbg)
    built = dict(dyn)
    del built["faces"]
    return cam_m, dbg, want, built


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
    assert_same(pl._build_face_batch(cfg, dyn, cam_m, dbg), want)
    assert_same(pl._build_face_batch(cfg, built, cam_m, dbg), want)


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
    assert_same(pl._build_face_batch(cfg, dyn, cam_m, dbg), want)
    assert_same(pl._build_face_batch(cfg, built, cam_m, dbg), want)


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
        assert_same(pl._build_face_batch(cfg, dyn, cam_m),
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
