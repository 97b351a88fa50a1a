"""Instancing in the port: ``Model.concat`` and instances that share their
packing, the counterpart of tests/test_instancing.py.

``model @ transform`` shares the mesh's faces, uv, normals and materials by
reference. The port's Scene packs what depends on them once for all such
instances (``Scene._pack_model``): the same device tensors, texture stacks
and slot tables included. ``pipeline.texture_tables`` puts each distinct
stack into the texel pool once, and a compiled program
(``ops/compiled.py``) gives each distinct input tensor one static buffer.

- merged ``Model.concat`` geometry renders like the same instances added as
  separate models: frame and stencil equal, and ``tid`` equal once each id
  is mapped back to its (instance, face);
- the instances' packets hold one tensor per texture map, and the texel
  pool does not grow with the instance count;
- a program whose inputs repeat a tensor has one static buffer for it, and
  the alias pattern is part of the program's key;
- a texture change after the share reaches the next replay;
- a small crowd (4 instances of the textured stand-in mesh on
  ``make_sphere(10, 14)``, culling, shadows, 96²) matches the JAX package
  at the North star's bars (``test_torch_configs.hold``).
"""
import numpy as np
import pytest
import torch

import tpu_renderer as tj
import tpu_renderer_torch as tt
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.ops import pipeline as pl

import bench_torch as bt
from test_torch_configs import hold
from test_torch_kernels import one_torch_thread  # noqa: F401

RES = (96, 96)
SMALL = dict(resolution=RES, tex=32, mesh=(10, 14))
KINDS = ("kd", "norm")


def crowd(n, merged, pkg=tt):
    """bench_torch's crowd of ``n`` instances at a small size, in either
    package (the port's on the CPU)."""
    return bt.build_highpoly_scene(n, merged=merged, pkg=pkg,
                                   device="cpu" if pkg is tt else None,
                                   **SMALL)


def merged_ids(tid, scene):
    """Ids of a scene of separate instances (then the floor) as the merged
    scene numbers the same faces: its instances are one model, padded once
    at the end."""
    f = scene.models[0].num_faces
    n = len(scene.models) - 1
    fp = -(-f // 8) * 8
    inst, face = tid // fp, tid % fp
    floor = n * fp
    merged_floor = -(-n * f // 8) * 8
    return np.where(tid < 0, -1, np.where(
        tid >= floor, tid - floor + merged_floor, inst * f + face))


def test_concat_matches_separate_instances():
    separate, merged = crowd(3, merged=False), crowd(3, merged=True)
    f_sep, f_mer = separate.render(), merged.render()
    np.testing.assert_array_equal(f_sep, f_mer)
    assert torch.equal(separate.last_stencil, merged.last_stencil)
    tid_sep = separate.last_tid.numpy()
    np.testing.assert_array_equal(merged_ids(tid_sep, separate),
                                  merged.last_tid.numpy())
    # Every instance and the floor own pixels; shadows fall.
    fp = -(-separate.models[0].num_faces // 8) * 8
    assert len(np.unique(tid_sep[tid_sep >= 0] // fp)) == 4
    assert (separate.last_stencil != 0).any()


def test_instances_share_their_packing():
    scene = crowd(4, merged=False)
    _, dyn = scene._prepare()
    instances = dyn["models"][:-1]
    for kind in KINDS:
        for key in (f"{kind}_stack", f"{kind}_scale_off", f"{kind}_slot",
                    f"{kind}_shape"):
            assert all(md[key] is instances[0][key] for md in instances), key
    for key in ("vid", "uv", "vn", "inc_edge", "norm_tangent"):
        assert all(md[key] is instances[0][key] for md in instances), key
    # Vertices are each instance's own; the floor shares nothing.
    assert len({id(md["verts"]) for md in instances}) == 4
    assert dyn["models"][-1]["kd_stack"] is not instances[0]["kd_stack"]


def pool_size(scene):
    cfg, dyn = scene._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    _, attrs = pl._build_face_batch(cfg, dyn, cam_m,
                                    verts=pl.stacked_vertices(dyn))
    ftex, slots, pool = pl.texture_tables(cfg, dyn, attrs)
    return pool.numel(), slots.shape[0], ftex


def test_texel_pool_does_not_grow_with_instances():
    """The pool of 4 instances holds the mesh's maps once, as the merged
    model's and one instance's do; every instance's faces point at the same
    slots."""
    scene = crowd(4, merged=False)
    texels, n_slots, ftex = pool_size(scene)
    assert (texels, n_slots) == pool_size(crowd(4, merged=True))[:2]
    assert (texels, n_slots) == pool_size(crowd(1, merged=False))[:2]
    fp = -(-scene.models[0].num_faces // 8) * 8
    per_instance = ftex[:4 * fp].reshape(4, fp, *ftex.shape[1:])
    assert (per_instance == per_instance[:1]).all()
    assert (per_instance[:, :, 0, 0] >= 0).any()


def test_program_copies_a_repeated_tensor_once():
    """One static buffer per distinct input tensor; the body sees a
    repeated tensor as one; the same tree over distinct tensors is another
    program with a buffer each."""
    compiled.clear_compiled()
    seen = []

    def body(inputs, buf):
        a, b, c = inputs
        seen.append(a is b)
        return (a + b + c + buf.sum(),)

    buf = torch.ones(2)
    x, y = torch.arange(4.0), torch.full((4,), 10.0)
    out = compiled.call(("alias",), body, buf, (x, x, y), "cpu")[0]
    prog = compiled.CACHE.last
    assert len(prog._static) == 2 and seen == [True]
    assert torch.equal(out, 2 * x + y + 2)
    builds = compiled.CACHE.builds
    z = torch.arange(4.0) * 3
    out = compiled.call(("alias",), body, buf, (x, z, y), "cpu")[0]
    assert compiled.CACHE.builds == builds + 1
    assert len(compiled.CACHE.last._static) == 3 and seen[-1] is False
    assert torch.equal(out, x + z + y + 2)
    # The first program again: its one buffer refills from the new tensor.
    out = compiled.call(("alias",), body, buf, (z, z, y), "cpu")[0]
    assert compiled.CACHE.builds == builds + 1
    assert compiled.CACHE.last is prog and torch.equal(out, 2 * z + y + 2)


def test_scene_program_has_a_buffer_per_distinct_tensor():
    compiled.clear_compiled()
    scene = crowd(4, merged=False)
    scene.render()
    _, dyn = scene._prepare()
    # The program's inputs are what a frame can change; the face tables are
    # none of them (pipeline._jit).
    inputs = pl._program_inputs(dyn)
    leaves = list(compiled._leaves(inputs))
    prog = compiled.CACHE.last
    assert len(prog._static) == len({id(t) for t in leaves}) < len(leaves)


def test_texture_change_reaches_the_next_replay():
    """The instances' shared diffuse map is replaced (one materials object
    for all, each instance's version bumped): the next frame of the same
    program samples the new map, and the instances still share one
    stack."""
    compiled.clear_compiled()
    scene = crowd(4, merged=False)
    before = scene.render()
    builds = compiled.CACHE.builds
    mat = scene.models[0].materials["default"]
    rng = np.random.default_rng(5)
    mat.map_Kd = (np.round(rng.random(mat.map_Kd.shape) * 255)
                  / 255).astype(np.float32)
    for m in scene.models[:-1]:
        m.bump_version()
    after = scene.render()
    assert compiled.CACHE.builds == builds
    cfg, dyn = scene._prepare()
    np.testing.assert_array_equal(after, pl.render_frame(cfg, dyn)[0].numpy())
    assert (after != before).any()
    assert len({id(md["kd_stack"]) for md in dyn["models"][:-1]}) == 1


@pytest.mark.parametrize("merged", [False, True])
def test_small_crowd_matches_jax(merged):
    scene_t = crowd(4, merged)
    scene_j = crowd(4, merged, pkg=tj)
    hold(scene_t, scene_t.render(), scene_j, scene_j.render())
    assert (scene_t.last_stencil != 0).any()
