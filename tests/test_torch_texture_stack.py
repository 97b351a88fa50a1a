"""The texture stacks (``models/scene.py`` ``_texture_stack``), quantized on
the Scene's device, against a frozen copy of the numpy quantization they
replaced, bit for bit.

- one map in [0, 1] with texels on and beside every rounding midpoint, a
  tangent normal map in [-1, 1], an RGBA map, maps out of range, several
  material groups with maps of different sizes (one group without a map,
  one naming no material; one stack whose second map alone is below 0),
  and midpoints at the flagship's 1024²: the stack, the slots, shapes,
  tangent flags and (scale, offset) equal the numpy version's, on the CPU
  and on the card;
- a Scene whose diffuse map is painted before every frame carries, each
  frame, the stack of the map as painted.
"""
import types

import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.models.material import Material
from tpu_renderer_torch.models.scene import _texture_stack

import bench_torch as bt
from test_torch_kernels import one_torch_thread  # noqa: F401


def numpy_stack(model, attr):
    """The numpy quantization ``_texture_stack`` replaced, frozen."""
    groups = model.material_group
    entries = []
    for gi, name in enumerate(groups):
        mat = model.materials.get(name, model.materials["default"])
        tex = mat.__dict__.get(attr)
        if tex is not None:
            tangent = bool((tex.dtype.metadata or {}).get("tangent", False))
            entries.append((gi, np.asarray(tex, np.float32), tangent))
    if not entries:
        return None
    th = max(t.shape[0] for _, t, _ in entries)
    tw = max(t.shape[1] for _, t, _ in entries)
    lo = min(float(t.min()) for _, t, _ in entries)
    scale, offset = (2.0, -1.0) if lo < 0 else (1.0, 0.0)

    stack = np.zeros((len(entries), th, tw), np.int32)
    slot = np.full(len(groups), -1, np.int32)
    shape = np.ones((len(groups), 2), np.float32)
    tangent_flags = np.zeros(len(groups), bool)
    for si, (gi, tex, tangent) in enumerate(entries):
        q = np.round(np.clip((tex[..., :3] - offset) / scale, 0, 1) * 255)
        q = q.astype(np.int32)
        stack[si, :tex.shape[0], :tex.shape[1]] = (
            q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16))
        slot[gi] = si
        shape[gi] = tex.shape[:2]
        tangent_flags[gi] = tangent
    return (stack, slot, shape, tangent_flags,
            np.array([scale, offset], np.float32))


def midpoints(rng, shape, lo, hi):
    """Texels in [lo, hi] on, just below and just above the values that
    quantize to a rounding midpoint ((k + 0.5) / 255 after the affine)."""
    scale, offset = (2.0, -1.0) if lo < 0 else (1.0, 0.0)
    k = rng.integers(0, 255, shape)
    mid = ((k + 0.5) / 255 * scale + offset).astype(np.float32)
    step = rng.integers(-1, 2, shape)
    out = np.where(step < 0, np.nextafter(mid, np.float32(-np.inf)),
                   np.where(step > 0, np.nextafter(mid, np.float32(np.inf)),
                            mid))
    return np.clip(out, lo, hi).astype(np.float32)


def model_of(maps, groups=("default",), attr="map_Kd", tangent=None):
    """A stand-in with the two attributes ``_texture_stack`` reads: the
    material groups, and materials carrying ``maps`` (name -> array)."""
    materials = {}
    for name in ("default", *groups):
        mat = materials.setdefault(name, Material())
        if name in maps:
            tex = maps[name]
            if tangent is not None:
                tex = np.asarray(tex, dtype=np.dtype(
                    np.float32, metadata={"tangent": tangent}))
            setattr(mat, attr, tex)
    return types.SimpleNamespace(material_group=list(groups),
                                 materials=materials)


def case(name):
    rng = np.random.default_rng([7, len(name)])
    if name == "midpoints":
        return model_of({"default": midpoints(rng, (33, 17, 3), 0, 1)}), \
            "map_Kd"
    if name == "tangent-normal":
        return model_of({"default": midpoints(rng, (16, 24, 3), -1, 1)},
                        attr="norm", tangent=True), "norm"
    if name == "rgba":
        return model_of({"default": rng.random((12, 9, 4),
                                               dtype=np.float32)}), "map_Kd"
    if name == "out-of-range":
        tex = rng.uniform(-1.5, 1.5, (10, 11, 3)).astype(np.float32)
        tex[0, 0] = [0.0, 1.0, -1.0]
        return model_of({"default": tex}), "map_Kd"
    if name == "groups":
        maps = {"a": midpoints(rng, (8, 20, 3), 0, 1),
                "c": midpoints(rng, (19, 6, 3), 0, 1)}
        return model_of(maps, groups=("a", "b", "c", "unnamed")), "map_Kd"
    if name == "groups-signed":
        maps = {"a": midpoints(rng, (8, 20, 3), 0, 1),
                "c": midpoints(rng, (19, 6, 3), -1, 1)}
        return model_of(maps, groups=("a", "c")), "map_Kd"
    assert name == "flagship-size"
    return model_of({"default": midpoints(rng, (1024, 1024, 3), 0, 1)}), \
        "map_Kd"


CASES = ("midpoints", "tangent-normal", "rgba", "out-of-range", "groups",
         "groups-signed", "flagship-size")


def assert_same_stack(got, want):
    assert (got is None) == (want is None)
    stack, slot, shape, tangent, scale_off = got
    assert stack.dtype == torch.int32 and scale_off.dtype == torch.float32
    np.testing.assert_array_equal(stack.cpu().numpy(), want[0])
    np.testing.assert_array_equal(scale_off.cpu().numpy(), want[4])
    for a, b in zip((slot, shape, tangent), want[1:4]):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", CASES)
def test_stack_equals_the_numpy_quantization(name):
    model, attr = case(name)
    got = _texture_stack(model, attr, "cpu")
    assert got[0].device.type == "cpu"
    assert_same_stack(got, numpy_stack(model, attr))


@pytest.mark.cuda
@pytest.mark.parametrize("name", CASES)
def test_stack_equals_the_numpy_quantization_on_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the card)")
    model, attr = case(name)
    got = _texture_stack(model, attr, "cuda")
    assert got[0].is_cuda and got[4].is_cuda
    assert_same_stack(got, numpy_stack(model, attr))


def test_scene_carries_the_map_as_painted():
    """Each frame's packet holds the stack of the diffuse map as painted
    before it, and the frame renders as the eager path renders it."""
    scene = bt.build_scene(device="cpu", resolution=(24, 24), tex=32)
    material = scene.models[0].materials["default"]
    rng = np.random.default_rng(11)
    work = np.array(material.map_Kd, np.float32)
    for _ in range(3):
        y, x = rng.integers(0, 24, 2)
        work[y:y + 8, x:x + 8] = rng.random(3, dtype=np.float32)
        material.map_Kd = work
        scene.models[0].bump_version()
        frame = scene.render()
        cfg, dyn = scene._prepare()
        np.testing.assert_array_equal(
            dyn["models"][0]["kd_stack"].numpy(),
            numpy_stack(scene.models[0], "map_Kd")[0])
        np.testing.assert_array_equal(
            frame, tt.ops.pipeline.render_frame(cfg, dyn)[0].numpy())
