"""K10, the frame's vertex stage in one kernel (``raster_cuda.vertex_faces``,
csrc/vertex.cu), without JAX.

This file imports no JAX, so it also runs on the card's host:

    python -m pytest tests/test_torch_vertex_kernel.py -q

- on the CPU the plain version (``vertex_faces_plain``) returns, array for
  array and bit for bit, the composition it stands for:
  ``pipeline._build_face_batch``, then ``pack_faces``, ``face_flags``,
  ``pack_debug_planes`` and ``pack_face_attrs`` or ``pack_slim_attrs``,
  and the face positions: on the flagship stand-in, the instanced crowd
  with culling and a crowd with a model without vertex normals, with and
  without a debug camera, in each of the four layouts; and on the
  adversarial tables of ``chip_smoke.k10_adversarial_inputs``
  (degenerate, off the frame, back-facing, straddling w = 0, not finite,
  padding rows), whose faces come out valid or not as their kind says;
- the packing constants (``attr_consts``, ``face_bits``), built once per
  packing with the face tables, equal the columns and flags they stand
  for;
- ``render_core``'s vertex stage is one call of ``ops.vertex_faces``;
- on a CUDA card (marker ``cuda``, skipped elsewhere) K10 equals its plain
  version with max abs err 0 on every output (NaN where NaN) at the
  flagship's and the crowd's sizes in each layout, with and without
  culling and a debug camera, and on the adversarial tables in all 16
  instances; a captured K10, replayed after new vertices and another
  camera are copied into its inputs, equals the plain version on them;
  a Scene's compiled frame launches K10 once per replay.
"""
import copy

import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops import raster_cuda as rc

import bench_torch as bt
import chip_smoke
from test_torch_face_batch import bits, scene_of
from test_torch_kernels import one_torch_thread  # noqa: F401

#: The flagship stand-in, small (the card's cases build it at full size).
SMALL_FLAGSHIP = dict(resolution=(96, 96), tex=32)
DEBUG_CAM = dict(position=(6.0, 5.0, 2.0), center=(0, 0, 0), near=0.5,
                 far=30)
SCENES = ("flagship", "crowd", "no_normals")


def scene(kind, debug=False, device="cpu"):
    """A scene of SCENES: the flagship stand-in (no culling), bench_torch's
    crowd of 20 instances (culling), or 4 instances one of which has no
    vertex normals; small on the CPU, full size on the card."""
    if kind == "flagship":
        s = (bt.build_scene("cpu", **SMALL_FLAGSHIP) if device == "cpu"
             else bt.build_scene("cuda"))
    elif device == "cpu":
        s = scene_of("crowd" if kind == "crowd" else "no_normals", True,
                     False)
    else:
        s = bt.build_highpoly_scene(20, merged=False, device="cuda")
    if debug:
        s.debug_camera = tt.Camera(DEBUG_CAM["position"],
                                   center=DEBUG_CAM["center"],
                                   near=DEBUG_CAM["near"],
                                   far=DEBUG_CAM["far"])
    return s


def stage_args(s, layout, device="cpu"):
    """K10's arguments for scene ``s`` in ``layout``, as render_core calls
    it (chip_smoke.vertex_args), with its debug camera where it has one."""
    cfg, dyn = s._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], device)
    args = chip_smoke.vertex_args(cfg, dyn, cam_m,
                                  pl._debug_mvp(cfg, dyn, device))
    return args[:6] + (layout, args[7])


def composition(verts, ft, cam, height, width, culling, layout,
                dbg_mvp=None):
    """The vertex stage as render_core composed it before K10: the face
    batch, then each packer."""
    faces, attrs = rc.face_batch(verts, ft, cam, height, width, culling,
                                 dbg_mvp)
    rows = (rc.pack_face_attrs(attrs) if layout == "general"
            else rc.pack_slim_attrs(attrs, layout))
    return (rc.pack_faces(faces), rc.face_flags(faces),
            rc.pack_debug_planes(faces), rows, attrs["world"])


def assert_bits(got, want):
    """Two output tuples are equal array for array: None where None, the
    same dtype and shape, bit for bit."""
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        if w is None:
            assert g is None, i
            continue
        assert (g.dtype, g.shape) == (w.dtype, w.shape), i
        assert torch.equal(bits(g), bits(w)), i


@pytest.mark.parametrize("debug", [False, True], ids=["", "debug"])
@pytest.mark.parametrize("layout", rc.VERTEX_LAYOUTS)
@pytest.mark.parametrize("kind", SCENES)
def test_plain_equals_the_composition(kind, layout, debug):
    s = scene(kind, debug)
    args = stage_args(s, layout)
    cfg, dyn = s._prepare()
    assert (args[7] is not None) == debug == cfg.has_debug_camera
    assert args[5] == (kind != "flagship")
    got = rc.vertex_faces_plain(*args)
    assert_bits(got, composition(*args))
    # pipeline's adapter gives the same face batch.
    faces, attrs = pl._build_face_batch(cfg, dyn, args[2], args[7],
                                        verts=args[0])
    assert torch.equal(rc.pack_faces(faces), got[0])
    fdata, flags, fdbg, rows, world = got
    g = dyn["faces"]["vid"].shape[0]
    assert rows.shape == (g, rc.ROW_COLS[layout]) and world.shape == (g, 3, 3)
    assert (fdbg is not None) == debug
    assert int((flags & 1).sum()) > 0


@pytest.mark.parametrize("debug", [False, True], ids=["", "debug"])
@pytest.mark.parametrize("culling", [False, True], ids=["", "cull"])
@pytest.mark.parametrize("layout", rc.VERTEX_LAYOUTS)
def test_plain_on_adversarial_faces(layout, culling, debug):
    """The adversarial tables through the plain version: the composition's
    arrays, bit for bit; each named face valid or not as its kind says
    (with culling exactly one winding of the visible face); no padding row
    valid; faces through the camera's plane and the non-finite vertices
    leave non-finite values in their rows, and flag the per-pixel clip
    test where clipping is on."""
    args, kw = chip_smoke.k10_adversarial_inputs(layout, culling, debug)
    got = rc.vertex_faces_plain(*args, **kw)
    assert_bits(got, composition(*args, **kw))
    fdata, flags, fdbg, rows, _ = got
    valid = (flags & 1) > 0
    names = list(chip_smoke.K10_ADV_ROWS)
    for i, (_, want) in enumerate(chip_smoke.K10_ADV_ROWS.values()):
        if want is not None and names[i] not in ("front", "back"):
            assert bool(valid[i]) == want, names[i]
    front, back = names.index("front"), names.index("back")
    assert int(valid[front]) + int(valid[back]) == (1 if culling else 2)
    assert not valid[-chip_smoke.K10_ADV_PAD:].any()
    for name in ("w = 0", "nan", "inf"):
        i = names.index(name)
        assert not torch.isfinite(fdata[i]).all(), name
    ft = args[1]
    near = names.index("near")
    if ft["clip_en"][near]:
        assert flags[near] & 8
    assert (fdbg is not None) == debug
    assert rows.shape == (chip_smoke.K10_ADV_FACES, rc.ROW_COLS[layout])


@pytest.mark.parametrize("kind", SCENES)
def test_attr_consts_equal_the_columns_they_replace(kind):
    """The face tables' prepacked constants: the general row's uv, vn (where
    the face has vertex normals, zero elsewhere) and its columns from kd,
    zero world columns, then the pbr row's pm, pr and ka and a zero
    column; the bits word
    holds has_vn, clip_en, z_write and pad_valid."""
    s = scene(kind)
    cfg, dyn = s._prepare()
    ft = dyn["faces"]
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    _, attrs = pl._build_face_batch(cfg, dyn, cam_m,
                                    verts=pl.stacked_vertices(dyn))
    general = rc.pack_face_attrs(attrs)
    pbr = rc.pack_slim_attrs(attrs, "pbr")
    c = ft["attr_consts"]
    assert c.shape == (ft["vid"].shape[0], rc.C_COLS)
    assert c.dtype == torch.float32 and c.is_contiguous()
    has_vn = ft["has_vn"]
    assert torch.equal(bits(c[:, 9:15]), bits(general[:, 9:15]))
    assert torch.equal(bits(c[has_vn, 15:24]), bits(general[has_vn, 15:24]))
    assert not c[~has_vn, 15:24].any()
    assert torch.equal(bits(c[:, 24:42]), bits(general[:, 24:42]))
    assert not c[:, :9].any()
    assert torch.equal(bits(c[:, 42:47]), bits(pbr[:, 18:23]))
    assert not c[:, 47:].any()
    assert (kind == "no_normals") == bool((~has_vn).any())
    fb = ft["face_bits"]
    assert fb.dtype == torch.int32
    for bit, key in ((rc.FB_HAS_VN, "has_vn"), (rc.FB_CLIP, "clip_en"),
                     (rc.FB_ZWRITE, "z_write"), (rc.FB_REAL, "pad_valid")):
        assert torch.equal((fb & bit) > 0, ft[key]), key


@pytest.mark.parametrize("shader", ["general", "gouraud"])
def test_render_core_calls_the_vertex_wrapper_once(shader):
    """render_core's vertex stage is one call of ``ops.vertex_faces`` with
    the shader's layout, and its outputs are what the frame reads: the
    frame through a counting copy of the plain ops equals the frame."""
    s = scene("flagship")
    s.shader = shader
    cfg, dyn = s._prepare()
    calls = []
    ops = copy.copy(rc.PLAIN)

    def counting(*args):
        calls.append(args[6])
        return rc.vertex_faces_plain(*args)

    ops.vertex_faces = counting
    got = pl.render_frame(cfg, dyn, ops)
    assert calls == [shader]
    for g, w in zip(got, pl.render_frame(cfg, dyn)):
        assert torch.equal(bits(g), bits(w))


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("debug", [False, True], ids=["", "debug"])
@pytest.mark.parametrize("kind", ["flagship", "crowd"])
def test_kernel_equals_plain_on_card(card, kind, debug):
    """K10 against its plain version on the same CUDA tensors, at the
    flagship's (4,994 faces, 1024²) and the crowd's (99,842 faces)
    sizes, in each layout, with the scene's culling and the other: every
    output equal (NaN where NaN); one launch each."""
    args = stage_args(scene(kind, debug, "cuda"), "general", "cuda")
    for layout in rc.VERTEX_LAYOUTS:
        for culling in (False, True):
            a = args[:5] + (culling, layout, args[7])
            rc.reset_launches()
            got = rc.vertex_faces(*a)
            torch.cuda.synchronize()
            assert rc.LAUNCHES["vertex_dbg" if debug else "vertex"] == 1
            want = rc.vertex_faces_plain(*a)
            assert chip_smoke._same(got, want), (layout, culling)
            assert int((got[1] & 1).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("debug", [False, True], ids=["", "debug"])
@pytest.mark.parametrize("culling", [False, True], ids=["", "cull"])
@pytest.mark.parametrize("layout", rc.VERTEX_LAYOUTS)
def test_kernel_on_adversarial_faces_on_card(card, layout, culling, debug):
    args, kw = chip_smoke.k10_adversarial_inputs(layout, culling, debug,
                                                 device="cuda")
    got = rc.vertex_faces(*args, **kw)
    torch.cuda.synchronize()
    assert chip_smoke._same(got, rc.vertex_faces_plain(*args, **kw))
    assert not torch.isfinite(got[0]).all()


@pytest.mark.cuda
def test_captured_kernel_reads_new_vertices_and_camera_on_card(card):
    """One K10 launch captured into a CUDA graph over static vertices and
    camera, replayed after each of three frames' vertices, cameras and
    debug cameras is copied in: each replay equals the plain version on
    that frame's inputs."""
    s = scene("flagship", True, "cuda")
    verts, ft, cam, h, w, culling, layout, dbg = stage_args(s, "general",
                                                            "cuda")
    static = {"verts": verts.clone(), "dbg": dbg.clone(),
              **{k: cam[k].clone() for k in ("MVP", "viewport", "near",
                                              "far")}}
    cam_s = {k: static[k] for k in ("MVP", "viewport", "near", "far")}
    call = lambda: rc.vertex_faces(static["verts"], ft, cam_s, h, w, culling,
                                   layout, static["dbg"])
    call()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with rc.counting_into({}), torch.cuda.graph(graph):
        out = call()
    rng = np.random.default_rng(7)
    for i in range(3):
        t = 2 * np.pi * (i + 1) / 5
        s.camera.set_position((5 * np.cos(t), 3.0, 5 * np.sin(t)))
        s.debug_camera.set_position((6 * np.sin(t), 5.0, 2 * np.cos(t)))
        new = stage_args(s, "general", "cuda")
        moved = new[0] + torch.tensor(rng.normal(scale=0.01, size=(1, 4)),
                                      dtype=torch.float32, device="cuda")
        moved[:, 3] = 1.0
        for k in ("MVP", "viewport", "near", "far"):
            static[k].copy_(new[2][k])
        static["verts"].copy_(moved)
        static["dbg"].copy_(new[7])
        graph.replay()
        torch.cuda.synchronize()
        want = rc.vertex_faces_plain(moved, ft, new[2], h, w, culling, layout,
                                     new[7])
        assert chip_smoke._same(tuple(out), want), i


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["flagship", "crowd"])
def test_replay_launches_the_vertex_kernel_once_on_card(card, kind):
    """A Scene's compiled frame records one K10 launch in its capture, and
    each replay adds one to LAUNCHES."""
    from tpu_renderer_torch.ops import compiled

    compiled.clear_compiled()
    s = scene(kind, device="cuda")
    s.render()
    prog = compiled.CACHE.last
    assert prog.launches["vertex"] == 1 and "vertex_dbg" not in prog.launches
    rc.reset_launches()
    s.render()
    torch.cuda.synchronize()
    assert rc.LAUNCHES["vertex"] == 1
