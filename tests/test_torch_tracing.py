"""The compiled frame's own tracing (utils/profiling.py): the ``tr.`` spans,
the copy counters, the replay stage timers and the capture's two parts.

On the CPU, where a program runs its body eagerly over its static buffers:

- with no profiler running, :func:`profiling.span` never enters
  ``record_function`` (it is made to raise);
- under ``torch.profiler``, a compiled ``Scene.render()`` opens each host
  span (``tr.render``, ``prepare``, ``frame_inputs``, ``program_inputs``,
  ``program_key``, ``fill``, ``launch``, ``outputs``, ``readback``) once
  per frame, each inside ``tr.render``, and none inside a ``tr.<stage>``
  range, on several paths;
- per call, the copy counters hold the bytes of the program's staging and
  static buffers and of its clones; the light and background sites and the
  readback count a visit each and no transfer (on the CPU they make none);
  the counters outlive ``clear_compiled()`` and :func:`profiling.reset`
  zeroes them; the camera constants are built at the first frame and kept
  (``pipeline._CAMERA_CONSTANTS``);
- the debug camera's overlay: ``tr.overlay_cast``, ``tr.overlay_draw``,
  ``tr.overlay_quantize`` and ``tr.readback`` inside ``tr.overlay`` once
  per frame, ``tr.overlay_matrices`` and ``tr.overlay_segments`` inside
  ``tr.overlay_draw``, at most 6 ``tr.overlay_clip`` inside
  ``tr.overlay_segments``; the overlay counter's frames, segments and line
  pixels; the frame bit-identical with and without a profiler;
- the timers that spans stamp while a graph is recorded (the host's clock
  on the CPU), their bound, and how replays made under a profiler are
  read: under ``tr.read_timers``, which opens only when one is noted.

On the card (marked ``cuda``): ``warmup_ms + record_ms == capture_ms``,
the 8 stages' timers in a replayed frame, one ``tr.read_timers`` per
traced frame and none without a noted replay, the overlay's four spans
with ``tr.overlay_kernel``, and the counters per direction with the
``H·W·3`` copy of the frame to the host.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.utils import profiling

from test_torch_kernels import (  # noqa: E402,F401
    RES, one_torch_thread, path_scene)

HOST_SPANS = ("render", "prepare", "frame_inputs", "program_inputs",
              "program_key", "fill", "launch", "outputs", "readback")
STAGES = ("vertex", "visibility", "gbuffer", "sample_textures",
          "shadow_quads", "stencil", "shade", "quantize")
#: Scene.render's branches: the plain frame, supersampling, the debug
#: shaders, the debug camera's host overlay.
RENDER_PATHS = ("general", "ssaa2", "wireframe", "debug_core")


def scene_for(path, device="cpu"):
    scene = path_scene(tt, gz_torch, path, device=device)
    if path == "ssaa2":
        scene.supersample = 2
    return scene


def _nbytes(tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def _traced_spans(scene, frames, activities=(
        torch.profiler.ProfilerActivity.CPU,)):
    """[(start, end, name)] of the host's ``tr.`` ranges of ``frames``
    renders of ``scene`` under a profiler, sorted, names without ``tr.``
    (with CUDA activity a range that launched kernels also appears on the
    device's timeline, which is left out)."""
    with torch.profiler.profile(activities=list(activities)) as prof:
        for _ in range(frames):
            scene.render()
    return sorted((e.time_range.start, e.time_range.end, e.name[3:])
                  for e in prof.events() if e.name.startswith("tr.")
                  and e.device_type == torch.autograd.DeviceType.CPU)


def _inside(spans, outer, name):
    """For each ``outer`` range of ``spans``, the ``name`` ranges within
    it."""
    return [[(s, t) for s, t, n in spans if n == name and s0 <= s
             and t <= t0] for s0, t0, o in spans if o == outer]


def test_untraced_span_enters_no_record_function(monkeypatch):
    def refuse(*args, **kwargs):
        raise AssertionError("record_function entered without a profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.autograd.profiler, "record_function", refuse)
    with profiling.span("vertex"):
        pass
    scene = scene_for("general")
    scene.render()
    scene.render()


@pytest.mark.parametrize("path", RENDER_PATHS)
def test_compiled_render_opens_each_host_span_once_per_frame(path):
    scene = scene_for(path)
    scene.render()
    frames = 2
    spans = _traced_spans(scene, frames)
    by_name = {}
    for s, t, name in spans:
        by_name.setdefault(name, []).append((s, t))
    renders = by_name["render"]
    assert len(renders) == frames
    for name in HOST_SPANS:
        assert len(by_name.get(name, ())) == frames, name
        for s, t in by_name[name]:
            assert any(rs <= s and t <= rt for rs, rt in renders), name
    # No host span inside a stage's range (the stages run inside
    # tr.launch on the CPU), and no capture on the CPU.
    stages = [(s, t) for s, t, name in spans if name in STAGES]
    assert stages
    for name in HOST_SPANS:
        for s, t in by_name[name]:
            assert not any(ss <= s and t <= st for ss, st in stages), name
    assert "warmup" not in by_name and "record" not in by_name


def test_copy_counters_per_call():
    pl._CAMERA_CONSTANTS.clear()
    scene = scene_for("general")
    h, w = RES
    scene.render()
    prog = compiled.CACHE.last
    kept = [id(e) for e in pl._CAMERA_CONSTANTS.values()]
    assert len(kept) == 1
    profiling.reset()
    frames = 3
    for _ in range(frames):
        scene.render()
    snap = profiling.snapshot()
    copies = snap["copies"]
    assert {site: c["visits"] for site, c in copies.items()} == {
        "fill": frames, "outputs": frames, "readback": frames,
        "light": frames, "background": frames}
    # The staging buffer and one static buffer per distinct input.
    assert copies["fill"]["h2h"] == [
        frames * (1 + len(prog._static)),
        frames * _nbytes([prog._buf] + prog._static)]
    # The clones of the four outputs: frame (H, W, 3) uint8, zbuf, tid and
    # stencil (H, W) of 4 bytes each.
    assert copies["outputs"]["h2h"] == [4 * frames,
                                        frames * (h * w * 3 + 3 * h * w * 4)]
    # On the CPU the frame is handed to the host as it lies, and the light
    # and background arrays become tensors without a transfer.
    for site in ("readback", "light", "background"):
        assert set(copies[site]) == {"visits"}, site
    # The first frame built the camera's constants; each later one reads
    # the same entry.
    assert [id(e) for e in pl._CAMERA_CONSTANTS.values()] == kept
    compiled.clear_compiled()
    assert profiling.snapshot() == snap
    profiling.reset()
    assert profiling.snapshot() == profiling._fresh()


def test_camera_constants_are_counted_and_reset():
    """A moving camera's frames keep one entry of the camera constants and
    reuse it; another ``fovy`` builds another, which is then reused."""
    def entries():
        return [id(e) for e in pl._CAMERA_CONSTANTS.values()]

    pl._CAMERA_CONSTANTS.clear()
    scene = scene_for("general")
    scene.render()
    kept = entries()
    assert len(kept) == 1
    for x in (0.5, 1.0, 1.5):
        scene.camera.position = np.float32([x, 3.0, 5.0])
        scene.render()
        assert entries() == kept
    scene.camera.fovy = scene.camera.fovy / 2
    scene.render()
    zoomed = entries()
    assert len(zoomed) == 2 and zoomed[0] == kept[0]
    scene.camera.position = np.float32([2.0, 3.0, 5.0])
    scene.render()
    assert entries() == zoomed


def test_spans_stamp_timers_while_a_graph_records():
    timers = profiling.Timers("cpu")      # the host's clock on the CPU
    with profiling.recording(timers):
        with profiling.span("shadow_quads"):
            with profiling.span("inner"):
                sum(range(10000))
        with profiling.span("stencil"):
            pass
    with profiling.span("after"):
        pass
    assert timers.names == ["shadow_quads", "inner", "stencil"]
    ms = dict(timers.read())
    assert ms["shadow_quads"] >= ms["inner"] > 0 and ms["stencil"] >= 0
    assert not timers.stamps[6:].any()
    profiling.reset()
    profiling.replayed(timers)           # no profiler: nothing to read
    assert profiling.snapshot()["replays"] == 0
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        profiling.replayed(timers)
        profiling.replayed(timers)
        profiling.read_replay_timers()
    snap = profiling.snapshot()
    assert snap["replays"] == 2
    assert snap["replay_ms"] == pytest.approx(
        {name: 2 * v for name, v in ms.items()})
    profiling.reset()


def test_read_timers_opens_only_with_a_noted_replay():
    """``tr.read_timers`` opens once per read of noted replays, never with
    nothing noted: a Scene frame on the CPU notes no replay."""
    timers = profiling.Timers("cpu")
    with profiling.recording(timers):
        with profiling.span("vertex"):
            pass
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.read_replay_timers()
        profiling.replayed(timers)
        profiling.replayed(timers)
        profiling.read_replay_timers()
        profiling.read_replay_timers()
    names = [e.name for e in prof.events() if e.name.startswith("tr.")]
    assert names == ["tr.read_timers"]
    assert profiling.snapshot()["replays"] == 2
    profiling.reset()
    scene = scene_for("general")
    scene.render()
    spans = _traced_spans(scene, 2)
    assert "read_timers" not in {name for _, _, name in spans}


def test_a_graph_holds_a_bounded_number_of_timers():
    timers = profiling.Timers("cpu")
    with profiling.recording(timers):
        for i in range(profiling.MAX_TIMERS):
            with profiling.span(f"s{i}"):
                pass
        with pytest.raises(RuntimeError, match="at most"):
            with profiling.span("one too many"):
                pass


def test_first_capture_parts_are_kept():
    profiling.reset()
    profiling.note_capture(900.0, 40.0)
    profiling.note_capture(10.0, 5.0)
    snap = profiling.snapshot()
    assert (snap["warmup_ms"], snap["record_ms"]) == (900.0, 40.0)
    profiling.reset()


#: The debug camera's overlay inside ``tr.overlay``.
OVERLAY_SPANS = ("overlay_cast", "overlay_draw", "overlay_quantize",
                 "readback")


def test_overlay_spans_nest_inside_the_overlay():
    """The debug camera's frame: under a profiler the casts, the drawing,
    the quantization and the copy of the uint8 frame to the host each open
    once per frame inside ``tr.overlay``, in that order."""
    scene = scene_for("debug_core")
    scene.render()
    frames = 2
    spans = _traced_spans(scene, frames)
    overlays = [(s, t) for s, t, name in spans if name == "overlay"]
    assert len(overlays) == frames
    for s0, t0 in overlays:
        inside = [name for s, t, name in spans
                  if s0 <= s and t <= t0 and name in OVERLAY_SPANS]
        assert inside == list(OVERLAY_SPANS)


def _check_draw_spans(spans, frames, draw):
    """``draw`` (the spans inside ``tr.overlay_draw``, in order) once per
    frame inside it, and 1 to 6 ``tr.overlay_clip`` inside each
    ``tr.overlay_segments``, none outside."""
    draws = [(s, t) for s, t, name in spans if name == "overlay_draw"]
    assert len(draws) == frames
    for s0, t0 in draws:
        inside = [name for s, t, name in spans
                  if s0 <= s and t <= t0 and name in draw]
        assert inside == list(draw)
    clips = _inside(spans, "overlay_segments", "overlay_clip")
    assert len(clips) == frames
    assert all(1 <= len(c) <= 6 for c in clips)
    assert sum(map(len, clips)) == sum(
        name == "overlay_clip" for _, _, name in spans)


def test_overlay_draw_spans_nest_inside_the_draw():
    """On the CPU the debug camera's frame opens ``tr.overlay_matrices``
    and ``tr.overlay_segments`` inside ``tr.overlay_draw`` (K11's call,
    ``tr.overlay_kernel``, is the card's), each face's clipping inside
    the segments."""
    scene = scene_for("debug_core")
    scene.render()
    frames = 2
    spans = _traced_spans(scene, frames)
    _check_draw_spans(spans, frames, ("overlay_matrices", "overlay_segments"))
    assert "overlay_kernel" not in {name for _, _, name in spans}


def test_overlay_counters_and_the_frame_with_and_without_a_profiler():
    """``profiling.snapshot()["overlay"]`` counts each overlaid frame, its
    segments and line pixels; the same frames rendered under a profiler
    are bit-identical, and count the same."""
    scene = scene_for("debug_core")
    scene.render()
    profiling.reset()
    plain = [scene.render() for _ in range(2)]
    zbuf = scene.last_zbuf.clone()
    counted = profiling.snapshot()["overlay"]
    assert counted["frames"] == 2
    assert counted["segments"] > 0 and counted["pixels"] > 50
    profiling.reset()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        traced = [scene.render() for _ in range(2)]
    for a, b in zip(plain, traced):
        assert a.dtype == b.dtype and (a == b).all()
    assert torch.equal(zbuf, scene.last_zbuf)
    assert profiling.snapshot()["overlay"] == counted
    # A frame without the overlay counts nothing.
    scene.debug_overlay = False
    profiling.reset()
    scene.render()
    assert profiling.snapshot()["overlay"] == {"frames": 0, "segments": 0,
                                               "pixels": 0}
    profiling.reset()


# ------------------------------------------------------------- on the card

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


@pytest.mark.cuda
def test_capture_parts_add_up_on_card(card):
    compiled.clear_compiled()
    profiling.reset()
    scene = scene_for("general", device="cuda")
    scene.render()
    prog = compiled.CACHE.last
    assert prog.warmup_ms > 0 and prog.record_ms > 0
    assert prog.warmup_ms + prog.record_ms == prog.capture_ms
    snap = profiling.snapshot()
    assert (snap["warmup_ms"], snap["record_ms"]) == (prog.warmup_ms,
                                                      prog.record_ms)
    # One timer pair per stage span of the frame's body.
    assert sorted(prog.timers.names) == sorted(STAGES)


@pytest.mark.cuda
def test_replay_timers_on_card(card):
    compiled.clear_compiled()
    scene = scene_for("general", device="cuda")
    scene.render()
    profiling.reset()
    scene.render()                      # untraced: no timer is read
    assert profiling.snapshot()["replays"] == 0
    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        for _ in range(2):
            scene.render()
    snap = profiling.snapshot()
    assert snap["replays"] == 2
    assert sorted(snap["replay_ms"]) == sorted(STAGES)
    assert all(ms > 0 for ms in snap["replay_ms"].values())


@pytest.mark.cuda
def test_read_timers_open_per_traced_replay_on_card(card):
    """On the card each traced frame notes its replay and reads it under
    one ``tr.read_timers`` inside ``tr.render``; with nothing noted, a read
    opens none."""
    compiled.clear_compiled()
    scene = scene_for("general", device="cuda")
    scene.render()
    profiling.reset()
    frames = 3
    spans = _traced_spans(scene, frames, (
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA))
    reads = _inside(spans, "render", "read_timers")
    assert [len(r) for r in reads] == [1] * frames
    assert profiling.snapshot()["replays"] == frames
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        profiling.read_replay_timers()
    assert not [e for e in prof.events() if e.name.startswith("tr.")]


@pytest.mark.cuda
def test_overlay_draw_spans_on_card(card):
    """On the card ``tr.overlay_draw`` holds the matrices, the segment
    table and K11's call, in that order."""
    compiled.clear_compiled()
    scene = scene_for("debug_core", device="cuda")
    scene.render()
    frames = 2
    spans = _traced_spans(scene, frames, (
        torch.profiler.ProfilerActivity.CPU,
        torch.profiler.ProfilerActivity.CUDA))
    _check_draw_spans(spans, frames, ("overlay_matrices", "overlay_segments",
                                      "overlay_kernel"))


@pytest.mark.cuda
def test_copy_counters_on_card(card):
    compiled.clear_compiled()
    scene = scene_for("general", device="cuda")
    h, w = RES
    scene.render()
    prog = compiled.CACHE.last
    profiling.reset()
    frames = 2
    for _ in range(frames):
        scene.render()
    copies = profiling.snapshot()["copies"]
    assert copies["fill"]["h2d"] == [frames, frames * _nbytes([prog._buf])]
    assert copies["fill"]["d2d"] == [frames * len(prog._static),
                                     frames * _nbytes(prog._static)]
    assert copies["outputs"]["d2d"] == [4 * frames,
                                        frames * (h * w * 3 + 3 * h * w * 4)]
    assert copies["readback"]["d2h"] == [frames, frames * h * w * 3]
    assert copies["light"]["h2d"][0] == 8 * frames
    assert copies["background"]["h2d"] == [frames, frames * 12]
