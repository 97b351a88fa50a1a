"""The compiled frame's own tracing (utils/profiling.py): the ``tr.`` spans,
the copy counters, the replay stage timers and the capture's two parts.

On the CPU, where a program runs its body eagerly over its static buffers:

- with no profiler running, :func:`profiling.span` never enters
  ``record_function`` (it is made to raise);
- under ``torch.profiler``, a compiled ``Scene.render()`` opens each host
  span (``tr.render``, ``prepare``, ``frame_inputs``, ``fill``, ``launch``,
  ``outputs``, ``readback``) once per frame, each inside ``tr.render``, and
  none inside a ``tr.<stage>`` range, on several paths;
- per call, the copy counters hold the bytes of the program's staging and
  static buffers and of its clones; the light and background sites and the
  readback count a visit each and no transfer (on the CPU they make none);
  the counters outlive ``clear_compiled()`` and :func:`profiling.reset`
  zeroes them, the camera constants' builds and hits among them;
- the debug camera's overlay: ``tr.overlay_cast``, ``tr.overlay_draw``,
  ``tr.overlay_quantize`` and ``tr.readback`` inside ``tr.overlay`` once
  per frame; the overlay counter's frames, segments and line pixels; the
  frame bit-identical with and without a profiler;
- the timers that spans stamp while a graph is recorded (the host's clock
  on the CPU), their bound, and how replays made under a profiler are
  read.

On the card (marked ``cuda``): ``warmup_ms + record_ms == capture_ms``,
the 8 stages' timers in a replayed frame, and the counters per direction
with the ``H·W·3`` copy of the frame to the host.
"""
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.utils import profiling

from test_torch_kernels import (  # noqa: E402,F401
    RES, one_torch_thread, path_scene)

HOST_SPANS = ("render", "prepare", "frame_inputs", "fill", "launch",
              "outputs", "readback")
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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            scene.render()
    spans = [(e.name[3:], e.time_range.start, e.time_range.end)
             for e in prof.events() if e.name.startswith("tr.")]
    by_name = {}
    for name, s, t in spans:
        by_name.setdefault(name, []).append((s, t))
    renders = by_name["render"]
    assert len(renders) == frames
    for name in HOST_SPANS:
        assert len(by_name.get(name, ())) == frames, name
        for s, t in by_name[name]:
            assert any(rs <= s and t <= rt for rs, rt in renders), name
    # No host span inside a stage's range (the stages run inside
    # tr.launch on the CPU), and no capture on the CPU.
    stages = [(s, t) for name, s, t in spans if name in STAGES]
    assert stages
    for name in HOST_SPANS:
        for s, t in by_name[name]:
            assert not any(ss <= s and t <= st for ss, st in stages), name
    assert "warmup" not in by_name and "record" not in by_name


def test_copy_counters_per_call():
    scene = scene_for("general")
    h, w = RES
    scene.render()
    prog = compiled.CACHE.last
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
    # The first frame built the camera's constants; each later one reads them.
    assert snap["camera_constants"] == {"builds": 0, "hits": frames}
    compiled.clear_compiled()
    assert profiling.snapshot() == snap
    profiling.reset()
    assert profiling.snapshot() == profiling._fresh()


def test_camera_constants_are_counted_and_reset():
    profiling.reset()
    assert profiling.snapshot()["camera_constants"] == {"builds": 0,
                                                        "hits": 0}
    profiling.count_camera_constants(built=True)
    for _ in range(3):
        profiling.count_camera_constants(built=False)
    assert profiling.snapshot()["camera_constants"] == {"builds": 1,
                                                        "hits": 3}
    profiling.reset()
    assert profiling.snapshot()["camera_constants"] == {"builds": 0,
                                                        "hits": 0}


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
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for _ in range(frames):
            scene.render()
    spans = sorted((e.time_range.start, e.time_range.end, e.name[3:])
                   for e in prof.events() if e.name.startswith("tr."))
    overlays = [(s, t) for s, t, name in spans if name == "overlay"]
    assert len(overlays) == frames
    for s0, t0 in overlays:
        inside = [name for s, t, name in spans
                  if s0 <= s and t <= t0 and name in OVERLAY_SPANS]
        assert inside == list(OVERLAY_SPANS)


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
