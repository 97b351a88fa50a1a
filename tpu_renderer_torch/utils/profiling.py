"""Profiling and debug instrumentation, in PyTorch.

Counterpart of ``tpu_renderer/utils/profiling.py``, without its
``FrameTimer`` (the benchmark, ``benchmark/``, times frames):

- :func:`span` names a piece of the render path ``tr.<name>``: the
  stages of the frame's body (``ops/pipeline.py``), the merges of the
  sharded path (``parallel/mesh.py``) and the host path of a compiled
  frame (``Scene.render``, ``ops/compiled.py``). With no profiler running
  and no graph being recorded it does nothing. Under ``torch.profiler`` it
  opens a ``record_function`` range, so the trace shows where a frame's
  host and device time go. While a program records its CUDA graph
  (:func:`recording`) it stamps the clock into the graph at its entry and
  at its exit (:class:`Timers`: a one-thread kernel writes the card's
  ``%globaltimer`` into pinned host memory), so every replay times each
  span on the device; the program reads the stamps after a replay made
  under a profiler, once the frame is on the host, waiting on an event
  recorded behind the replay, under ``tr.read_timers`` (:func:`replayed`,
  :func:`read_replay_timers`);
- copy counters: each copy site of the compiled frame (the program's
  static buffers, the scene's per-frame light and background tensors,
  the output clones, the copy of the frame to the host) adds its copies
  and bytes per direction (``h2d``, ``d2d``, ``d2h``; ``h2h`` on the CPU)
  and one visit (:func:`tally`, :func:`count_copies`); the ``fill`` site's
  visits are the compiled calls. The first capture's two parts,
  ``warmup_ms`` and ``record_ms``, are kept (:func:`note_capture`), and
  the debug camera's overlaid frames, their segments
  (:func:`count_overlay`) and their line pixels,
  which K11 adds up on the frame's device (:func:`overlay_counter`). These
  counters and the replay totals are the process's: they live in this
  module, outlive ``compiled.clear_compiled()``, and :func:`snapshot`
  returns them (:func:`reset` zeroes them);
- :func:`trace` is a ``torch.profiler`` scope (CPU and, where there is a
  card, CUDA activity) that writes a Chrome trace, in place of
  ``jax.profiler.trace``; :func:`summarize_device_trace` totals its device
  kernels by name;
- :func:`nan_debug` raises at the first torch op that produces a NaN, in
  place of ``jax_debug_nans``.
"""
from __future__ import annotations

import collections
import contextlib
import copy
import glob
import json
import os
import tempfile
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["span", "Timers", "recording", "replayed", "read_replay_timers",
           "tally", "count_copies", "count_overlay", "overlay_counter",
           "note_capture", "snapshot", "reset", "trace", "nan_debug",
           "summarize_device_trace"]

#: The file :func:`trace` writes into its directory.
TRACE_FILE = "trace.json"
#: Chrome-trace categories of device work: kernels, copies and fills.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")

#: What an untraced span enters: nothing.
_NOTHING = contextlib.nullcontext()
#: The :class:`Timers` of the graph being recorded (:func:`recording`).
_recording = None
#: Timers of replays made under a profiler, not read yet.
_pending = []
#: Span timers one graph can hold.
MAX_TIMERS = 32


def _fresh():
    return {"copies": {}, "replays": 0, "replay_ms": {}, "warmup_ms": None,
            "record_ms": None, "overlay": {"frames": 0, "segments": 0,
                                           "pixels": 0}}


_STATE = _fresh()
#: The overlay's line pixel counters, one (1,) int64 tensor per device
#: (:func:`overlay_counter`), read by :func:`snapshot`.
_OVERLAY_PIXELS = {}


class Timers:
    """The span timers of one program's graph: each span recorded into it
    takes a pair of slots of ``stamps``, int64 clock nanoseconds written
    at the span's entry and exit in stream order, at every replay. On a
    CUDA ``device`` the slots lie in pinned host memory and a one-thread
    kernel writes the card's ``%globaltimer`` into them (``csrc/stamp.cu``);
    on the CPU the host's clock is written. ``done``, on a CUDA device, is
    the event :func:`replayed` records after a replay, on which
    :func:`read_replay_timers` waits."""

    def __init__(self, device):
        self.device = torch.device(device)
        self.names = []
        cuda = self.device.type == "cuda"
        self.stamps = torch.zeros(2 * MAX_TIMERS, dtype=torch.int64,
                                  pin_memory=cuda)
        self.done = torch.cuda.Event() if cuda else None

    def open(self, name):
        """A new pair of slots for span ``name``: its index."""
        if len(self.names) == MAX_TIMERS:
            raise RuntimeError(f"a graph holds at most {MAX_TIMERS} span "
                               "timers")
        self.names.append(name)
        return len(self.names) - 1

    def stamp(self, slot):
        """Write the clock into ``stamps[slot]`` on the current stream."""
        if self.device.type != "cuda":
            self.stamps[slot] = time.perf_counter_ns()
            return
        from tpu_renderer_torch.ops import _build

        err = _build.load().tr_stamp(
            self.stamps.data_ptr(), slot,
            torch.cuda.current_stream(self.device).cuda_stream)
        if err != 0:
            raise RuntimeError(f"CUDA kernel stamp failed to launch: "
                               f"cudaError {err}")

    def read(self):
        """[(span name, ms between its stamps)] of the last replay, once it
        has run."""
        ns = self.stamps.tolist()
        return [(name, (ns[2 * i + 1] - ns[2 * i]) / 1e6)
                for i, name in enumerate(self.names)]


def span(name):
    """A ``tr.<name>`` span: ``with span("vertex"): ...``. Without a
    profiler or a graph being recorded it returns a context that does
    nothing; under a profiler it opens a ``record_function`` range; while a
    graph is recorded it also stamps the clock into the graph at entry and
    at exit (:class:`Timers`)."""
    timers = _recording
    if timers is None and not torch.autograd._profiler_enabled():
        return _NOTHING
    return _span(name, timers)


@contextlib.contextmanager
def _span(name, timers):
    with (torch.profiler.record_function("tr." + name)
          if torch.autograd._profiler_enabled() else _NOTHING):
        if timers is None:
            yield
            return
        i = timers.open(name)
        timers.stamp(2 * i)
        yield
        timers.stamp(2 * i + 1)


@contextlib.contextmanager
def recording(timers):
    """Inside, every :func:`span` takes a pair of slots of ``timers`` and
    stamps them on the current stream: the graph being captured."""
    global _recording
    _recording = timers
    try:
        yield timers
    finally:
        _recording = None


def replayed(timers):
    """Note a replay of a graph recorded with ``timers``, just launched on
    the current stream: under a profiler its span times are read by the
    next :func:`read_replay_timers`, once the event ``timers.done``
    recorded here behind the replay has passed."""
    if timers.names and torch.autograd._profiler_enabled():
        if timers.done is not None:
            timers.done.record(torch.cuda.current_stream(timers.device))
        _pending.append(timers)


def read_replay_timers():
    """Add each noted replay's ms per span to the process's totals and
    count it, under ``tr.read_timers`` where one is noted. Waits for the
    replay alone (its ``done`` event), not for the whole device: call it
    once the frame's outputs are complete (``Scene.render`` does, after
    the copy to the host; the wait is then none), or before the graph
    replays again."""
    if not _pending:
        return
    with span("read_timers"):
        while _pending:
            timers = _pending.pop(0)
            if timers.done is not None:
                timers.done.synchronize()
            totals = _STATE["replay_ms"]
            for name, ms in timers.read():
                totals[name] = totals.get(name, 0.0) + ms
            _STATE["replays"] += 1


def tally(copies):
    """{direction: [copies, bytes]} of ``copies``, (tensor, from device, to
    device) triples; directions are ``h2d``, ``d2d``, ``d2h`` and ``h2h``,
    and a tensor of no bytes copies nothing."""
    out = {}
    for t, src, dst in copies:
        n = t.numel() * t.element_size()
        if n:
            way = (("d" if torch.device(src).type == "cuda" else "h") + "2"
                   + ("d" if torch.device(dst).type == "cuda" else "h"))
            c = out.setdefault(way, [0, 0])
            c[0] += 1
            c[1] += n
    return out


def count_copies(site, copies):
    """One visit of the copy site ``site``, which made ``copies``
    ({direction: [copies, bytes]}, :func:`tally`)."""
    entry = _STATE["copies"].get(site)
    if entry is None:
        entry = _STATE["copies"][site] = {"visits": 0}
    entry["visits"] += 1
    for way, (n, b) in copies.items():
        c = entry.setdefault(way, [0, 0])
        c[0] += n
        c[1] += b


def count_overlay(segments):
    """One frame of the debug camera's overlay (``Scene.render``): the
    ``segments`` it drew (rows of ops/overlay.frustum_segments' table). Its
    line pixels are counted on the frame's device (:func:`overlay_counter`).
    """
    c = _STATE["overlay"]
    c["frames"] += 1
    c["segments"] += segments


def overlay_counter(device):
    """The (1,) int64 tensor on ``device`` to which the overlay (K11 or
    its plain version, ``raster_cuda.overlay``) adds the line pixels it
    writes; :func:`snapshot` reads it, so a frame waits for nothing."""
    device = torch.device(device)
    if device not in _OVERLAY_PIXELS:
        _OVERLAY_PIXELS[device] = torch.zeros(1, dtype=torch.int64,
                                              device=device)
    return _OVERLAY_PIXELS[device]


def note_capture(warmup_ms, record_ms):
    """The two parts of a program's capture; the process keeps its
    first."""
    if _STATE["warmup_ms"] is None:
        _STATE["warmup_ms"], _STATE["record_ms"] = warmup_ms, record_ms


def snapshot():
    """The process's counters, after reading any noted replay: ``copies``
    ({site: {"visits": n, direction: [copies, bytes]}}), ``replays``
    (replays timed), ``replay_ms`` ({span: device ms summed over them}),
    ``warmup_ms`` and ``record_ms`` (the first capture's) and ``overlay``
    ({"frames": n, "segments": s, "pixels": p}, :func:`count_overlay`;
    ``pixels`` read from :func:`overlay_counter`'s tensors, which waits
    for a device's work)."""
    read_replay_timers()
    snap = copy.deepcopy(_STATE)
    snap["overlay"]["pixels"] += sum(int(c.item())
                                     for c in _OVERLAY_PIXELS.values())
    return snap


def reset():
    """Zero the process's counters and drop unread replays."""
    _pending.clear()
    _STATE.clear()
    _STATE.update(_fresh())
    _OVERLAY_PIXELS.clear()


@contextlib.contextmanager
def trace(log_dir=None):
    """A ``torch.profiler`` scope over CPU activity and, where CUDA is
    available, the card's; on exit it writes a Chrome trace (view it with
    Perfetto or chrome://tracing) to ``log_dir/trace.json``. ``log_dir``
    defaults to a new temporary directory. Yields ``log_dir``."""
    from torch.profiler import ProfilerActivity, profile

    if log_dir is None:
        log_dir = tempfile.mkdtemp(prefix="tpu_renderer_torch_trace_")
    os.makedirs(log_dir, exist_ok=True)
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities) as prof:
        yield log_dir
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))


def summarize_device_trace(log_dir) -> list:
    """Device time per kernel name in the newest Chrome trace under
    ``log_dir`` (:func:`trace`'s): [(total_ms, name, source)], largest
    first. ``source`` names the innermost host range or op around the
    kernel's launch (the runtime call with the kernel's ``correlation``, on
    its thread): a ``tr.<stage>`` range for the port's kernels, ``"?"``
    where the trace links none. A trace without device events gives []."""
    files = glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True)
    if not files:
        return []
    with open(max(files, key=os.path.getmtime)) as f:
        events = json.load(f).get("traceEvents", [])
    spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
    host = [e for e in spans if e.get("cat") in ("user_annotation", "cpu_op")]
    launches = {(e.get("args") or {}).get("correlation"): e for e in spans
                if e.get("cat") == "cuda_runtime"}

    def source(kernel):
        launch = launches.get((kernel.get("args") or {}).get("correlation"))
        if launch is None:
            return "?"
        around = [e for e in host
                  if (e.get("pid"), e.get("tid")) == (launch.get("pid"),
                                                      launch.get("tid"))
                  and e["ts"] <= launch["ts"] <= e["ts"] + e["dur"]]
        return max(around, key=lambda e: e["ts"])["name"] if around else "?"

    dur = collections.Counter()
    src = {}
    for e in spans:
        if e.get("cat") in _DEVICE_CATS:
            dur[e["name"]] += e["dur"]
            if src.get(e["name"], "?") == "?":
                src[e["name"]] = source(e)
    return [(d / 1000.0, name, src[name]) for name, d in dur.most_common()]


class _NanCheck(TorchDispatchMode):
    """Raises FloatingPointError when a torch op's floating output holds a
    NaN."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(f"NaN in the output of {func}")
        return out


@contextlib.contextmanager
def nan_debug():
    """Inside the scope, every torch op is checked: the first whose floating
    output holds a NaN raises FloatingPointError (the counterpart of
    ``jax_debug_nans``). Each check waits for the device, so this is for
    debugging only. It sees torch ops only: the CUDA kernels that
    ``ops/raster_cuda.py`` launches through ctypes run unchecked, and only
    the torch ops that read their outputs can catch a NaN they wrote."""
    with _NanCheck():
        yield
