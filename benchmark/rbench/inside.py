"""What the system records about its own compiled frame, for the readers
of ``host_ms``, ``idle_ms``, ``replay_ms``, ``copies``, ``copy_bytes``,
``warmup_ms`` and ``record_ms``.

- Spans: the system names the host path of ``Scene.render()`` with
  ``tr.<span>`` ranges (``tpu_renderer_torch.utils.profiling.span``):
  ``tr.render`` around the whole call, and inside it ``tr.prepare``,
  ``tr.frame_inputs``, ``tr.fill``, ``tr.launch``, ``tr.outputs`` and
  ``tr.readback``. They are read from the traced window on the frames'
  thread.
- Counters: ``tpu_renderer_torch.utils.profiling.snapshot()``: per copy
  site its visits and its copies and bytes per direction, the replays
  timed under a profiler with the device ms of each stage, and the first
  capture's warm-up and recording ms.

A system without them (no ``tr.render`` range in the window, no
``snapshot``) gives every reader None. Each metric has a file of its own
under ``metrics/`` (``read = inside.reader(name)``), so that the registry
hands its reader no part: the harness's tests hold a part only for
``stage_ms``.
"""
from __future__ import annotations

import collections
import functools

__all__ = ["self_times", "idle_by_span", "counters", "host_ms", "idle_ms",
           "replay_ms", "per_visit", "copies", "copy_bytes", "capture_part",
           "reader"]

PREFIX = "tr."


def _spans(trace):
    """The window's ``tr.`` ranges on the frames' thread, parents before
    their children."""
    lo, hi = trace.window()
    return sorted((e for e in trace.host
                   if (e.get("pid"), e.get("tid")) == trace.thread
                   and e.get("cat") == "user_annotation"
                   and e["name"].startswith(PREFIX) and lo <= e["ts"] <= hi),
                  key=lambda e: (e["ts"], -e["dur"]))


def _rendered(spans):
    return any(e["name"] == PREFIX + "render" for e in spans)


# Every reader of a kind walks the same trace: the last walk is kept.
@functools.lru_cache(maxsize=1)
def self_times(trace):
    """{span: microseconds} summed over the window: each ``tr.`` range's
    duration less the durations of the ``tr.`` ranges directly inside it;
    None without a ``tr.render`` range."""
    spans = _spans(trace)
    if not _rendered(spans):
        return None
    out = collections.Counter()
    stack = []
    for e in spans:
        while stack and stack[-1]["ts"] + stack[-1]["dur"] <= e["ts"]:
            stack.pop()
        out[e["name"][len(PREFIX):]] += e["dur"]
        if stack:
            out[stack[-1]["name"][len(PREFIX):]] -= e["dur"]
        stack.append(e)
    return out


@functools.lru_cache(maxsize=1)
def idle_by_span(trace):
    """{span or "outside": microseconds}: each idle gap of the window's
    device, by the innermost ``tr.`` range open on the frames' thread at
    its middle (as ``Trace.idle_gaps`` picks its labels); None without a
    ``tr.render`` range."""
    if not _rendered(_spans(trace)):
        return None
    _, gaps = trace.busy()
    out = collections.Counter()
    for s, t in gaps:
        e = trace._innermost(trace.thread, (s + t) / 2, PREFIX)
        out["outside" if e is None else e["name"][len(PREFIX):]] += t - s
    return out


def counters():
    """The system's process-wide counters (a dict), or None where the
    system keeps none."""
    try:
        from tpu_renderer_torch.utils import profiling
    except ImportError:
        return None
    snapshot = getattr(profiling, "snapshot", None)
    return None if snapshot is None else snapshot()


def host_ms(run, span):
    """``host_ms.<span>`` (ms, program span; moves frame_ms): host self
    time per traced frame of the ``tr.<span>`` range (:func:`self_times`),
    for ``render``, ``prepare``, ``frame_inputs``, ``fill`` (layer
    ``Scene.render host path``), ``launch``, ``outputs`` (``replay``) and
    ``readback`` (``quantize``). ``host_ms.render`` is the Python of
    ``Scene.render()`` that no other span covers; the seven sum to the
    mean ``tr.render``."""
    if run.trace is None or not run.trace_ok:
        return None
    times = self_times(run.trace)
    if times is None or span not in times:
        return None
    return times[span] / len(run.trace.frames) / 1e3


def idle_ms(run, part):
    """``idle_ms.<span>`` (ms, device trace; layer ``device``, moves
    frame_ms): device idle time per traced frame by the innermost span at
    each gap (:func:`idle_by_span`), for the seven host spans and
    ``outside``; the eight sum to the window's idle time per frame."""
    if run.trace is None or not run.trace_ok:
        return None
    idle = idle_by_span(run.trace)
    if idle is None:
        return None
    return idle.get(part, 0.0) / len(run.trace.frames) / 1e3


def replay_ms(run, stage):
    """``replay_ms.<stage>`` (ms, program span; the stage's layer, moves
    frame_ms): device ms per replayed frame between the two stamps that
    the system's ``tr.<stage>`` span wrote into the frame's CUDA graph,
    for ``vertex``, ``visibility``, ``gbuffer``, ``sample_textures``,
    ``shadow_quads``, ``stencil``, ``shade`` and ``quantize``. The system
    reads them after each replay made under the profiler: the traced
    window's frames."""
    if run.trace is None:
        return None
    snap = counters()
    if not snap or not snap.get("replays") or stage not in snap["replay_ms"]:
        return None
    return snap["replay_ms"][stage] / snap["replays"]


def per_visit(way, index):
    """Copies (``index`` 0) or bytes (1) in direction ``way`` per frame:
    each copy site's count over its own visits, summed over the sites (the
    harness's own ``Scene._prepare`` calls visit the light and background
    sites outside any compiled frame, so one count of calls would not
    divide them all); None without counters or visits."""
    snap = counters()
    if not snap:
        return None
    sites = [c for c in snap.get("copies", {}).values() if c.get("visits")]
    if not sites:
        return None
    return float(sum(c[way][index] / c["visits"] for c in sites if way in c))


def copies(run, way):
    """``copies.<dir>`` (count, program counter; layer ``replay``, moves
    frame_ms): copies per frame in direction ``h2d``, ``d2d`` or ``d2h`` at
    the system's copy sites (the program's static buffers, the scene's
    light and background tensors, the output clones, the copy of the frame
    to the host), by :func:`per_visit`."""
    return per_visit(way, 0)


def copy_bytes(run, way):
    """``copy_bytes.<dir>`` (B, program counter; layer ``replay``, moves
    frame_ms): bytes copied per frame in that direction, as ``copies``
    counts them."""
    return per_visit(way, 1)


def capture_part(run, key):
    """``warmup_ms`` and ``record_ms`` (ms, program span; layer ``replay``,
    moves setup_s): host ms of the first program's eager warm-up before its
    CUDA graph is recorded, and of the recording, in the first
    ``Scene.render()`` of set-up: the two parts of ``capture_ms``."""
    snap = counters()
    return None if not snap else snap.get(key)


_READERS = {"host_ms": host_ms, "idle_ms": idle_ms, "replay_ms": replay_ms,
            "copies": copies, "copy_bytes": copy_bytes}


def reader(name):
    """The ``read(run, part)`` of the metric ``name``: ``<kind>.<part>``
    for a kind of ``_READERS``, or ``warmup_ms`` / ``record_ms``."""
    kind, _, part = name.partition(".")
    fn = _READERS.get(kind)
    if fn is None:
        return lambda run, part=None: capture_part(run, name)
    return lambda run, _=None: fn(run, part)
