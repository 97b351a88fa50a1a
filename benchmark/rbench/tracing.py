"""Reading a torch.profiler Chrome trace of the benchmark's frames.

The harness names each frame of the window with a ``bench.frame`` range
(``torch.profiler.record_function``). Device work is the trace's
``kernel``, ``gpu_memcpy`` and ``gpu_memset`` events; a device event's
``correlation`` names the runtime call that launched it (for a replayed
CUDA graph, its ``cudaGraphLaunch``). The system's stages name their
ranges ``tr.<stage>`` (eager frames only: a replayed graph has no host
ranges inside it).

The attribution of a device event to the innermost host range open at its
launch is a frozen copy of ``tpu_renderer_torch.utils.profiling.
summarize_device_trace``'s.
"""
from __future__ import annotations

import bisect
import collections
import json
import re

__all__ = ["Trace", "FRAME", "MAIN_KERNEL"]

FRAME = "bench.frame"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")
#: The kernel (by its symbol) that each launch counter of the system's
#: capture tally (``raster_cuda.counting_into``) stands for; the coarse
#: binning kernel that K1 and K4 launch first is ``BINS``.
MAIN_KERNEL = {"visibility": "visibility_kernel", "gbuffer": "gbuffer_kernel",
               "sample_textures": "sample_kernel", "stencil": "stencil_kernel",
               "quad_prep": "quad_prep_kernel"}
BINS = "coarse_bins_kernel"


def short_name(name):
    """A device operation's name without ``void``, template arguments and
    argument list, at most 96 characters; a PyTorch kernel keeps the
    functor it applies in brackets."""
    name = name.strip().removeprefix("void ").replace(
        "(anonymous namespace)", "anon")
    functors = [f for f in re.findall(r"\w*Functor\w*|\w+_kernel_cuda", name)
                if f not in ("BinaryFunctor", "UnaryFunctor", "AUnaryFunctor",
                             "BUnaryFunctor")]
    tag = f" [{functors[-1]}]" if functors else ""
    while True:
        shorter = re.sub(r"<[^<>]*>", "", name)
        if shorter == name:
            break
        name = shorter
    return (name.split("(", 1)[0].strip() + tag)[:96]


def _corr(e):
    return (e.get("args") or {}).get("correlation")


class Trace:
    """The events of one exported Chrome trace."""

    def __init__(self, path_or_events):
        if isinstance(path_or_events, str):
            with open(path_or_events) as f:
                events = json.load(f).get("traceEvents", [])
        else:
            events = path_or_events
        spans = [e for e in events if e.get("ph") == "X" and "dur" in e]
        for e in spans:
            e["ts"], e["dur"] = float(e["ts"]), float(e["dur"])
        self.device = sorted((e for e in spans if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self.host = [e for e in spans if e.get("cat") in HOST_CATS]
        self.runtime = {_corr(e): e for e in spans
                        if e.get("cat") == "cuda_runtime" and _corr(e)
                        is not None}
        frames = sorted((e for e in spans if e.get("name") == FRAME
                         and e.get("cat") == "user_annotation"),
                        key=lambda e: e["ts"])
        self.frames = [(e["ts"], e["ts"] + e["dur"]) for e in frames]
        self._starts = [f[0] for f in self.frames]
        self.thread = ((frames[0].get("pid"), frames[0].get("tid"))
                       if frames else None)
        self._by_thread = {}

    # ------------------------------------------------------------ frames

    def window(self):
        """(start, end) in microseconds: the first frame's start to the
        last frame's end."""
        return self.frames[0][0], self.frames[-1][1]

    def frame_of(self, t):
        """Index of the frame whose range holds host time ``t``, or None."""
        i = bisect.bisect_right(self._starts, t) - 1
        if i >= 0 and t <= self.frames[i][1]:
            return i
        return None

    def launch_frame(self, e):
        """The frame in which device event ``e`` was launched (its runtime
        call's frame), or None."""
        launch = self.runtime.get(_corr(e))
        return None if launch is None else self.frame_of(launch["ts"])

    def kernels_by_frame(self):
        """{frame index: [kernel events in launch order]}."""
        out = collections.defaultdict(list)
        for e in self.device:
            if e.get("cat") == "kernel":
                i = self.launch_frame(e)
                if i is not None:
                    out[i].append(e)
        return out

    def graph_launches(self):
        """Host microseconds from each frame's start to its first
        ``cudaGraphLaunch`` (None for a frame without one)."""
        firsts = [None] * len(self.frames)
        for e in self.runtime.values():
            if e.get("name") != "cudaGraphLaunch":
                continue
            i = self.frame_of(e["ts"])
            if i is not None and (firsts[i] is None or e["ts"] < firsts[i]):
                firsts[i] = e["ts"]
        return [None if t is None else t - f[0]
                for t, f in zip(firsts, self.frames)]

    # ------------------------------------------------------------ device

    def busy(self, lo=None, hi=None):
        """Microseconds in [lo, hi] (default: the window) in which a device
        operation ran, and the idle gaps [(start, end)] between them."""
        if lo is None:
            lo, hi = self.window()
        busy, gaps, at = 0.0, [], lo
        for e in self.device:
            s, t = max(e["ts"], lo), min(e["ts"] + e["dur"], hi)
            if t <= s:
                continue
            if s > at:
                gaps.append((at, s))
            if t > at:
                busy += t - max(s, at)
                at = t
        if hi > at:
            gaps.append((at, hi))
        return busy, gaps

    def _innermost(self, thread, t, ranges_only=None):
        """The host event on ``thread`` open at ``t`` that started last (the
        innermost), or None; ``ranges_only``: a name prefix of
        ``user_annotation`` ranges to consider alone."""
        key = (thread, ranges_only)
        if key not in self._by_thread:
            evs = sorted((e for e in self.host
                          if (e.get("pid"), e.get("tid")) == thread
                          and (ranges_only is None
                               or (e.get("cat") == "user_annotation"
                                   and e["name"].startswith(ranges_only)))),
                         key=lambda e: e["ts"])
            self._by_thread[key] = (evs, [e["ts"] for e in evs])
        evs, starts = self._by_thread[key]
        for i in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if evs[i]["ts"] + evs[i]["dur"] >= t:
                return evs[i]
        return None

    def host_label(self, t):
        """The innermost host range, op or runtime call open at ``t`` on
        the frames' thread."""
        e = self._innermost(self.thread, t)
        return "?" if e is None else e["name"]

    def device_ops(self, n=10):
        """The device operations of the window that took the most time:
        [[short name, seconds]]."""
        lo, hi = self.window()
        total = collections.Counter()
        for e in self.device:
            if lo <= e["ts"] <= hi:
                total[short_name(e["name"])] += e["dur"]
        return [[k, v / 1e6] for k, v in total.most_common(n)]

    def idle_gaps(self, n=10):
        """The device's idle time in the window by what the host was doing
        at each gap's middle: [[label, seconds]], the most first."""
        _, gaps = self.busy()
        total = collections.Counter()
        for s, t in gaps:
            total[self.host_label((s + t) / 2)] += t - s
        return [[k, v / 1e6] for k, v in total.most_common(n)]

    def stage_times(self, prefix="tr."):
        """Device microseconds launched under each innermost ``tr.<stage>``
        range: {stage: microseconds}."""
        out = collections.Counter()
        for e in self.device:
            launch = self.runtime.get(_corr(e))
            if launch is None:
                continue
            r = self._innermost((launch.get("pid"), launch.get("tid")),
                                launch["ts"], prefix)
            if r is not None:
                out[r["name"][len(prefix):]] += e["dur"]
        return out
