"""Profiling and debug instrumentation, in PyTorch.

Counterpart of ``tpu_renderer/utils/profiling.py``:

- :class:`FrameTimer` times steady-state frames, waiting for each frame's
  output first (``torch.cuda.synchronize()`` for a CUDA tensor, a host copy
  for anything else);
- :func:`trace` is a ``torch.profiler`` scope (CPU and, where there is a
  card, CUDA activity) that writes a Chrome trace, in place of
  ``jax.profiler.trace``; :func:`summarize_device_trace` totals its device
  kernels by name;
- :func:`nan_debug` raises at the first torch op that produces a NaN, in
  place of ``jax_debug_nans``.

The render path names its stages ``tr.<stage>`` (``ops/pipeline.py``), so a
trace shows where a frame's host and device time go.
"""
from __future__ import annotations

import collections
import contextlib
import glob
import json
import os
import tempfile
import time

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

__all__ = ["FrameTimer", "trace", "nan_debug", "summarize_device_trace"]

#: The file :func:`trace` writes into its directory.
TRACE_FILE = "trace.json"
#: Chrome-trace categories of device work: kernels, copies and fills.
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class FrameTimer:
    """Steady-state frame timing: ``with FrameTimer() as t: ... t.frame(x)``."""

    def __init__(self):
        self.times = []
        self._t0 = None

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        return False

    def frame(self, device_output):
        """Record one frame, after its output is ready: a CUDA tensor waits
        for the card, anything else is copied to the host."""
        if isinstance(device_output, torch.Tensor) and device_output.is_cuda:
            torch.cuda.synchronize(device_output.device)
        else:
            np.asarray(device_output)
        now = time.perf_counter()
        self.times.append(now - self._t0)
        self._t0 = now

    @property
    def fps(self) -> float:
        if not self.times:
            return 0.0
        return len(self.times) / sum(self.times)

    def summary(self) -> dict:
        ts = np.asarray(self.times)
        return {"frames": len(ts), "fps": self.fps,
                "ms_mean": float(ts.mean() * 1000) if len(ts) else 0.0,
                "ms_p50": float(np.median(ts) * 1000) if len(ts) else 0.0,
                "ms_max": float(ts.max() * 1000) if len(ts) else 0.0}


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
