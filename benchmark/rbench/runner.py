"""One run of one cell: set-up, the measured window, the trace, the check.

Set-up, timed from the process's start, in parts (``setup_parts``):
importing torch and the system; loading the kernel library, which a
checkout's first run builds (``built``); the seeded scene and the system's
Scene of it; the first packing and upload of the models; the first frame,
whose program warms up and captures its CUDA graph (the program's own
``capture_ms``); and the warm frames.

The window is a closed loop: one viewer renders frame after frame with no
think time. Each frame applies the traffic's moves, calls
``Scene.render()`` (the compiled path: a replayed CUDA graph) and gets the
uint8 frame back on the host; the host clock times it from just before the
moves to the return of ``render()``. The run keeps the threads PyTorch
gives a process, as a user's does.
"""
from __future__ import annotations

import gc
import os
import sys
import tempfile
import time
import traceback

import numpy as np

from rbench import check, roofline, scenes, tracing
from rbench.registry import Registry, plugin
from rbench.traffic import Traffic

__all__ = ["run", "RunRecord", "WARM_FRAMES", "SAMPLE", "TRACE_FRAMES",
           "EAGER_FRAMES", "FORBIDDEN"]

#: Frames rendered in set-up after the first (which captures).
WARM_FRAMES = 5
#: Frames of the window held to the reference, drawn from the seed.
SAMPLE = 3
#: Frames of a traced run's window (all of them traced), and eager frames
#: traced after it for the per-stage device times.
TRACE_FRAMES = 60
EAGER_FRAMES = 3
#: Top-level module names no run may load.
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_renderer")


class RunRecord:
    """What one run measured, for the metric readers (``metrics/*.py``)."""

    def __init__(self):
        self.latencies = []          # seconds of every frame of the window
        self.window_s = None
        self.attempted = 0
        self.failed = 0
        self.setup_s = None
        self.setup_parts = {}        # seconds of each part of set-up
        self.built = False           # set-up built the kernel library
        self.capture_ms = None       # the first program's warm-up, capture
        self.trace = None            # tracing.Trace of the window (traced)
        self.eager = None            # tracing.Trace of the eager frames
        self.eager_frames = 0
        self.tally = {}              # the capture's launches per replay
        self.counts = {}             # window frame index -> reference counts
        self.trace_ok = False        # the trace holds every frame's kernels


class _Sample:
    """A seeded reservoir of ``k`` frames of the window."""

    def __init__(self, k, seed):
        self.k = k
        self.rng = np.random.default_rng([int(seed), 2])
        self.items = []
        self.seen = 0

    def offer(self, item):
        self.seen += 1
        if len(self.items) < self.k:
            self.items.append(item)
            return
        j = int(self.rng.integers(0, self.seen))
        if j < self.k:
            self.items[j] = item


def _device_ok(chips):
    import torch

    if not torch.cuda.is_available():
        return "torch.cuda.is_available() is false"
    if torch.cuda.device_count() < chips:
        return (f"the cell needs {chips} cards, torch.cuda.device_count() is "
                f"{torch.cuda.device_count()}")
    return None


def _sync(device):
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _check_trace(rec, log):
    """True when every traced frame holds the same number of kernels and
    each capture counter's kernel as often as the tally says."""
    by_frame = rec.trace.kernels_by_frame()
    n = len(rec.trace.frames)
    counts = [len(by_frame.get(i, [])) for i in range(n)]
    if not counts or min(counts) == 0 or len(set(counts)) != 1:
        log(f"trace check: kernels per traced frame {sorted(set(counts))}")
        return False
    for key, want in rec.tally.items():
        sym = tracing.MAIN_KERNEL.get(key)
        if sym is None:
            continue
        got = {sum(sym in e["name"] for e in by_frame[i]) for i in range(n)}
        if got != {want}:
            log(f"trace check: {sym} {sorted(got)} per frame, tally {want}")
            return False
    return True


def run(workload, seed, seconds, trace, root=None, device=None,
        config=None, t0=None, log=None, traffic=None):
    """One run of ``workload``. Returns (result dict, check lines), or
    raises SystemExit with a reason where the run cannot be made.

    ``device`` (default "cuda"), ``config`` (a dict that updates the
    configuration file's) and ``traffic`` (a mix in the traffic file's
    place) exist for the harness's own tests on the CPU; ``t0`` is the
    process's start on ``time.perf_counter``."""
    t0 = time.perf_counter() if t0 is None else t0
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    reg = Registry(root)
    cell = reg.cell(workload)
    cfg = reg.config(cell)
    if config:
        cfg = {**cfg, **config}
    mix = traffic or reg.traffic(cell)

    import torch

    if device is None:
        bad = _device_ok(int(cell["chips"]))
        if bad:
            raise SystemExit(f"no run: {bad}")
        device = "cuda"
    device = torch.device(device)
    import tpu_renderer_torch as tr
    from tpu_renderer_torch.ops import _build, compiled
    from tpu_renderer_torch.ops import pipeline as pl

    rec = RunRecord()
    parts = rec.setup_parts
    mark = [t0]

    def part(name):
        now = time.perf_counter()
        parts[name] = now - mark[0]
        mark[0] = now

    part("import")
    if device.type == "cuda":
        _build.load()
        rec.built = bool(_build.last_build["seconds"])
    part("library")
    spec = scenes.build(cfg, seed)
    port = scenes.port_scene(tr, spec, device)
    scene = port.scene
    moves = Traffic(mix, seed, spec)
    h, w = spec.resolution
    part("scene")
    moves.apply(port, moves.at(-WARM_FRAMES - 1))
    scene._prepare()
    _sync(device)
    part("pack")
    scene.render()
    _sync(device)
    part("first_frame")
    prog = compiled.CACHE.last
    if prog is not None:
        rec.capture_ms = prog.capture_ms
        rec.tally = dict(prog.launches)
    for i in range(-WARM_FRAMES, 0):
        moves.apply(port, moves.at(i))
        scene.render()
    _sync(device)
    part("warm_frames")
    rec.setup_s = mark[0] - t0

    prof = None
    if trace:
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        prof = profile(activities=acts)
        prof.start()
    sample = _Sample(SAMPLE, seed)
    first_error = frame = None
    i = 0
    start = time.perf_counter()
    while True:
        ts = time.perf_counter()
        move = moves.at(i)
        ok = False
        try:
            if prof is not None:
                with record_function(tracing.FRAME):
                    moves.apply(port, move)
                    frame = scene.render()
            else:
                moves.apply(port, move)
                frame = scene.render()
            ok = (isinstance(frame, np.ndarray) and frame.shape == (h, w, 3)
                  and frame.dtype == np.uint8)
        except Exception:  # a frame that raises counts as failed
            first_error = first_error or traceback.format_exc()
        te = time.perf_counter()
        rec.latencies.append(te - ts)
        rec.attempted += 1
        if ok:
            sample.offer((move, frame, scene.last_zbuf, scene.last_tid,
                          scene.last_stencil))
        else:
            rec.failed += 1
        i += 1
        if (i >= TRACE_FRAMES) if trace else (te - start >= seconds):
            break
    rec.window_s = te - start
    _sync(device)
    if first_error:
        log(f"first failed frame:\n{first_error}")
    peak = (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)

    if prof is not None:
        prof.stop()
        rec.trace = _export(prof, "window")
        # Eager frames, whose tr.<stage> ranges time the stages.
        cfg_, dyn = scene._prepare()
        pl.render_frame(cfg_, dyn)
        _sync(device)
        with profile(activities=acts) as eager:
            for _ in range(EAGER_FRAMES):
                cfg_, dyn = scene._prepare()
                pl.render_frame(cfg_, dyn)
            _sync(device)
        rec.eager = _export(eager, "eager")
        rec.eager_frames = EAGER_FRAMES
        rec.trace_ok = (device.type == "cuda"
                        and len(rec.trace.frames) == rec.attempted
                        and _check_trace(rec, log))

    # The system's state goes before the reference runs; its face ids are
    # numbered as the scene numbers its faces.
    table = port.face_table()
    outputs = [(move, frame, z.detach().cpu(), _numbered(t_, table),
                s.detach().cpu()) for move, frame, z, t_, s in sample.items]
    del scene, port, sample, frame
    tr.clear_compiled()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()

    t = time.perf_counter()
    ref = plugin("references", spec.settings["reference"]).Reference(
        spec, device)
    readings = []
    for move, frame, z, t_, s in outputs:
        out = ref.render(**moves.view(move))
        readings.append(check.compare((frame, z, t_, s), out))
        rec.counts[move.index] = out.counts
    correct, checks = check.judge(readings)
    log("set-up parts: " + ", ".join(f"{k} {v:.3f} s" for k, v in
                                     parts.items())
        + (", the kernel library built" if rec.built else "")
        + (f"; capture {rec.capture_ms:.1f} ms" if rec.capture_ms else ""))
    log(f"set-up {rec.setup_s:.3f} s, window {rec.window_s:.3f} s "
        f"({rec.attempted} frames), reference {time.perf_counter() - t:.3f} s "
        f"for {len(readings)} frames")

    if trace:
        for index, counts in sorted(rec.counts.items()):
            least = {k: roofline.least_time(k, counts) for k in roofline.WORK}
            log(f"frame {index}: {counts}; least " + ", ".join(
                f"{k} {t * 1e6:.3f} us by {by}" for k, (t, by) in least.items()))

    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reg.metrics(cell, kind):
        read, part = reg.reader(m["name"])
        value = read(rec, part)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": (torch.cuda.get_device_name(device)
                    if device.type == "cuda" else "cpu"),
           "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct, "attempted": rec.attempted,
              "failed": rec.failed, "metrics": metrics, "device": dev}
    if trace and rec.trace_ok:
        busy, _ = rec.trace.busy()
        lo, hi = rec.trace.window()
        dev["busy_s"] = busy / 1e6
        dev["window_s"] = (hi - lo) / 1e6
        result["breakdown"] = {"device_ops": rec.trace.device_ops(),
                               "idle_gaps": rec.trace.idle_gaps()}
    result["setup"] = {"built": rec.built, "parts_s": parts}
    result["checks"] = checks
    lines = [f"check {k}: {c['value']} (limit {c['limit']})"
             for k, c in checks.items()]
    return result, lines


def _numbered(tid, table):
    """The scene's face number of each pixel's winner (-1: none; -2: an id
    that numbers no face) of the system's ``last_tid``."""
    import torch

    t = tid.detach().cpu().long()
    n = table.numel()
    inside = (t >= 0) & (t < n)
    out = table[torch.where(inside, t, torch.zeros_like(t))]
    return torch.where(t < 0, -1, torch.where(inside, out, -2))


def _export(prof, name):
    """The profile's Chrome trace, read back from a file under TMPDIR."""
    path = os.path.join(tempfile.gettempdir(), f"bench_{name}_{os.getpid()}"
                        ".json")
    prof.export_chrome_trace(path)
    try:
        return tracing.Trace(path)
    finally:
        os.remove(path)


def forbidden_modules():
    """Loaded modules whose whole top-level name is forbidden."""
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))
