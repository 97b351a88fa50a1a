"""Compiled frames: one program per static key, captured once into a CUDA
graph and replayed with each frame's inputs.

The port's counterpart of ``jax.jit`` over the JAX package's frame
(``tpu_renderer/ops/pipeline.py``: ``render_frame_jit`` :953, the jitted
``render_debug_frame`` :956, ``render_core_jit`` :1043, ``render_ssaa_jit``
:1049, the jitted ``face_statistics`` :1060), piece by piece:

- **the key** — jit's static arguments (``cfg``, ``ss``, ``kind``) and the
  traced arguments' shapes and dtypes: here the entry's name, the
  ``SceneConfig``, ``ss`` or ``kind`` and the staging layout (from
  ``pipeline._jit``), the device, every input tensor's place in the
  input tree, shape and dtype, and which places hold the same tensor
  (instances of one mesh share their texture stacks, models/scene.py).
  What changes per frame is never in it: the camera's and debug camera's
  parameters (staged by ``pipeline.frame_inputs``), the light, vertex
  positions, texture and cubemap texels and the background colour are the
  inputs (``pipeline._program_inputs``), copied into the program's static
  buffers before every replay, so a camera orbit or an animated model
  never captures again, as jit never retraces. A packing's face tables
  (``pipeline.face_tables``), which no frame writes, are no input: the
  body closes over them and the key holds their identity
  (``pipeline._jit``), as jit closes over a constant;
- **tracing and compiling** — :class:`Program`'s first call: it stages the
  inputs into static buffers, one per distinct tensor (the body sees a
  shared tensor as one tensor, as jit sees one array passed twice), runs
  the body once on a side stream (the kernel library loads, the debug
  walks opt in to their shared memory, the allocator warms up), then
  captures the body into a ``torch.cuda.CUDAGraph`` with its own memory
  pool, and replays it;
- **calling the executable** — every later call: the staged buffer (one
  pinned host copy) and each distinct input are copied into the static buffers on
  the current stream, the graph replays, and the outputs are cloned, since
  the next replay overwrites them (jit returns fresh arrays too);
- **jit's cache** — :data:`CACHE`, bounded: past ``MAX_PROGRAMS`` it drops
  the least recently used program and with it its graph's memory pool;
  :func:`clear_compiled` drops them all.

A failed capture or replay raises: nothing falls back to the eager body.
On the CPU a program runs the same body eagerly over the same static
buffers (the kernels' plain versions), which is what the CPU tests hold to
the eager path and to the JAX package.

Launches: a launch made while the body is captured is recorded, not run,
so the kernel wrappers count it into the program's tally
(``raster_cuda.counting_into``); every replay adds that tally to
``raster_cuda.LAUNCHES``. The warm-up's launches are real and count there
as they run.

Tracing (``utils/profiling.py``, whose :func:`~tpu_renderer_torch.utils.
profiling.snapshot` holds the process's counters): a call opens the spans
``tr.program_key`` (the key formed and looked up), ``tr.fill`` (the copies
into the static buffers), ``tr.launch`` (the replay; on the CPU the body)
and ``tr.outputs`` (the clones); a first call
on the card ``tr.warmup`` and ``tr.record``, whose host ms the program
keeps as ``warmup_ms`` and ``record_ms`` (``capture_ms`` is their sum).
While the graph is recorded, each ``tr.<stage>`` span of the body stamps
the card's clock into it at its entry and exit (a one-thread kernel,
``csrc/stamp.cu``, writing into pinned host memory), so a replay times its
stages on the device; a replay made under a profiler has those stamps read
once the frame is on the host. A program counts the copies and bytes of
its fill and of its clones per direction, which it works out once, when
it is built.
"""
from __future__ import annotations

import time
from collections import OrderedDict

import torch

from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.utils import profiling
from tpu_renderer_torch.utils.profiling import span

__all__ = ["Program", "ProgramCache", "CACHE", "MAX_PROGRAMS", "call",
           "clear_compiled"]

#: Programs kept at once (each with its graph's memory pool on a card).
MAX_PROGRAMS = 16


def _leaves(tree):
    """The tensors of a tree of dicts, lists and tuples, in order."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _leaves(v)
    else:
        raise TypeError(f"a program's inputs and outputs are trees of "
                        f"tensors, got {type(tree).__name__}")


#: A tensor's place in a tree's structure (:func:`_structure`).
_LEAF = object()


def _structure(tree):
    """``tree`` with every tensor replaced by ``_LEAF``: what a program
    keeps of its inputs and outputs, so it holds no caller's tensor."""
    if isinstance(tree, torch.Tensor):
        return _LEAF
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    return type(tree)(_structure(v) for v in tree)


def _rebuild(structure, leaves):
    """``structure`` (:func:`_structure`) over the tensors of the iterator
    ``leaves``."""
    if structure is _LEAF:
        return next(leaves)
    if isinstance(structure, dict):
        return {k: _rebuild(v, leaves) for k, v in structure.items()}
    return type(structure)(_rebuild(v, leaves) for v in structure)


def _aliases(leaves):
    """Each leaf's static buffer: its index among the distinct tensors of
    ``leaves``, in the order they first appear. A tensor that appears at
    several places of an input tree gets one buffer, copied once a call."""
    first = {}
    return tuple(first.setdefault(id(t), len(first)) for t in leaves)


def _firsts(slots, leaves):
    """The leaves at the first place of each distinct tensor, in the order
    of their buffers (``slots`` from :func:`_aliases`)."""
    n = 0
    for slot, t in zip(slots, leaves):
        if slot == n:
            n += 1
            yield t


def _signature(tree):
    """The hashable part of the key that an input tree gives: its
    structure, and each tensor's shape and dtype."""
    if isinstance(tree, torch.Tensor):
        return tuple(tree.shape), tree.dtype
    if isinstance(tree, dict):
        return ("dict",) + tuple((k, _signature(v)) for k, v in tree.items())
    return (type(tree).__name__,) + tuple(_signature(v) for v in tree)


class Program:
    """One compiled body for one key: ``body(inputs, buf)`` over static
    copies of a tree of input tensors and of the staging buffer ``buf``.

    After the first call on a CUDA device: ``graph`` (the captured
    ``torch.cuda.CUDAGraph``), ``warmup_ms`` and ``record_ms`` (host ms of
    the warm-up and of the recording), ``capture_ms`` (their sum),
    ``pool_bytes`` (the bytes the capture reserved: the graph's memory
    pool), ``launches`` (kernel launches per replay, by
    ``raster_cuda.LAUNCHES`` key) and ``timers`` (the span timers recorded
    into the graph, ``profiling.Timers``). ``calls`` counts calls.
    """

    def __init__(self, key, body, buf, inputs, device):
        self.key = key
        self.body = body
        self.device = device
        self.calls = 0
        self.warmup_ms = self.record_ms = self.capture_ms = None
        self.pool_bytes = None
        self.launches = {}
        self.timers = None
        self.graph = None
        self._out_tree = None
        self._out_copies = None
        self._static_out = None
        self._buf = torch.empty(buf.shape, dtype=buf.dtype, device=device)
        self._tree = _structure(inputs)
        leaves = list(_leaves(inputs))
        self._slots = _aliases(leaves)
        firsts = list(_firsts(self._slots, leaves))
        self._static = [torch.empty_like(t, device=device) for t in firsts]
        self._fill_copies = profiling.tally(
            [(buf, buf.device, device)]
            + [(t, t.device, device) for t in firsts])

    def _fill(self, buf, inputs):
        """Copy this frame's staged buffer and inputs into the static
        buffers, on the current stream."""
        cuda = self.device.type == "cuda"
        with span("fill"):
            # From pinned memory the host copy is asynchronous; the host
            # allocator keeps the block until the copy has run.
            self._buf.copy_(buf.pin_memory() if cuda else buf,
                            non_blocking=cuda)
            for dst, src in zip(self._static,
                                _firsts(self._slots, _leaves(inputs))):
                dst.copy_(src, non_blocking=cuda)
            profiling.count_copies("fill", self._fill_copies)

    def _run(self):
        return self.body(_rebuild(self._tree, (self._static[i]
                                               for i in self._slots)),
                         self._buf)

    def _capture(self):
        """Warm the body up on a side stream, then record it into a graph,
        with the timers of its spans."""
        t0 = time.perf_counter()
        with span("warmup"):
            side = torch.cuda.Stream(self.device)
            side.wait_stream(torch.cuda.current_stream(self.device))
            with torch.cuda.stream(side):
                self._run()
            torch.cuda.current_stream(self.device).wait_stream(side)
            torch.cuda.synchronize(self.device)
            torch.cuda.empty_cache()
        t1 = time.perf_counter()
        with span("record"):
            reserved = torch.cuda.memory_reserved(self.device)
            graph = torch.cuda.CUDAGraph()
            launches, timers = {}, profiling.Timers(self.device)
            with (rc.counting_into(launches), profiling.recording(timers),
                  torch.cuda.graph(graph)):
                out = self._run()
            self.pool_bytes = (torch.cuda.memory_reserved(self.device)
                               - reserved)
        t2 = time.perf_counter()
        self.warmup_ms, self.record_ms = (t1 - t0) * 1e3, (t2 - t1) * 1e3
        self.capture_ms = self.warmup_ms + self.record_ms
        profiling.note_capture(self.warmup_ms, self.record_ms)
        self.graph, self._static_out = graph, out
        self.launches, self.timers = launches, timers

    def __call__(self, buf, inputs):
        """This frame's outputs: a tree of fresh tensors."""
        if self.device.type != "cuda":
            self._fill(buf, inputs)
            with span("launch"):
                out = self._run()
        else:
            with torch.cuda.device(self.device):
                self._fill(buf, inputs)
                if self.graph is None:
                    self._capture()
                # The stamps of an earlier traced replay are read before
                # this one writes them again.
                profiling.read_replay_timers()
                with span("launch"):
                    self.graph.replay()
                profiling.replayed(self.timers)
            for k, n in self.launches.items():
                rc.LAUNCHES[k] += n
            out = self._static_out
        self.calls += 1
        with span("outputs"):
            if self._out_tree is None:
                self._out_tree = _structure(out)
                self._out_copies = profiling.tally(
                    (t, t.device, t.device) for t in _leaves(out))
            profiling.count_copies("outputs", self._out_copies)
            return _rebuild(self._out_tree,
                            (t.clone() for t in _leaves(out)))


class ProgramCache:
    """Programs by key, the least recently used dropped past
    ``max_programs``. ``builds`` counts the programs made, ``last`` is
    the program of the latest call."""

    def __init__(self, max_programs=MAX_PROGRAMS):
        self.max_programs = max_programs
        self.programs = OrderedDict()
        self.builds = 0
        self.last = None

    def lookup(self, key):
        """The program of ``key``, now the most recently used, or None."""
        prog = self.programs.get(key)
        if prog is not None:
            self.programs.move_to_end(key)
            self.last = prog
        return prog

    def add(self, key, prog):
        """Keep a program that has run its first call."""
        self.builds += 1
        self.programs[key] = prog
        self.last = prog
        while len(self.programs) > self.max_programs:
            self.programs.popitem(last=False)

    def clear(self):
        self.programs.clear()
        self.last = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            torch.cuda.empty_cache()


#: The process's programs, as jit's cache is the process's.
CACHE = ProgramCache()


def call(key, body, buf, inputs, device):
    """Run ``body(inputs, buf)`` as the program of (``key``, ``device``,
    the inputs' structure, shapes, dtypes and aliases), building it on
    first use; a program whose first call raises is not kept. ``buf`` is the host
    staging buffer (pipeline.frame_inputs), ``inputs`` a tree of tensors
    on ``device``. Returns the body's outputs, cloned. The key is formed
    and looked up under ``tr.program_key``."""
    with span("program_key"):
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        full = (key, device, _signature(inputs),
                _aliases(list(_leaves(inputs))))
        prog = CACHE.lookup(full)
    if prog is not None:
        return prog(buf, inputs)
    prog = Program(full, body, buf, inputs, device)
    out = prog(buf, inputs)
    CACHE.add(full, prog)
    return out


def clear_compiled():
    """Drop every program and its graph memory pool."""
    CACHE.clear()
