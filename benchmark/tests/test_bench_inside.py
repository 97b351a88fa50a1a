"""The readers of what the system records about its own compiled frame
(rbench/inside.py): ``host_ms`` and ``idle_ms`` on a canned Chrome trace
with the system's ``tr.`` spans, ``replay_ms``, ``copies``,
``copy_bytes``, ``warmup_ms`` and ``record_ms`` on a canned counter
snapshot, and None from every one where a run has nothing to read."""
import pytest

from tpu_renderer_torch.utils import profiling

#: Per frame of 1000 us: (span, start, end) on the frames' thread.
SPANS = (("render", 50, 950), ("prepare", 60, 160),
         ("frame_inputs", 170, 220), ("fill", 230, 300),
         ("launch", 300, 340), ("outputs", 350, 380),
         ("readback", 400, 900))
#: Self microseconds per frame: render's 900 less its six children.
SELF_US = {"render": 110, "prepare": 100, "frame_inputs": 50, "fill": 70,
           "launch": 40, "outputs": 30, "readback": 500}
#: Idle microseconds over the two frames by the innermost span at each
#: gap's middle: 0-240 (prepare), 250-350 (at 300 launch opens, fill
#: ends), 500-520 and 700-750 (readback), 850-1240 (frame 1 before its
#: tr.render: outside), 1250-1350, 1500-1520, 1700-1750 and 1850-2000
#: (render, after readback).
IDLE_US = {"render": 150, "prepare": 240, "frame_inputs": 0, "fill": 0,
           "launch": 200, "outputs": 0, "readback": 140, "outside": 390}
#: Counters of three compiled frames after two prepares of the harness's
#: own: each site per its own visits.
SNAPSHOT = {
    "copies": {"fill": {"visits": 3, "h2d": [3, 768], "d2d": [171, 43092]},
               "light": {"visits": 5, "h2d": [40, 320]},
               "background": {"visits": 5, "h2d": [5, 60]},
               "outputs": {"visits": 3, "d2d": [12, 3 * 16 * 1024 ** 2]},
               "readback": {"visits": 3, "d2h": [3, 3 * 3 * 1024 ** 2]}},
    "replays": 2, "replay_ms": {"vertex": 1.0, "shade": 3.0, "ssaa": 8.0},
    "warmup_ms": 900.0, "record_ms": 40.0}
PROGRAM = {"copies.h2d": 10.0, "copies.d2d": 61.0, "copies.d2h": 1.0,
           "copy_bytes.h2d": 256 + 64 + 12,
           "copy_bytes.d2d": 14364 + 16 * 1024 ** 2,
           "copy_bytes.d2h": 3 * 1024 ** 2,
           "replay_ms.vertex": 0.5, "replay_ms.shade": 1.5,
           "warmup_ms": 900.0, "record_ms": 40.0}


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 0 if cat in ("kernel", "gpu_memcpy") else 1, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _canned(spans=True):
    """Two frames of 1000 us: the fill's copy, the graph's two kernels,
    the frame's copy to the host, and (``spans``) the system's ranges."""
    ev = []
    for f, t0 in enumerate((0.0, 1000.0)):
        ev.append(_x("bench.frame", "user_annotation", t0, 1000.0))
        if spans:
            ev += [_x("tr." + n, "user_annotation", t0 + s, e - s)
                   for n, s, e in SPANS]
        ev.append(_x("cudaMemcpyAsync", "cuda_runtime", t0 + 235, 5,
                     corr=30 + f))
        ev.append(_x("cudaGraphLaunch", "cuda_runtime", t0 + 305, 30,
                     corr=10 + f))
        ev.append(_x("cudaMemcpyAsync", "cuda_runtime", t0 + 410, 480,
                     corr=20 + f))
        ev.append(_x("Memcpy HtoD (Pinned -> Device)", "gpu_memcpy",
                     t0 + 240, 10, tid=7, corr=30 + f))
        ev.append(_x("void visibility_kernel(float const*)", "kernel",
                     t0 + 350, 150, tid=7, corr=10 + f))
        ev.append(_x("void shade_kernel(float const*)", "kernel", t0 + 520,
                     180, tid=7, corr=10 + f))
        ev.append(_x("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy",
                     t0 + 750, 100, tid=7, corr=20 + f))
    return ev


def _run(**kw):
    from rbench.runner import RunRecord

    rec = RunRecord()
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def _traced(spans=True):
    from rbench import tracing

    return _run(trace=tracing.Trace(_canned(spans)), trace_ok=True)


@pytest.mark.parametrize("span", sorted(SELF_US))
def test_host_ms_are_self_times_that_add_up_to_render(reg, span):
    rec = _traced()
    read, part = reg.reader(f"host_ms.{span}")
    assert read(rec, part) == pytest.approx(SELF_US[span] / 1e3)
    total = sum(reg.reader(f"host_ms.{s}")[0](rec, s) for s in SELF_US)
    render = [e["dur"] for e in rec.trace.host if e["name"] == "tr.render"]
    assert total == pytest.approx(sum(render) / len(render) / 1e3)


@pytest.mark.parametrize("part", sorted(IDLE_US))
def test_idle_ms_add_up_to_the_window_idle_time(reg, part):
    rec = _traced()
    read, p = reg.reader(f"idle_ms.{part}")
    assert read(rec, p) == pytest.approx(IDLE_US[part] / 2 / 1e3)
    busy, _ = rec.trace.busy()
    lo, hi = rec.trace.window()
    total = sum(reg.reader(f"idle_ms.{s}")[0](rec, s) for s in IDLE_US)
    assert total == pytest.approx((hi - lo - busy) / 2 / 1e3)
    assert reg.reader("device_idle")[0](rec, None) == pytest.approx(
        total * 2 / ((hi - lo) / 1e3) * 100)


@pytest.mark.parametrize("name", sorted(PROGRAM))
def test_program_readers_on_a_canned_snapshot(reg, monkeypatch, name):
    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    read, part = reg.reader(name)
    assert read(_traced(), part) == pytest.approx(PROGRAM[name])


NEW = ([f"host_ms.{s}" for s in SELF_US] + [f"idle_ms.{s}" for s in IDLE_US]
       + ["replay_ms.vertex", "replay_ms.stencil", "copies.h2d",
          "copy_bytes.d2h", "warmup_ms", "record_ms"])


@pytest.mark.parametrize("name", NEW)
def test_readers_give_none_with_nothing_to_read(reg, monkeypatch, name):
    """No trace, a trace without the system's spans, a system that keeps
    no counters (as before it had them), and counters of no frame."""
    read, part = reg.reader(name)
    monkeypatch.delattr(profiling, "snapshot")
    assert read(_run(), part) is None
    assert read(_traced(spans=False), part) is None
    monkeypatch.setattr(profiling, "snapshot", profiling._fresh,
                        raising=False)
    if name.startswith(("host_ms", "idle_ms")):
        assert read(_traced(spans=False), part) is None
    else:
        assert read(_traced(), part) is None
