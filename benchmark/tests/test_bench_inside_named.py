"""The readers of the spans that name the host work inside ``tr.render``
and ``tr.overlay_draw`` (``host_ms`` and ``idle_ms`` of ``program_inputs``,
``program_key``, ``read_timers``, ``overlay_matrices``, ``overlay_segments``,
``overlay_clip`` and ``overlay_kernel``; rbench/inside.py), on a canned
Chrome trace of two debug-camera frames: the self times of ``tr.render``
and every span inside it add up to the mean ``tr.render``, the idle parts
to the window's idle time, and each new reader gives None on a trace
without its span, as a system that does not name it records."""
import pytest

NEW = ("program_inputs", "program_key", "read_timers", "overlay_matrices",
       "overlay_segments", "overlay_clip", "overlay_kernel")
#: The spans already read, whose self times and idle parts the sums hold.
OLD_HOST = ("render", "prepare", "frame_inputs", "fill", "launch",
            "outputs", "readback", "overlay", "overlay_cast", "overlay_draw",
            "overlay_quantize")
OLD_IDLE = ("render", "prepare", "frame_inputs", "fill", "launch",
            "outputs", "readback", "outside")

#: Per frame of 1000 us: (span, start, end) on the frames' thread.
SPANS = (("render", 50, 950), ("prepare", 60, 120),
         ("frame_inputs", 130, 160), ("program_inputs", 165, 175),
         ("program_key", 180, 200), ("fill", 205, 240),
         ("launch", 240, 280), ("outputs", 285, 300),
         ("overlay", 305, 900), ("overlay_cast", 310, 330),
         ("overlay_draw", 335, 700), ("overlay_matrices", 340, 400),
         ("overlay_segments", 405, 640), ("overlay_clip", 410, 450),
         ("overlay_clip", 460, 500), ("overlay_clip", 510, 550),
         ("overlay_kernel", 645, 690), ("overlay_quantize", 705, 720),
         ("readback", 725, 890), ("read_timers", 905, 940))
#: Self microseconds per frame: each span less the spans directly inside.
SELF_US = {"render": 60, "prepare": 60, "frame_inputs": 30,
           "program_inputs": 10, "program_key": 20, "fill": 35, "launch": 40,
           "outputs": 15, "overlay": 30, "overlay_cast": 20,
           "overlay_draw": 25, "overlay_matrices": 60,
           "overlay_segments": 115, "overlay_clip": 120,
           "overlay_kernel": 45, "overlay_quantize": 15, "readback": 165,
           "read_timers": 35}
#: Device busy per frame; the gaps between lie at 160-178 (middle in
#: program_inputs), 182-198 (program_key), 345-395 (overlay_matrices),
#: 415-445 (overlay_clip), 600-630 (overlay_segments, after its last
#: clip), 650-680 (overlay_kernel), 910-930 (read_timers) and 950-1000
#: (outside, after tr.render).
BUSY = ((0, 160), (178, 182), (198, 345), (395, 415), (445, 600),
        (630, 650), (680, 910), (930, 950))
#: Idle microseconds per frame by the innermost span at each gap's middle.
IDLE_US = {"program_inputs": 18, "program_key": 16, "overlay_matrices": 50,
           "overlay_clip": 30, "overlay_segments": 30, "overlay_kernel": 30,
           "read_timers": 20, "outside": 50}


def _x(name, cat, ts, dur):
    device = cat == "kernel"
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "pid": 0 if device else 1, "tid": 7 if device else 1}


def _canned(named=True):
    """Two frames of 1000 us; without ``named``, none of the new spans."""
    ev = []
    for t0 in (0.0, 1000.0):
        ev.append(_x("bench.frame", "user_annotation", t0, 1000.0))
        ev += [_x("tr." + n, "user_annotation", t0 + s, e - s)
               for n, s, e in SPANS if named or n not in NEW]
        ev += [_x("void some_kernel(float const*)", "kernel", t0 + s, e - s)
               for s, e in BUSY]
    return ev


def _traced(named=True):
    from rbench import tracing
    from rbench.runner import RunRecord

    rec = RunRecord()
    rec.trace, rec.trace_ok = tracing.Trace(_canned(named)), True
    return rec


def _read(reg, name, rec):
    read, part = reg.reader(name)
    return read(rec, part)


@pytest.mark.parametrize("span", NEW)
def test_host_ms_of_the_named_spans_add_up_to_render(reg, span):
    rec = _traced()
    assert _read(reg, f"host_ms.{span}", rec) == pytest.approx(
        SELF_US[span] / 1e3)
    parts = {s: _read(reg, f"host_ms.{s}", rec) for s in OLD_HOST + NEW}
    assert parts == pytest.approx({s: us / 1e3 for s, us in SELF_US.items()})
    render = [e["dur"] for e in rec.trace.host if e["name"] == "tr.render"]
    assert sum(parts.values()) == pytest.approx(
        sum(render) / len(render) / 1e3)


@pytest.mark.parametrize("span", NEW)
def test_idle_ms_of_the_named_spans_add_up_to_the_window_idle_time(reg,
                                                                   span):
    rec = _traced()
    assert _read(reg, f"idle_ms.{span}", rec) == pytest.approx(
        IDLE_US[span] / 1e3)
    parts = {s: _read(reg, f"idle_ms.{s}", rec) for s in OLD_IDLE + NEW}
    assert parts == pytest.approx({s: IDLE_US.get(s, 0) / 1e3
                                   for s in parts})
    busy, _ = rec.trace.busy()
    lo, hi = rec.trace.window()
    frames = len(rec.trace.frames)
    assert sum(parts.values()) == pytest.approx((hi - lo - busy) / frames
                                                / 1e3)


@pytest.mark.parametrize("name", [f"{kind}.{span}" for span in NEW
                                  for kind in ("host_ms", "idle_ms")])
def test_named_readers_give_none_without_their_span(reg, name):
    """No trace, and a traced window whose ``tr.render`` holds none of the
    new spans; the spans already read still read there."""
    from rbench.runner import RunRecord

    assert _read(reg, name, RunRecord()) is None
    rec = _traced(named=False)
    assert _read(reg, name, rec) is None
    assert _read(reg, "host_ms.render", rec) is not None
