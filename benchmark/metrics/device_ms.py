"""device_ms (ms, device trace; layer ``replay``, moves frame_ms): the
union of device activity (kernels, copies, fills) over the traced window,
per frame."""


def read(run, part=None):
    if run.trace is None or not run.trace_ok:
        return None
    busy, _ = run.trace.busy()
    return busy / len(run.trace.frames) / 1e3
