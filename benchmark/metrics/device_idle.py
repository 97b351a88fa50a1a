"""device_idle (%, device trace; layer ``device``, moves frame_ms): the
share of the traced window in which no device operation ran."""


def read(run, part=None):
    if run.trace is None or not run.trace_ok:
        return None
    busy, _ = run.trace.busy()
    lo, hi = run.trace.window()
    return (1.0 - busy / (hi - lo)) * 100.0
