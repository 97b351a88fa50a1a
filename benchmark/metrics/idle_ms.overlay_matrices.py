"""idle_ms.overlay_matrices (ms, device trace; layer ``device``, moves
frame_ms): device idle per traced frame while ``tr.overlay_matrices`` is the
innermost span (rbench/inside.py ``idle_ms``); None where the trace holds no
such span, as before the system named it."""
from rbench import inside

_idle = inside.reader("idle_ms.overlay_matrices")
_host = inside.reader("host_ms.overlay_matrices")


def read(run, part=None):
    return None if _host(run) is None else _idle(run)
