"""idle_ms.read_timers (ms, device trace; layer ``device``, moves frame_ms):
device idle per traced frame while ``tr.read_timers`` is the innermost span
(rbench/inside.py ``idle_ms``); None where the trace holds no such span, as
before the system named it."""
from rbench import inside

_idle = inside.reader("idle_ms.read_timers")
_host = inside.reader("host_ms.read_timers")


def read(run, part=None):
    return None if _host(run) is None else _idle(run)
