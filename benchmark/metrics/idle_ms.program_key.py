"""idle_ms.program_key (ms, device trace; layer ``device``, moves frame_ms):
device idle per traced frame while ``tr.program_key`` is the innermost span
(rbench/inside.py ``idle_ms``); None where the trace holds no such span, as
before the system named it."""
from rbench import inside

_idle = inside.reader("idle_ms.program_key")
_host = inside.reader("host_ms.program_key")


def read(run, part=None):
    return None if _host(run) is None else _idle(run)
