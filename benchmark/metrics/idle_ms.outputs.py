"""idle_ms.outputs (ms, device trace; layer ``device``, moves frame_ms): device
idle per traced frame while ``tr.outputs`` is the innermost span
(rbench/inside.py ``idle_ms``)."""
from rbench import inside

read = inside.reader("idle_ms.outputs")
