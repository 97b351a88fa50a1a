"""idle_ms.outside (ms, device trace; layer ``device``, moves frame_ms): device
idle per traced frame in no span (rbench/inside.py ``idle_ms``)."""
from rbench import inside

read = inside.reader("idle_ms.outside")
