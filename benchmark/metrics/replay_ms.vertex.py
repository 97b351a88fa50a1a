"""replay_ms.vertex (ms, program span; layer ``vertex``, moves frame_ms):
device ms per replayed frame of ``tr.vertex``, between its two stamps
(rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.vertex")
