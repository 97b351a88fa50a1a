"""replay_ms.gbuffer (ms, program span; layer ``gbuffer``, moves frame_ms):
device ms per replayed frame of ``tr.gbuffer``, between its two stamps
(rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.gbuffer")
