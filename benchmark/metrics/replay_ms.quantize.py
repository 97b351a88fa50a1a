"""replay_ms.quantize (ms, program span; layer ``quantize``, moves frame_ms):
device ms per replayed frame of ``tr.quantize``, between its two stamps
(rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.quantize")
