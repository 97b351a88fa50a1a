"""replay_ms.stencil (ms, program span; layer ``stencil``, moves frame_ms):
device ms per replayed frame of ``tr.stencil``, between its two stamps
(rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.stencil")
