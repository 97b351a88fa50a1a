"""replay_ms.visibility (ms, program span; layer ``visibility``, moves
frame_ms): device ms per replayed frame of ``tr.visibility``, between its two
stamps (rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.visibility")
