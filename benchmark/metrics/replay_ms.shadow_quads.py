"""replay_ms.shadow_quads (ms, program span; layer ``shadow_quads``, moves
frame_ms): device ms per replayed frame of ``tr.shadow_quads``, between its two
stamps (rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.shadow_quads")
