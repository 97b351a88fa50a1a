"""replay_ms.ssaa (ms, program span; layer ``ssaa``, moves frame_ms):
device ms per replayed frame of ``tr.ssaa``, the box filter of a
supersampled frame, between its two stamps (rbench/inside.py
``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.ssaa")
