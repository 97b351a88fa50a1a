"""replay_ms.shade (ms, program span; layer ``shade``, moves frame_ms): device
ms per replayed frame of ``tr.shade``, between its two stamps (rbench/inside.py
``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.shade")
