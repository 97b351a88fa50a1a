"""host_ms.launch (ms, program span; layer ``replay``, moves frame_ms): host
self time per traced frame of ``tr.launch``: the graph's replay
(rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.launch")
