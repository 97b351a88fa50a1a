"""host_ms.outputs (ms, program span; layer ``replay``, moves frame_ms): host
self time per traced frame of ``tr.outputs``: the output clones
(rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.outputs")
