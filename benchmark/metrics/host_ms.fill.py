"""host_ms.fill (ms, program span; layer ``Scene.render host path``, moves
frame_ms): host self time per traced frame of ``tr.fill``: ``Program._fill``,
the copies into the static buffers (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.fill")
