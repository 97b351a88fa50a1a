"""host_ms.overlay_draw (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_draw``: the
debug camera's frustum clipped, projected and drawn on the host frame
(rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_draw")
