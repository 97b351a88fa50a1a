"""host_ms.overlay_cast (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_cast``: the
float frame and z-buffer cast to float64 on the host for the overlay
(rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_cast")
