"""host_ms.overlay (ms, program span; layer ``overlay``, moves frame_ms):
host self time per traced frame of ``tr.overlay``, the debug camera's host
overlay, less the spans inside it (``tr.readback``, and where the system
has them ``tr.overlay_cast``, ``tr.overlay_draw``, ``tr.overlay_quantize``)
(rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay")
