"""host_ms.overlay_matrices (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_matrices``: both
cameras' float64 host matrices (``Camera._matrices``) for the debug camera's
frustum overlay (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_matrices")
