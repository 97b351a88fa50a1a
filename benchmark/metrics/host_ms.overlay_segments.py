"""host_ms.overlay_segments (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_segments``: the
frustum's segment table on the host (``ops/overlay.frustum_segments``): its
corners, projection, DDA rows and index checks, less its clipping
(rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_segments")
