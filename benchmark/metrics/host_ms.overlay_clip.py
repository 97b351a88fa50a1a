"""host_ms.overlay_clip (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_clip``: the
clipping of the frustum's faces against the main camera's planes
(``frustum.clipping``, at most 6 a frame) (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_clip")
