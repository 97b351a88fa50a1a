"""host_ms.overlay_kernel (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_kernel``: K11's
call (``raster_cuda.overlay``): its checks, the table's upload, its scratch
and its launch (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_kernel")
