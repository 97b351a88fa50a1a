"""host_ms.readback (ms, program span; layer ``quantize``, moves frame_ms):
host self time per traced frame of ``tr.readback``: the frame's copy to the
host, and the wait for it (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.readback")
