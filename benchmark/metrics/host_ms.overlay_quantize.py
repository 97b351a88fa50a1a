"""host_ms.overlay_quantize (ms, program span; layer ``overlay``, moves
frame_ms): host self time per traced frame of ``tr.overlay_quantize``: the
overlaid float64 frame flipped, raised to gamma 0.8 and cast to uint8 in
numpy (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.overlay_quantize")
