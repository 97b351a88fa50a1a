"""host_ms.frame_inputs (ms, program span; layer ``Scene.render host path``,
moves frame_ms): host self time per traced frame of ``tr.frame_inputs``:
``pipeline.frame_inputs`` (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.frame_inputs")
