"""host_ms.program_inputs (ms, program span; layer ``Scene.render host
path``, moves frame_ms): host self time per traced frame of
``tr.program_inputs``: the input tree of a compiled frame,
``pipeline._jit``'s ``_body_dyn`` (each model's vertices and maps, the
light, the background) and its face tables set apart (rbench/inside.py
``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.program_inputs")
