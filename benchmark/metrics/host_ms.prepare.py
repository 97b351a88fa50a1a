"""host_ms.prepare (ms, program span; layer ``Scene.render host path``, moves
frame_ms): host self time per traced frame of ``tr.prepare``:
``Scene._prepare`` (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.prepare")
