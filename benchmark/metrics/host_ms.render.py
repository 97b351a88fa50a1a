"""host_ms.render (ms, program span; layer ``Scene.render host path``, moves
frame_ms): host self time per traced frame of ``tr.render``: the Python of
``Scene.render()`` that no other span covers (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.render")
