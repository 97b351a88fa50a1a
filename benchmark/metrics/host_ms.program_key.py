"""host_ms.program_key (ms, program span; layer ``replay``, moves frame_ms):
host self time per traced frame of ``tr.program_key``: the compiled frame's
key, ``compiled.call``: the inputs' signature and aliases, the key's hash
and its look-up in the program cache (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.program_key")
