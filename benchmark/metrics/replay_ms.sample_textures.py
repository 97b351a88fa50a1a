"""replay_ms.sample_textures (ms, program span; layer ``sample_textures``,
moves frame_ms): device ms per replayed frame of ``tr.sample_textures``,
between its two stamps (rbench/inside.py ``replay_ms``)."""
from rbench import inside

read = inside.reader("replay_ms.sample_textures")
