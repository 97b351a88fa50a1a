"""host_ms.read_timers (ms, program span; layer ``replay``, moves frame_ms):
host self time per traced frame of ``tr.read_timers``: the system's own read
of a traced replay's stage stamps, ``profiling.read_replay_timers``: the
wait for the replay's event and the copy of the stamps; absent from untraced
frames (rbench/inside.py ``host_ms``)."""
from rbench import inside

read = inside.reader("host_ms.read_timers")
