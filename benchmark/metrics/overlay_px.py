"""overlay_px (px, program counter; layer ``overlay``, moves frame_ms):
line pixels the debug camera's host overlay wrote per overlaid frame, over
the run's frames (``profiling.snapshot()["overlay"]``: its ``pixels`` over
its ``frames``). None where the system keeps no such counter or drew no
overlay."""
from rbench import inside


def read(run, part=None):
    snap = inside.counters()
    overlay = (snap or {}).get("overlay")
    if not overlay or not overlay.get("frames"):
        return None
    return overlay["pixels"] / overlay["frames"]
