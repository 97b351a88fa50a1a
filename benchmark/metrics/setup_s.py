"""setup_s (s, host clock): from the start of the run's process to the end
of the warm frames: importing torch and the system, loading (on a
checkout's first run, building) the kernel library, building the scene
from the seed, the first packing and upload, the first frame (warm-up and
capture) and the warm frames. The result's ``setup`` key gives each part
and whether this run built the library."""


def read(run, part=None):
    if run.trace is not None:
        return None
    return run.setup_s
