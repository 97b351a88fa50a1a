"""frame_p95_ms (ms, host clock): the 95th percentile of every frame's
latency in the window (from just before the frame's moves to the return of
``Scene.render()``), the stutter a viewer sees."""
import numpy as np


def read(run, part=None):
    if run.trace is not None or not run.latencies:
        return None
    return float(np.percentile(np.asarray(run.latencies), 95)) * 1e3
