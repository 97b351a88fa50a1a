"""visibility_roofline (%, device trace; layer ``visibility``, moves
frame_ms): the least time the frame's visibility work needs
(rbench/roofline.py, counted from the scene by the reference) over the
device time of ``visibility_kernel`` and the ``coarse_bins_kernel`` launch
before it, summed over the traced frames that the reference rendered."""
from rbench.roofline import share


def read(run, part=None):
    return share(run, "visibility", "visibility_kernel")
