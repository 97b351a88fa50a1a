"""ssaa_roofline (%, program span; layer ``ssaa``, moves frame_ms): the
least time the box filter of a supersampled frame needs over its device
ms per replayed frame (``replay_ms.ssaa``, between ``tr.ssaa``'s stamps).

The work is counted from the reference's counts of the sampled frames,
never from the system's tables: the float32 RGB frame inside
(``counts["pixels"]``, ss * ss times the frame's pixels) read once and the
filtered frame (``counts["out_pixels"]``) written once, 12 bytes a pixel
each, over the H100's 3.35 TB/s (``rbench.roofline.PEAK_BYTES_S``);
operations: one addition or the final scaling per input value, over 67
TFLOP/s. At 1024x1024 out and ss 2 that is 62.9 MB, 18.8 us, by bytes.
"""
from rbench import inside
from rbench.roofline import PEAK_BYTES_S, PEAK_F32_S


def least_time(counts):
    """(seconds, "bytes" or "operations") of one frame's box filter."""
    nbytes = 12 * (counts["pixels"] + counts["out_pixels"])
    ops = 3 * counts["pixels"]
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def read(run, part=None):
    spent = inside.replay_ms(run, "ssaa")
    frames = [c for c in run.counts.values() if "out_pixels" in c]
    if not spent or not frames:
        return None
    least = sum(least_time(c)[0] for c in frames) / len(frames)
    return least / (spent * 1e-3) * 100.0
