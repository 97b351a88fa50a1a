"""Published peaks of one NVIDIA H100 and the least time a kernel's work
needs on it.

The work is counted from the scene and the reference's outputs
(``reference.Output.counts``), never from the system's tables, so a
redesign of a kernel's tables leaves the count as it is. Each input byte
is counted read once and each output byte written once.

- visibility (csrc/bins.cu + K1): every face that survives culling and
  the screen (``faces``) reads its three projected vertices, x, y, z and
  1/w in float32 (48 bytes); z and the face id are written once per pixel
  (8 bytes). Operations: one depth test per covered (face, pixel)
  fragment (``fragments``), the plane-equation depth and its compare, 5
  float operations.
- stencil (csrc/bins.cu + K4): every silhouette quad (``quads``) reads its
  four homogeneous vertices (64 bytes); the z-buffer is read and the
  stencil written once per pixel (8 bytes). Operations: one depth test per
  (quad, foreground pixel) fragment inside the quad (``quad_tests``): the
  plane depth (4), its denominator (2), the multiply-compare (3), 9 float
  operations.
"""
from __future__ import annotations

from rbench.tracing import BINS

__all__ = ["PEAK_BYTES_S", "PEAK_F32_S", "least_time", "share", "WORK"]

#: HBM3 bandwidth and float32 rate outside the tensor cores (NVIDIA H100
#: SXM data sheet, dense, at the 700 W power limit).
PEAK_BYTES_S = 3.35e12
PEAK_F32_S = 67e12


def _visibility(c):
    return 48 * c["faces"] + 8 * c["pixels"], 5 * c["fragments"]


def _stencil(c):
    return 64 * c["quads"] + 8 * c["pixels"], 9 * c["quad_tests"]


#: (bytes, float operations) of a frame's work, by kernel.
WORK = {"visibility": _visibility, "stencil": _stencil}


def least_time(kernel, counts):
    """(seconds, "bytes" or "operations"): the larger of the bytes over the
    peak bandwidth and the operations over the peak float32 rate."""
    nbytes, ops = WORK[kernel](counts)
    t_bytes, t_ops = nbytes / PEAK_BYTES_S, ops / PEAK_F32_S
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def share(run, kernel, symbol, bins=BINS):
    """Percent of a kernel's roofline over the traced frames the reference
    rendered: the sum of their least times over the sum of the device time
    of ``symbol`` and the ``bins`` launch just before it in each frame.
    None where no such frame holds the kernel."""
    if run.trace is None or not run.trace_ok or not run.counts:
        return None
    by_frame = run.trace.kernels_by_frame()
    least = spent = 0.0
    for index, counts in run.counts.items():
        kernels = by_frame.get(index, [])
        for j, e in enumerate(kernels):
            if symbol not in e["name"]:
                continue
            spent += e["dur"] * 1e-6
            before = [k for k in kernels[:j] if bins in k["name"]]
            if before:
                spent += before[-1]["dur"] * 1e-6
            least += least_time(kernel, counts)[0]
    return None if spent == 0 else least / spent * 100.0
