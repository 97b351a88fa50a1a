"""The comparison that decides ``correct``.

For each sampled frame of the window the system's outputs (the uint8 frame
``Scene.render()`` returned, and ``last_zbuf``, ``last_tid`` and
``last_stencil``) are held to the reference's frame at the same moves.
Each number compared is a share of the frame's pixels, in pixels per
million, the largest over the sampled frames:

- ``frame_ppm``: pixels with a channel more than ``FRAME_LEVELS`` levels
  off;
- ``tid_ppm``: pixels whose winning face differs, each face named by its
  number in the scene (the models' faces counted in order), not by the
  system's internal ids;
- ``zbuf_ppm``: pixels whose depth is more than ``ZBUF_REL`` of the
  reference's off (equal infinities and NaNs are equal);
- ``stencil_ppm``: pixels whose shadow stencil differs.

The tolerances let sound arithmetic of another order or precision pass;
each limit (``LIMITS``) lies between what sound arithmetic reads and what
the control reads, and PERF.md gives the readings each was set from.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LIMITS", "FRAME_LEVELS", "ZBUF_REL", "compare", "judge"]

#: The most pixels per million of a sampled frame that may differ, by number.
LIMITS = {"frame_ppm": 40000, "tid_ppm": 20000, "zbuf_ppm": 20000,
          "stencil_ppm": 20000}
#: Levels (of 255) a channel may be off without counting.
FRAME_LEVELS = 4
#: Share of the reference's depth a depth may be off without counting.
ZBUF_REL = 1e-4


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) \
        else np.asarray(x)


def compare(program, reference):
    """{number: pixels per million} of one frame. ``program``: (frame,
    zbuf, face numbers, stencil) of the system; ``reference``: a
    ``reference.Output``."""
    frame, zbuf, faces, stencil = (_np(x) for x in program)
    rf, rz, rt, rs = (_np(x) for x in (reference.frame, reference.zbuf,
                                       reference.tid, reference.stencil))
    n = rf.shape[0] * rf.shape[1]
    if (frame.shape != rf.shape or zbuf.shape != rz.shape
            or faces.shape != rt.shape or stencil.shape != rs.shape):
        return {k: 1e6 for k in LIMITS}
    off = np.abs(frame.astype(np.int32) - rf.astype(np.int32)).max(-1)
    z, r = zbuf.astype(np.float64), rz.astype(np.float64)
    with np.errstate(invalid="ignore"):
        z_ok = ((z == r) | (np.isnan(z) & np.isnan(r))
                | (np.abs(z - r) <= ZBUF_REL * np.abs(r)))
    ppm = lambda bad: int(bad.sum()) * 1e6 / n
    return {"frame_ppm": ppm(off > FRAME_LEVELS),
            "tid_ppm": ppm(faces != rt),
            "zbuf_ppm": ppm(~z_ok),
            "stencil_ppm": ppm(stencil != rs)}


def judge(readings):
    """(correct, {number: {"value": largest reading, "limit": limit}}) of
    a run's per-frame readings; no reading is not correct."""
    checks = {k: {"value": max((r[k] for r in readings), default=None),
                  "limit": lim} for k, lim in LIMITS.items()}
    correct = bool(readings) and all(
        c["value"] is not None and c["value"] <= c["limit"]
        for c in checks.values())
    return correct, checks
