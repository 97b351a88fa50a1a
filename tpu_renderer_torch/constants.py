"""Coordinate conventions, index aliases and configuration enums.

Parity with the reference's ``obj/constants.py:1-42``: named fancy-index tuples for
coordinate columns (row-vector convention: points are rows, matrices
right-multiply), plus the ``PROJECTION_TYPE`` / ``SUBSYSTEM`` / ``SYSTEM`` enums.
``SYSTEM`` doubles as an arithmetic sign (LH=-1, RH=+1) exactly like the reference
(z-buffer init ``inf * system`` at core.py:590 and the depth-compare direction at
triangular.py:99-103).
"""
from __future__ import annotations

import numpy as np

# Fancy-index aliases (reference constants.py:5-16). These work on both numpy and
# torch tensors: pts[X] == pts[..., 0].
U = X = (..., 0)
V = Y = (..., 1)
Z = (..., 2)
W = (..., 3)
W_COL = (..., [3])
XY = (..., (0, 1))
XZ = (..., (0, 2))
YZ = (..., (1, 2))
XYZ = (..., slice(None, 3))
XYZW = None
mat3x3 = (slice(None, 3), slice(None, 3))
add_dim = (..., np.newaxis)


class PROJECTION_TYPE:
    PERSPECTIVE = 1
    ORTHOGRAPHIC = 2


class SUBSYSTEM:
    DIRECTX = 1
    OPENGL = 2


class SYSTEM:
    """Handedness used arithmetically as a sign (reference constants.py:29-31)."""

    LH = -1
    RH = 1


class Projection:
    """Default projection configuration bag (reference constants.py:34-37)."""

    projection_type: int = PROJECTION_TYPE.PERSPECTIVE
    system: int = SYSTEM.LH
    subsystem: int = SUBSYSTEM.OPENGL
