"""Per-face discard reasons (reference triangular.py:15-20).

The reference returns an ``Errors`` flag from each per-face ``rasterize`` call
and Scene.render tallies them per model (core.py:624-636). In the batched
pipeline these become boolean masks folded into face validity
(ops/vertex.gather_faces). ``Scene.stats()`` tallies them per model after a
render (``pipeline.face_statistics``) and keys its ``by_error`` counters by
these flags.
"""
from enum import Flag, auto

__all__ = ["Errors"]


class Errors(Flag):
    BACK_FACE_CULLING = auto()
    WRONG_MIN_MAX = auto()
    EMPTY_B = auto()
    EMPTY_Z = auto()
    CLIPPED = auto()
