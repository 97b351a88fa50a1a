"""The one generator of a traffic mix's per-frame moves.

A mix (``traffic/<name>.json``) is data:

- ``frames_per_turn``: the angle ``t`` advances 2 pi over that many
  frames; its start ``t0`` is drawn from the run's seed, uniform over the
  turn, so every seed renders the same views in another order;
- ``moves``: a list of moves, each an object whose ``kind`` names its file
  ``moves/<kind>.py`` and whose other keys are its parameters.

A move's file defines ``Move(params, spec, seed)`` with ``at(i, t)``, the
value of frame ``i`` (negative for set-up's warm frames) at angle ``t =
t0 + i * 2 pi / frames_per_turn``; ``apply(port, value)``, which makes the
change on the system (a ``scenes.Port``) before its ``render()``; and
``view(view, value)``, which makes it on the reference's ``render``
arguments (``camera`` and ``light`` positions, float32 (3,), and ``maps``).
Values are computed from the seed, the index and ``t`` alone, so the
reference can render any frame of the window again.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import numpy as np

from rbench.registry import plugin

__all__ = ["Frame", "Traffic"]


@dataclasses.dataclass(frozen=True)
class Frame:
    index: int
    values: Tuple                    # one per move of the mix


class Traffic:
    """The moves of ``mix`` (a traffic file's object) over ``spec`` for
    ``seed``."""

    def __init__(self, mix: dict, seed: int, spec):
        self.mix = mix
        self.spec = spec
        self.frames_per_turn = int(mix["frames_per_turn"])
        self.step = 2 * math.pi / self.frames_per_turn
        self.t0 = float(np.random.default_rng([int(seed), 1]).uniform(
            0.0, 2 * math.pi))
        self.moves = [plugin("moves", m["kind"]).Move(m, spec, seed)
                      for m in mix["moves"]]

    def at(self, i: int) -> Frame:
        t = self.t0 + i * self.step
        return Frame(i, tuple(m.at(i, t) for m in self.moves))

    def apply(self, port, frame: Frame):
        for m, value in zip(self.moves, frame.values):
            m.apply(port, value)

    def view(self, frame: Frame) -> dict:
        """The reference's ``render`` arguments for ``frame``."""
        f32 = lambda a: np.asarray(a, np.float32)
        view = {"camera": f32(self.spec.camera["position"]),
                "light": f32(self.spec.light["position"]), "maps": {}}
        for m, value in zip(self.moves, frame.values):
            m.view(view, value)
        return view
