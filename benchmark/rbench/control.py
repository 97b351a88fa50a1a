"""The control, and a second witness of sound arithmetic, in the system's
place.

The configurations state float32 with TF32 off; the nearest precision
below is TF32, the step a later change might take by computing its matrix
products on tensor cores. :func:`readings` renders a cell's frames, drawn
from the seed as a run samples them, with the cell's reference in float32
and in TF32 (the control), or in float64 (``witness``: sound arithmetic
rounded otherwise), and compares that frame with the float32 one as a run
compares the system's. The control has to come out not correct; the
witness reads what sound arithmetic of another order may move.
"""
from __future__ import annotations

import numpy as np
import torch

from rbench import check, scenes
from rbench.registry import Registry, plugin
from rbench.runner import SAMPLE
from rbench.traffic import Traffic

__all__ = ["readings"]


def readings(workload, seed, device, config=None, root=None, frames=SAMPLE,
             witness=False):
    """[{number: pixels per million}] of ``frames`` frames of
    ``workload`` for ``seed``: the TF32 (or, with ``witness``, the float64)
    reference against the float32 one."""
    reg = Registry(root)
    cell = reg.cell(workload)
    cfg = {**reg.config(cell), **(config or {})}
    mix = reg.traffic(cell)
    spec = scenes.build(cfg, seed)
    moves = Traffic(mix, seed, spec)
    Reference = plugin("references", spec.settings["reference"]).Reference
    rng = np.random.default_rng([int(seed), 3])
    ref = Reference(spec, device)
    other = (Reference(spec, device, dtype=torch.float64) if witness
             else Reference(spec, device, tf32=True))
    out = []
    for i in rng.integers(0, moves.frames_per_turn, frames):
        view = moves.view(moves.at(int(i)))
        a, b = ref.render(**view), other.render(**view)
        out.append(check.compare((b.frame, b.zbuf, b.tid, b.stencil), a))
    return out
