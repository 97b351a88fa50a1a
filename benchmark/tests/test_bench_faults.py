"""A run whose timed path is broken underneath comes out not correct: the
harness's look for a card is skipped (a CPU run at a small size) and the
rest of the run is driven as it is. Faults, where they are produced:

- a frame that returns its state unchanged (every frame the first one's
  outputs);
- half of the batch left out (the second half of the scene's models not
  rendered);
- an answer altered where it is produced (a square of the frame's pixels
  moved by 128 levels, or their winning face ids shifted by one).

A cell on one card has no exchange between cards to leave out."""
import pytest
import torch

from conftest import ROOT

CELLS = ["flagship-orbit", "crowd-instances-orbit"]
#: Side of the square of pixels an altered answer changes: at the tests'
#: 40 x 40 pixels, 100 pixels are 62,500 per million, over every limit.
SIDE = 10


def _stale(monkeypatch, scene_mod, pl):
    first = []

    def frame(cfg, dyn):
        if not first:
            first.append(pl.render_frame_jit(cfg, dyn))
        return tuple(t.clone() for t in first[0])

    monkeypatch.setattr(scene_mod, "render_frame_jit", frame)


def _half(monkeypatch, scene_mod, pl):
    prepare = scene_mod.Scene._prepare

    def half(self, resolution=None):
        models = self.models
        self.models = models[:max(1, len(models) // 2)]
        try:
            return prepare(self, resolution)
        finally:
            self.models = models

    monkeypatch.setattr(scene_mod.Scene, "_prepare", half)


def _altered(which):
    def patch(monkeypatch, scene_mod, pl):
        def frame(cfg, dyn):
            out = list(pl.render_frame_jit(cfg, dyn))
            t = out[which]
            h, w = t.shape[:2]
            sq = (slice(h // 2 - SIDE // 2, h // 2 + SIDE - SIDE // 2),
                  slice(w // 2 - SIDE // 2, w // 2 + SIDE - SIDE // 2))
            t[sq] = t[sq] ^ 128 if t.dtype == torch.uint8 else t[sq] + 1
            return tuple(out)

        monkeypatch.setattr(scene_mod, "render_frame_jit", frame)
    return patch


FAULTS = {"stale": _stale, "half": _half, "pixel": _altered(0),
          "tid": _altered(2)}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("cell", CELLS)
def test_fault_is_not_correct(cell, fault, small, monkeypatch):
    from rbench import runner
    from tpu_renderer_torch.models import scene as scene_mod
    from tpu_renderer_torch.ops import pipeline as pl

    FAULTS[fault](monkeypatch, scene_mod, pl)
    result, _ = runner.run(cell, 17, 0.3, False, root=ROOT, device="cpu",
                           config=small)
    assert result["correct"] is False, result["checks"]


def test_sound_run_is_correct(small):
    from rbench import runner

    result, _ = runner.run(CELLS[0], 17, 0.3, False, root=ROOT,
                           device="cpu", config=small)
    assert result["correct"] is True
    assert torch.cuda.is_available() or result["device"]["platform"] == "cpu"
