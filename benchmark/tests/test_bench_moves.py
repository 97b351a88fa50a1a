"""Configurations and traffic that no cell uses yet run from data alone: a
scene submitted merged, and a texture painted every frame. Each comes out
correct on the CPU at a small size, and a system that misses the change
comes out not correct."""
import numpy as np
import pytest

from conftest import ROOT

PAINT = {"frames_per_turn": 600, "moves": [
    {"kind": "orbit", "target": "camera", "about": [0.5, 3.0, 0.0],
     "sin": [5.05, 0.0, 0.0], "cos": [0.0, 0.0, 5.05]},
    {"kind": "paint", "model": 0, "map": "kd", "size": 12}]}


def test_merged_submission_is_correct(small):
    from rbench import runner

    result, _ = runner.run("crowd-instances-orbit", 23, 0.3, False,
                           root=ROOT, device="cpu",
                           config={**small, "submission": "merged"})
    assert result["correct"] is True, result["checks"]


@pytest.mark.parametrize("kind", ["kd", "norm"])
def test_painted_texture_is_correct(small, kind):
    from rbench import runner

    mix = {**PAINT, "moves": [PAINT["moves"][0],
                              {**PAINT["moves"][1], "map": kind}]}
    result, _ = runner.run("flagship-orbit", 29, 0.3, False, root=ROOT,
                           device="cpu", config=small, traffic=mix)
    assert result["correct"] is True, result["checks"]


def test_paint_the_system_misses_is_not_correct(small, monkeypatch):
    from rbench import runner, scenes

    monkeypatch.setattr(scenes.Port, "set_map", lambda *a: None)
    # The whole of the floor's 16 x 16 map at the tests' size, so that the
    # miss changes more of the frame than the limits let pass.
    mix = {**PAINT, "moves": [PAINT["moves"][0],
                              {**PAINT["moves"][1], "model": 1,
                               "size": 16}]}
    result, _ = runner.run("flagship-orbit", 29, 0.3, False, root=ROOT,
                           device="cpu", config=small, traffic=mix)
    assert result["correct"] is False, result["checks"]


def test_paint_values_follow_seed_and_frame(reg, small):
    from rbench import scenes
    from rbench.traffic import Traffic

    spec = scenes.build({**reg.config(reg.cell("flagship-orbit")), **small},
                        3)
    a, b = Traffic(PAINT, 5, spec), Traffic(PAINT, 5, spec)
    for i in (-2, 0, 7):
        ma, mb = a.view(a.at(i))["maps"][0]["kd"], b.view(b.at(i))["maps"][0][
            "kd"]
        np.testing.assert_array_equal(ma, mb)
        assert (ma != spec.models[0].map_kd).any()
    assert (a.view(a.at(1))["maps"][0]["kd"]
            != a.view(a.at(2))["maps"][0]["kd"]).any()
