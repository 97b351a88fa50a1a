"""The control, the reference in TF32 put in the system's place, comes out
not correct: on the CPU at a small size, and on a card at the cells' own
sizes (three seeds each)."""
import pytest

from conftest import ROOT

CELLS = ["flagship-orbit", "crowd-instances-orbit"]


@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_small(cell, small):
    from rbench import check
    from rbench.control import readings

    for seed in (101, 102, 2**31 + 103):
        correct, checks = check.judge(readings(cell, seed, "cpu",
                                               config=small, root=ROOT))
        assert not correct, checks


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_at_size(cell, cuda):
    from rbench import check
    from rbench.control import readings

    for seed in (2000000001, 2000000002, 2000000003):
        correct, checks = check.judge(readings(cell, seed, cuda, root=ROOT))
        assert not correct, checks


@pytest.mark.parametrize("cell", CELLS)
def test_witness_reads_below_the_control(cell, small):
    """The float64 witness, sound arithmetic rounded otherwise, moves far
    fewer winners and depths than the TF32 control."""
    from rbench.control import readings

    for seed in (101, 2**31 + 103):
        w = readings(cell, seed, "cpu", config=small, root=ROOT, witness=True)
        c = readings(cell, seed, "cpu", config=small, root=ROOT)
        for k in ("tid_ppm", "zbuf_ppm"):
            assert max(r[k] for r in w) * 3 < min(r[k] for r in c), (k, w, c)
