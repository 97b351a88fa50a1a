"""The supersampled flagship (``flagship-ssaa2``: ``Scene(supersample=2)``)
against its reference ``general_ssaa``, and the flagship under the
``orbit-paint`` traffic (no cell runs it: at 10 s a window its frame times
spread too widely for the bounds), on the CPU at the tests' small size
(40 x 40 out, 80 x 80 inside).

- the system's frame agrees with the reference's within ``FRAME_LEVELS``,
  and its z-buffer, winners and stencil at the size inside equal the
  reference's;
- the reference's box filter is a block mean, as numpy takes it;
- each reference renders only its own supersampling;
- a run of the supersampled cell, and one of the flagship painted every
  frame, is correct, and a run whose supersampled path is broken is not: a stale frame, a filter that takes every ss-th pixel in
  place of the block mean, a square of winners shifted by one;
- what the check reads where the system misses the paint: the frame
  differs, but by less than the frame limit, so the run is correct and a
  paint cell could not tell a skipped map upload.
"""
import json
import os

import numpy as np
import pytest
import torch

from conftest import ROOT

SSAA = "flagship-ssaa2-orbit"
#: The flagship's cell and the traffic that paints model 0's diffuse map
#: every frame.
PAINT = ("flagship-orbit", "orbit-paint")
#: Side of the square of winners the shifted fault changes: 100 pixels
#: inside, 62,500 per million of the 40 x 40 frame, over the limit.
SIDE = 10


def _spec(reg, cell, small, seed):
    from rbench import scenes

    return scenes.build({**reg.config(reg.cell(cell)), **small}, seed)


@pytest.mark.parametrize("seed", [3, 2**31 + 29])
def test_port_agrees_with_the_reference(reg, small, seed):
    import tpu_renderer_torch as tr
    from rbench import check, runner, scenes
    from rbench.registry import plugin
    from rbench.traffic import Traffic

    spec = _spec(reg, SSAA, small, seed)
    assert spec.settings["supersample"] == 2
    moves = Traffic(reg.traffic(reg.cell(SSAA)), seed, spec)
    port = scenes.port_scene(tr, spec, "cpu")
    ref = plugin("references", "general_ssaa").Reference(spec, "cpu")
    table = port.face_table()
    for i in (0, 7, 150):
        move = moves.at(i)
        moves.apply(port, move)
        frame = port.scene.render()
        out = ref.render(**moves.view(move))
        assert frame.shape == (40, 40, 3) and out.frame.shape == (40, 40, 3)
        off = np.abs(frame.astype(np.int32)
                     - out.frame.numpy().astype(np.int32)).max()
        print(f"frame {i}: largest level difference {off}")
        assert off <= check.FRAME_LEVELS
        assert port.scene.last_zbuf.shape == (80, 80)
        assert torch.equal(port.scene.last_zbuf.cpu(), out.zbuf)
        assert torch.equal(runner._numbered(port.scene.last_tid, table),
                           out.tid)
        assert torch.equal(port.scene.last_stencil.cpu(), out.stencil)
        assert out.counts["pixels"] == 80 * 80
        assert out.counts["out_pixels"] == 40 * 40
    tr.clear_compiled()


@pytest.mark.parametrize("ss", [1, 2, 3])
def test_box_filter_is_the_block_mean(ss):
    from rbench.registry import plugin

    box_filter = plugin("references", "general_ssaa").box_filter
    rng = np.random.default_rng(ss)
    frame = rng.uniform(0, 1, (6 * ss, 4 * ss, 3)).astype(np.float32)
    want = frame.astype(np.float64).reshape(6, ss, 4, ss, 3).mean(
        axis=(1, 3))
    got = box_filter(torch.from_numpy(frame), ss)
    assert got.shape == (6, 4, 3) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)


def test_each_reference_renders_its_own_supersampling(reg, small):
    from rbench.registry import plugin

    ssaa = plugin("references", "general_ssaa").Reference
    general = plugin("references", "general").Reference
    spec = _spec(reg, SSAA, small, 5)
    with pytest.raises(ValueError, match="supersample"):
        general(spec, "cpu")
    for ss in (1, 3):
        spec.settings["supersample"] = ss
        with pytest.raises(ValueError, match="supersample"):
            ssaa(spec, "cpu")
    spec.settings["supersample"] = 2
    ref = ssaa(spec, "cpu")
    assert (ref.height, ref.width) == (80, 80)


def _traffic(name):
    if name is None:
        return None
    with open(os.path.join(ROOT, "benchmark", "traffic",
                           name + ".json")) as f:
        return json.load(f)


@pytest.mark.parametrize("cell, traffic", [(SSAA, None), PAINT],
                         ids=[SSAA, "flagship-paint"])
def test_cell_run_is_correct(cell, traffic, small):
    from rbench import runner

    result, _ = runner.run(cell, 2**31 + 17, 0.3, False, root=ROOT,
                           device="cpu", config=small,
                           traffic=_traffic(traffic))
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0


@pytest.mark.parametrize("seed", [3, 2**31 + 17])
def test_paint_the_system_misses_reads_under_the_frame_limit(small, seed,
                                                            monkeypatch):
    """The paint never reaches the system: at the tests' size the 32 x 32
    square covers the whole 16 x 16 map, and the frame still reads under
    the frame limit. A check that can see a stale map (one that counts
    only the painted texels' pixels) would make this run not correct."""
    from rbench import check, runner, scenes

    monkeypatch.setattr(scenes.Port, "set_map", lambda *a: None)
    result, _ = runner.run(PAINT[0], seed, 0.3, False, root=ROOT,
                           device="cpu", config=small,
                           traffic=_traffic(PAINT[1]))
    checks = result["checks"]
    print("a missed paint reads", {k: c["value"] for k, c in checks.items()})
    assert 0 < checks["frame_ppm"]["value"] < check.LIMITS["frame_ppm"]
    assert all(checks[k]["value"] == 0
               for k in ("tid_ppm", "zbuf_ppm", "stencil_ppm"))
    assert result["correct"] is True


def _stale(monkeypatch, scene_mod, pl):
    first = []

    def frame(cfg, dyn, ss):
        if not first:
            first.append(pl.render_ssaa_jit(cfg, dyn, ss))
        return tuple(t.clone() for t in first[0])

    monkeypatch.setattr(scene_mod, "render_ssaa_jit", frame)


def _strided(monkeypatch, scene_mod, pl):
    def body(cfg, dyn, st, ss, ops):
        frame, zbuf, tid, stencil = pl._core(cfg, dyn, st, ops)
        return pl._quantize(frame[::ss, ::ss]), zbuf, tid, stencil

    monkeypatch.setattr(pl, "_ssaa", body)


def _shifted(monkeypatch, scene_mod, pl):
    def frame(cfg, dyn, ss):
        out = list(pl.render_ssaa_jit(cfg, dyn, ss))
        t = out[2]
        h, w = t.shape
        sq = (slice(h // 2 - SIDE // 2, h // 2 + SIDE - SIDE // 2),
              slice(w // 2 - SIDE // 2, w // 2 + SIDE - SIDE // 2))
        t[sq] = t[sq] + 1
        return tuple(out)

    monkeypatch.setattr(scene_mod, "render_ssaa_jit", frame)


FAULTS = {"stale": _stale, "strided": _strided, "tid": _shifted}


@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_ssaa_fault_is_not_correct(fault, small, monkeypatch):
    import tpu_renderer_torch as tr
    from rbench import runner
    from tpu_renderer_torch.models import scene as scene_mod
    from tpu_renderer_torch.ops import pipeline as pl

    tr.clear_compiled()
    FAULTS[fault](monkeypatch, scene_mod, pl)
    try:
        result, _ = runner.run(SSAA, 17, 0.3, False, root=ROOT,
                               device="cpu", config=small)
    finally:
        tr.clear_compiled()
    assert result["correct"] is False, result["checks"]


#: Counters of two replays under a profiler: 8 ms of ``tr.ssaa`` in all.
SNAPSHOT = {"copies": {}, "replays": 2,
            "replay_ms": {"vertex": 1.0, "ssaa": 8.0}}
#: The reference's counts of a sampled frame at 1024 x 1024 out, ss 2.
COUNTS = {"faces": 10, "fragments": 100, "quads": 1, "quad_tests": 10,
          "pixels": 2048 * 2048, "out_pixels": 1024 * 1024}


def _traced(counts):
    from rbench import tracing
    from rbench.runner import RunRecord

    rec = RunRecord()
    rec.trace, rec.trace_ok, rec.counts = tracing.Trace([]), True, counts
    return rec


def test_ssaa_readers_on_a_canned_snapshot(reg, monkeypatch):
    from tpu_renderer_torch.utils import profiling

    monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
    read, part = reg.reader("replay_ms.ssaa")
    assert read(_traced({4: COUNTS}), part) == pytest.approx(4.0)
    # 12 bytes a pixel read inside and written out, 62.9 MB, 18.78 us at
    # 3.35 TB/s, over 4 ms a replay.
    read, part = reg.reader("ssaa_roofline")
    want = 12 * (2048 ** 2 + 1024 ** 2) / 3.35e12 / 4e-3 * 100
    assert read(_traced({4: COUNTS, 9: COUNTS}), part) == pytest.approx(want)


@pytest.mark.parametrize("name", ["replay_ms.ssaa", "ssaa_roofline"])
def test_ssaa_readers_give_none_with_nothing_to_read(reg, monkeypatch, name):
    """No trace, a system without counters or without the span, and for
    the roofline counts of a frame that was not supersampled."""
    from rbench.runner import RunRecord
    from tpu_renderer_torch.utils import profiling

    read, part = reg.reader(name)
    assert read(RunRecord(), part) is None
    monkeypatch.delattr(profiling, "snapshot")
    assert read(_traced({4: COUNTS}), part) is None
    monkeypatch.setattr(profiling, "snapshot", lambda: {
        **SNAPSHOT, "replay_ms": {"vertex": 1.0}}, raising=False)
    assert read(_traced({4: COUNTS}), part) is None
    if name == "ssaa_roofline":
        monkeypatch.setattr(profiling, "snapshot", lambda: SNAPSHOT)
        plain = {k: v for k, v in COUNTS.items() if k != "out_pixels"}
        assert read(_traced({4: plain}), part) is None
