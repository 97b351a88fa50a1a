"""The reference renderer's demo frame (``reference-main``: a directional
light, shadow volumes, a debug camera that clips every fragment and whose
frustum is drawn over the frame) against its reference ``main_debug``, on
the CPU at 150 x 150 (no multiple of the kernels' tiles), 12 x 18 mesh
bands and 64 x 64 maps, with the configuration's own cameras.

- the system, made by ``port_scene`` and the ``debug_camera`` move, equals
  the reference bit for bit: the frame, the z-buffer as the overlay left
  it, the winners, the stencil; the overlay's line pixels (the system's
  counter against the reference's count) and the region the debug camera
  clips are the same pixels;
- a run of the cell is correct, on a seed used while the reference was
  written and on one that was not;
- planted faults are not correct: no debug camera, ``debug_overlay =
  False``, the overlay drawn one pixel to the side; a point light in place
  of the directional one changes only the shading of the small foreground
  the debug camera keeps and reads under the frame limit, so its test
  asserts the exact reading; the readings of each are printed;
- the control (the reference in TF32) is not correct, the float64
  witness is;
- the move installs the debug camera once and hands the reference the
  same one; the reference renders only a directional light.
"""
import numpy as np
import pytest
import torch

from conftest import ROOT

CELL = "reference-main-orbit"
#: The cell's size on the CPU: 150 x 150 pixels, small meshes and maps.
SMALL = {"resolution": [150, 150], "texture_size": 64, "mesh_bands": [12, 18]}


def _spec(reg, seed):
    from rbench import scenes

    return scenes.build({**reg.config(reg.cell(CELL)), **SMALL}, seed)


@pytest.mark.parametrize("seed", [3, 2**31 + 71])
def test_port_equals_the_reference(reg, seed):
    import tpu_renderer_torch as tr
    from rbench import runner, scenes
    from rbench.registry import plugin
    from rbench.traffic import Traffic
    from tpu_renderer_torch.utils import profiling

    spec = _spec(reg, seed)
    assert spec.settings["light_type"] == "directional"
    moves = Traffic(reg.traffic(reg.cell(CELL)), seed, spec)
    port = scenes.port_scene(tr, spec, "cpu")
    ref = plugin("references", "main_debug").Reference(spec, "cpu")
    plain = plugin("references", "main_debug").Reference(spec, "cpu")
    table = port.face_table()
    for i in (-6, 0, 150):
        move = moves.at(i)
        moves.apply(port, move)
        profiling.reset()
        frame = port.scene.render()
        drawn = profiling.snapshot()["overlay"]
        view = moves.view(move)
        out = ref.render(**view)
        assert frame.shape == (150, 150, 3)
        np.testing.assert_array_equal(frame, out.frame.numpy())
        zb = port.scene.last_zbuf
        assert zb.dtype == out.zbuf.dtype == torch.float64
        assert torch.equal(zb, out.zbuf)
        tid = runner._numbered(port.scene.last_tid, table)
        assert torch.equal(tid, out.tid)
        assert torch.equal(port.scene.last_stencil.cpu(), out.stencil)
        # The overlay's line pixels, and the region the debug camera
        # clips: the reference without the debug camera wins more.
        assert drawn["frames"] == 1 and drawn["segments"] > 0
        assert drawn["pixels"] == out.counts["overlay_pixels"] > 100
        whole = plain.render(view["camera"], view["light"], view["maps"])
        assert whole.counts["overlay_pixels"] == 0
        kept = out.tid >= 0
        assert torch.equal(kept, (whole.tid >= 0) & kept)
        share = int(kept.sum()) / int((whole.tid >= 0).sum())
        print(f"frame {i}: {drawn}, foreground {int(kept.sum())} px, "
              f"{share:.3f} of the frame without the debug camera")
        assert 0.02 < share < 0.5
        assert (out.stencil[kept] != 0).any()
    tr.clear_compiled()


@pytest.mark.parametrize("seed", [3, 2**31 + 71])
def test_cell_run_is_correct(seed):
    from rbench import runner

    result, _ = runner.run(CELL, seed, 0.3, False, root=ROOT, device="cpu",
                           config=SMALL)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 1 and result["failed"] == 0
    assert all(c["value"] == 0 for c in result["checks"].values())


def _port_scene(monkeypatch, change):
    from rbench import scenes

    make = scenes.port_scene

    def port_scene(tr, spec, device):
        port = make(tr, spec, device)
        change(tr, port.scene)
        return port

    monkeypatch.setattr(scenes, "port_scene", port_scene)


def _no_debug_camera(monkeypatch):
    from rbench.registry import plugin

    monkeypatch.setattr(plugin("moves", "debug_camera").Move, "apply",
                        lambda self, port, value: None)


def _point_light(monkeypatch):
    def change(tr, scene):
        scene.light.light_type = tr.Lightning.POINT_LIGHTNING

    _port_scene(monkeypatch, change)


def _no_overlay(monkeypatch):
    _port_scene(monkeypatch, lambda tr, scene: setattr(
        scene, "debug_overlay", False))


def _overlay_shifted(monkeypatch):
    """The overlay's pixels written one column to the side."""
    from tpu_renderer_torch.models import scene as scene_mod

    draw = scene_mod.draw_view_frustum

    def shifted(frame, camera_m, debug_m, position, near, far, resolution,
                zb, sign):
        f, z = frame.copy(), zb.copy()
        drawn = draw(f, camera_m, debug_m, position, near, far, resolution,
                     z, sign)
        wrote = (f != frame).any(-1) | ((z != zb) & ~(np.isnan(z)
                                                       & np.isnan(zb)))
        to = np.roll(wrote, 1, axis=1)
        frame[to], zb[to] = f[wrote], z[wrote]
        return drawn

    monkeypatch.setattr(scene_mod, "draw_view_frustum", shifted)


FAULTS = {"no_debug_camera": _no_debug_camera, "point_light": _point_light,
          "no_overlay": _no_overlay, "overlay_shifted": _overlay_shifted}
#: Frames of the window a fault's exact reading is taken at.
FRAMES = (0, 150, 400)
#: What the check reads of a fault that the global limits let pass, at
#: FRAMES for seed 17: a point light in place of the directional one
#: changes only the shading of the foreground the debug camera keeps
#: (about 2% of the frame) and the shadows on it: at most 249 of the
#: 22,500 pixels differ in colour (11,067 per million against the frame
#: limit of 40,000) and 35 in the stencil (1,556 against 20,000): correct.
PASSES = {"point_light": {"frame_ppm": 249 * 1e6 / 150**2, "tid_ppm": 0.0,
                          "zbuf_ppm": 0.0,
                          "stencil_ppm": 35 * 1e6 / 150**2}}


def _fault_readings(reg, fault, monkeypatch):
    """(correct, checks) of the system with ``fault`` planted, held to the
    reference at FRAMES of seed 17's window as a run holds its sampled
    frames (a run's own sample follows its window's timing)."""
    import tpu_renderer_torch as tr
    from rbench import check, runner, scenes
    from rbench.registry import plugin
    from rbench.traffic import Traffic

    FAULTS[fault](monkeypatch)
    spec = _spec(reg, 17)
    moves = Traffic(reg.traffic(reg.cell(CELL)), 17, spec)
    port = scenes.port_scene(tr, spec, "cpu")
    ref = plugin("references", "main_debug").Reference(spec, "cpu")
    table = port.face_table()
    moves.apply(port, moves.at(-6))
    readings = []
    for i in FRAMES:
        move = moves.at(i)
        moves.apply(port, move)
        frame = port.scene.render()
        s = port.scene
        readings.append(check.compare(
            (frame, s.last_zbuf, runner._numbered(s.last_tid, table),
             s.last_stencil), ref.render(**moves.view(move))))
    tr.clear_compiled()
    print(fault, "reads", readings)
    correct, checks = check.judge(readings)
    return correct, {k: c["value"] for k, c in checks.items()}


@pytest.mark.parametrize("fault", sorted(set(FAULTS) - set(PASSES)))
def test_fault_is_not_correct(reg, fault, monkeypatch):
    correct, checks = _fault_readings(reg, fault, monkeypatch)
    assert correct is False, checks


@pytest.mark.parametrize("fault", sorted(PASSES))
def test_fault_the_limits_let_pass_reads_exactly(reg, fault, monkeypatch):
    """A fault the global limits cannot see at this cell's foreground: its
    exact reading, so that a change to what the check sees shows."""
    correct, checks = _fault_readings(reg, fault, monkeypatch)
    assert checks == pytest.approx(PASSES[fault], rel=1e-12)
    assert correct is True


def test_control_and_witness():
    """The TF32 control is not correct and the float64 witness is, on two
    seeds; the witness moves far fewer winners than the control."""
    from rbench import check
    from rbench.control import readings

    for seed in (101, 2**31 + 103):
        c = readings(CELL, seed, "cpu", config=SMALL, root=ROOT)
        w = readings(CELL, seed, "cpu", config=SMALL, root=ROOT,
                     witness=True)
        print(seed, "control", c, "witness", w)
        assert not check.judge(c)[0]
        assert check.judge(w)[0]
        assert max(r["tid_ppm"] for r in w) * 3 < min(r["tid_ppm"] for r in c)


def test_move_installs_the_debug_camera_once(reg):
    import tpu_renderer_torch as tr
    from rbench import scenes
    from rbench.traffic import Traffic

    spec = _spec(reg, 5)
    moves = Traffic(reg.traffic(reg.cell(CELL)), 5, spec)
    port = scenes.port_scene(tr, spec, "cpu")
    assert port.scene.debug_camera is None
    moves.apply(port, moves.at(-6))
    cam = port.scene.debug_camera
    want = spec.camera["debug"]
    np.testing.assert_array_equal(cam.position, np.float32(want["position"]))
    assert (cam.fovy, cam.near, cam.far) == (80, 1, 3)
    assert cam.scene is port.scene
    moves.apply(port, moves.at(3))
    assert port.scene.debug_camera is cam
    assert moves.view(moves.at(3))["debug"] == want


def test_reference_renders_a_directional_light_only(reg):
    from rbench.registry import plugin

    spec = _spec(reg, 5)
    main_debug = plugin("references", "main_debug").Reference
    general = plugin("references", "general").Reference
    with pytest.raises(ValueError, match="light_type"):
        general(spec, "cpu")
    spec.settings["light_type"] = "point"
    with pytest.raises(ValueError, match="light_type"):
        main_debug(spec, "cpu")

