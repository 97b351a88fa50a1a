"""The end-to-end metrics over a synthetic list of frames, the trace
readers on a small canned Chrome trace, and the roofline counts against a
hand count."""
import numpy as np
import pytest
import torch


def _run(**kw):
    from rbench.runner import RunRecord

    rec = RunRecord()
    for k, v in kw.items():
        setattr(rec, k, v)
    return rec


def test_frame_ms_and_p95_over_every_frame(reg):
    lat = [0.004] * 90 + [0.010] * 10          # seconds
    rec = _run(latencies=lat, window_s=0.5, attempted=100, failed=0)
    read, _ = reg.reader("frame_ms")
    assert read(rec, None) == pytest.approx(5.0)
    read, _ = reg.reader("frame_p95_ms")
    assert read(rec, None) == pytest.approx(float(np.percentile(
        np.asarray(lat), 95)) * 1e3)
    rec.failed = 50                             # failed frames complete nothing
    assert reg.reader("frame_ms")[0](rec, None) == pytest.approx(10.0)


def _x(name, cat, ts, dur, tid=1, corr=None):
    e = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
         "pid": 1 if cat not in ("kernel", "gpu_memcpy") else 0, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def _canned(drop=None):
    """Two frames of 1000 us: the graph launch 300 us in, four kernels,
    one copy back to the host."""
    ev = []
    for f, t0 in enumerate((0.0, 1000.0)):
        ev.append(_x("bench.frame", "user_annotation", t0, 1000.0))
        ev.append(_x("aten::copy_", "cpu_op", t0 + 100, 150))
        ev.append(_x("cudaGraphLaunch", "cuda_runtime", t0 + 300, 20,
                     corr=10 + f))
        ev.append(_x("cudaMemcpyAsync", "cuda_runtime", t0 + 700, 200,
                     corr=20 + f))
        at = t0 + 350
        for name, dur in (("void coarse_bins_kernel(float const*)", 10),
                          ("void visibility_kernel<false>(float const*)", 40),
                          ("void coarse_bins_kernel(float const*)", 10),
                          ("void stencil_kernel(float const*)", 40)):
            if not (drop == f and "stencil" in name):
                ev.append(_x(name, "kernel", at, dur, tid=7, corr=10 + f))
            at += dur
        ev.append(_x("Memcpy DtoH (Device -> Pinned)", "gpu_memcpy",
                     t0 + 750, 100, tid=7, corr=20 + f))
    return ev


def test_trace_readers_on_a_canned_trace(reg):
    from rbench import runner, tracing

    tr = tracing.Trace(_canned())
    rec = _run(trace=tr, trace_ok=True)
    assert reg.reader("host_prelaunch_ms")[0](rec, None) == pytest.approx(0.3)
    # Busy 100 us of kernels and 100 us of copy per 1000 us frame.
    assert reg.reader("device_ms")[0](rec, None) == pytest.approx(0.2)
    assert reg.reader("device_idle")[0](rec, None) == pytest.approx(80.0)
    ops = dict(tr.device_ops())
    assert ops["Memcpy DtoH"] == pytest.approx(200e-6)
    assert ops["visibility_kernel"] == pytest.approx(80e-6)
    # Gaps by the innermost host event at their middle: 0-350 and 850-1350
    # us in aten::copy_, 450-750, 1450-1750 and 1850-2000 in the frame.
    gaps = dict(tr.idle_gaps())
    assert gaps == pytest.approx({"aten::copy_": 850e-6,
                                  "bench.frame": 750e-6})
    rec.tally = {"visibility": 1, "stencil": 1}
    assert runner._check_trace(rec, print)
    lost = _run(trace=tracing.Trace(_canned(drop=1)),
                tally={"visibility": 1, "stencil": 1})
    assert not runner._check_trace(lost, print)
    assert reg.reader("device_ms")[0](_run(trace=tr, trace_ok=False),
                                      None) is None


def test_stage_ms_reads_the_innermost_stage_range(reg):
    from rbench import tracing

    ev = [_x("tr.vertex", "user_annotation", 0, 100),
          _x("aten::mul", "cpu_op", 10, 20),
          _x("cudaLaunchKernel", "cuda_runtime", 12, 5, corr=1),
          _x("tr.shade", "user_annotation", 200, 100),
          _x("cudaLaunchKernel", "cuda_runtime", 210, 5, corr=2),
          _x("k1", "kernel", 50, 30, tid=7, corr=1),
          _x("k2", "kernel", 250, 60, tid=7, corr=2)]
    rec = _run(eager=tracing.Trace(ev), eager_frames=2, trace_ok=True)
    read, part = reg.reader("stage_ms.vertex")
    assert read(rec, part) == pytest.approx(0.015)
    read, part = reg.reader("stage_ms.shade")
    assert read(rec, part) == pytest.approx(0.030)
    read, part = reg.reader("stage_ms.shadow_quads")
    assert read(rec, part) is None


def test_roofline_least_time_by_hand():
    from rbench import roofline

    c = {"faces": 1000, "fragments": 2_000_000, "pixels": 1 << 20,
         "quads": 100, "quad_tests": 10**9}
    t, by = roofline.least_time("visibility", c)
    assert by == "bytes"
    assert t == pytest.approx((48 * 1000 + 8 * (1 << 20)) / 3.35e12)
    t, by = roofline.least_time("stencil", c)
    assert by == "operations"
    assert t == pytest.approx(9e9 / 67e12)


def _square_spec(size=16):
    """A floor quad seen from straight above, filling the middle of a
    size x size frame, and nothing else."""
    from rbench.scenes import MeshSpec, SceneSpec, floor

    v, uv, n, f = floor(1.0, 0.0)
    model = MeshSpec(vertices=v, uv=uv, normals=n, faces=f, shadowing=False)
    return SceneSpec(resolution=(size, size), shadows=False,
                     backface_culling=False,
                     camera={"position": [0.0, 2.0, 0.0],
                             "center": [0.0, 0.0, 0.001], "fovy": 90,
                             "near": 0.1, "far": 10},
                     light={"position": [0.0, 3.0, 0.0],
                            "center": [0.0, 0.0, 0.0],
                            "ambient_strength": 0.1, "specular_strength": 0.1,
                            "linear": 0.0, "quadratic": 0.0},
                     models=[model])


def test_reference_counts_by_hand():
    """Every covered (face, pixel) fragment, counted by a brute-force walk
    of every pixel and face with the same barycentric test."""
    from rbench.reference import Reference

    spec = _square_spec()
    ref = Reference(spec, "cpu")
    out = ref.render(np.float32([0.0, 2.0, 0.0]), np.float32([0, 3, 0]))
    cam = ref.camera_matrices(np.float32([0.0, 2.0, 0.0]))
    faces = ref._faces(ref._models[0], cam)
    hand = 0
    for fi in range(2):
        a = faces["aff"][fi].numpy()            # float32, as rendered
        x0, x1, y0, y1 = faces["bbox"][fi].tolist()
        for y in map(np.float32, range(16)):
            for x in map(np.float32, range(16)):
                v = a[0] * x + a[1] * y + a[2]
                w = a[3] * x + a[4] * y + a[5]
                u = np.float32(1) - v - w
                hand += (min(u, v, w) >= 0 and x0 <= x < x1
                         and y0 <= y < y1)
    assert out.counts["faces"] == 2
    assert out.counts["fragments"] == hand > 0
    assert out.counts["pixels"] == 256
    assert int((out.tid >= 0).sum()) <= hand
    assert out.counts["quads"] == 0 and out.counts["quad_tests"] == 0
    assert torch.equal(out.stencil, torch.zeros_like(out.stencil))
