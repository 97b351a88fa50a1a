"""Drive the PyTorch/CUDA port's main path once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line; any failure raises, so the script exits
non-zero without the final line):

1. environment: the card (nvidia-smi name and power limit), torch, CUDA and
   nvcc versions;
2. build: compile ``tpu_renderer_torch/csrc/*.cu`` with nvcc for sm_90a;
3. per kernel: K1-K4 against their plain PyTorch versions on the card, at
   the flagship frame's shapes, each timed with CUDA events (median of a
   few runs after a warm-up);
4. end to end: the flagship frame — a seeded procedural shadow-casting mesh
   of 4,992 faces with 1024² diffuse and tangent-space normal maps over a
   textured floor, point light, shadow volumes, 1024×1024, LH/OpenGL —
   through ``Scene.render()``; every kernel's launch count must rise, and
   tid, stencil and frame must match the same render through the plain
   versions; then a short camera orbit is timed, and a few frames are
   profiled (device busy share, each stage's host time and device span).

Before the last line it prints the card's ``name, power.limit`` line and
one JSON object with the per-kernel records; the last line is
``{"ok": true, "device": {...}}``. Nothing here imports JAX: the card's
host runs the port alone.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time

import numpy as np

RES = (1024, 1024)
SEED = 0
TEX = 1024


def _smooth_noise(rng, shape, octaves=4):
    """Seeded smooth 2D noise in [0, 1]: a sum of random low-frequency
    sinusoids (no image files, no network)."""
    h, w = shape
    y, x = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                       np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    out = np.zeros(shape, np.float32)
    for o in range(octaves):
        f = 2.0 ** (o + 1)
        for _ in range(3):
            fx, fy = rng.integers(1, 4, 2) * f
            ph = rng.uniform(0, 2 * np.pi)
            out += np.sin(2 * np.pi * (fx * x + fy * y) + ph) / (o + 1)
    out -= out.min()
    return out / out.max()


def _vertex_normals(verts, faces):
    """Area-weighted vertex normals of a triangle mesh."""
    v = verts[:, :3].astype(np.float64)
    fv = faces[:, :, 0]
    n = np.cross(v[fv[:, 1]] - v[fv[:, 0]], v[fv[:, 2]] - v[fv[:, 0]])
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, fv[:, k], n)
    acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
    return acc.astype(np.float32)


def build_flagship(tr, device, resolution=RES, tex=TEX, seed=SEED):
    """The bench.py:25-49 frame with procedural stand-ins for its assets."""
    from tpu_renderer_torch.models.gizmos import make_floor, make_sphere
    from tpu_renderer_torch.models.model import Model

    rng = np.random.default_rng(seed)
    base = make_sphere(40, 64)                       # 4,992 faces
    n = base.vertices[:, :3]
    th = np.arccos(np.clip(n[:, 1], -1, 1))
    ph = np.arctan2(n[:, 2], n[:, 0])
    bump = np.zeros(len(n), np.float32)
    for _ in range(6):
        a, b = rng.integers(1, 5, 2)
        bump += rng.uniform(0.02, 0.06) * np.sin(a * th + rng.uniform(0, 6)) \
            * np.cos(b * ph + rng.uniform(0, 6))
    verts = base.vertices.copy()
    verts[:, :3] = n * (1.0 + bump)[:, None]
    faces = base.face_array
    mesh = Model(verts, base.uv, _vertex_normals(verts, faces), faces,
                 shadowing=True)
    mat = mesh.materials["default"]
    mat.map_Kd = np.stack([_smooth_noise(rng, (tex, tex)) for _ in range(3)],
                          axis=-1)
    height = _smooth_noise(rng, (tex, tex)) * 8.0
    gy, gx = np.gradient(height)
    nm = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    # Quantize like an 8-bit image, then the *2-1 normalization of
    # TextureMaps.register('normals', normalize=True, tangent=True).
    nm8 = np.round((nm * 0.5 + 0.5) * 255) / 255.0
    mat.norm = np.asarray(nm8 * 2 - 1, dtype=np.dtype(
        np.float32, metadata={"tangent": True}))
    mesh.normal_map_is_tangent = True

    floor = make_floor(2.0, y=-1.0)
    checker = ((np.indices((tex, tex)) // 64).sum(0) % 2).astype(np.float32)
    floor.materials["default"].map_Kd = np.stack(
        [0.35 + 0.4 * checker, 0.35 + 0.3 * _smooth_noise(rng, (tex, tex)),
         0.3 + 0.2 * checker], axis=-1).astype(np.float32)

    light = tr.Light((5, 5, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                     center=(0, 0.5, 0.5), ambient_strength=0.1,
                     specular_strength=0.1, linear=1e-9, quadratic=1e-10)
    camera = tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=90, near=0.0001,
                       far=400, backface_culling=False)
    scene = tr.Scene(camera, light, shadows=True, resolution=resolution,
                     system=tr.SYSTEM.LH, subsystem=tr.SUBSYSTEM.OPENGL,
                     device=device)
    scene.add_model(mesh)
    scene.add_model(floor)
    return scene


def orbit_position(t, radius=5.05, height=3.0):
    """bench.orbit_position's camera path."""
    return np.array([radius * np.sin(t) + 0.5, height, radius * np.cos(t)],
                    dtype=np.float32)


def kernel_inputs(scene):
    """The four kernels' inputs at the scene's main-path shapes (the stage
    calls of pipeline.render_core, through the plain versions)."""
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops.shadow import prepare_quads

    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], scene.device)
    faces, attrs = pl._build_face_batch(cfg, dyn, cam_m)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    zb_sign, tid = rc.visibility_plain(fdata, flags, h, w, cfg.system)
    adata = rc.pack_face_attrs(attrs)
    gb = rc.gbuffer_plain(fdata, adata, tid)
    tables = pl.texture_tables(cfg, dyn, attrs)
    qdata, qi = rc.pack_quads(*prepare_quads(cfg, dyn, cam_m), h, w)
    zc = rc.stencil_scalars(dyn["camera"]["near"], dyn["camera"]["far"])
    return {
        "visibility": (fdata, flags, h, w, cfg.system),
        "gbuffer": (fdata, adata, tid),
        "sample_textures": (tid, gb[rc.GB_IU].contiguous(),
                            gb[rc.GB_IV].contiguous(), *tables),
        "stencil": (qdata, qi, zb_sign, cfg.system, *zc),
    }


def _time_ms(fn, runs=5):
    import torch

    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def _compare(name, got, ref):
    """(max_abs_err, verdict) against the kernel's stated tolerance; raises
    on disagreement."""
    import torch

    if name == "visibility":
        (zk, tk), (zp, tp) = got, ref
        same = tk == tp
        frac = same.float().mean().item()
        fin = same & torch.isfinite(zp)
        err = (zk[fin] - zp[fin]).abs().max().item() if fin.any() else 0.0
        zeq = torch.equal(zk[same], zp[same])
        if frac < 0.999 or not zeq:
            raise AssertionError(f"K1: tid match {frac}, zb equal {zeq}")
        return err, f"tid match {frac:.6f} (>= 0.999), zb_sign equal there"
    if name == "gbuffer":
        err = (got - ref).abs().nan_to_num(0.0).max().item()
        if not torch.allclose(got, ref, rtol=1e-5, atol=1e-5, equal_nan=True):
            raise AssertionError(f"K2: max abs err {err}")
        return err, "allclose rtol 1e-5 atol 1e-5"
    if name == "sample_textures":
        (sk, mk), (sp, mp) = got, ref
        if not (torch.equal(sk, sp) and torch.equal(mk, mp)):
            raise AssertionError("K3: samples differ")
        return 0.0, "exact"
    if not torch.equal(got, ref):
        raise AssertionError("K4: stencils differ")
    return 0.0, "exact"


def _profile(scene, n_frames=5):
    """Where a frame's time goes: torch.profiler over a few Scene.render()
    calls, all per frame in ms. ``busy`` sums the device's kernel and copy
    events, so ``busy / wall`` is the device's busy share; ``host`` is each
    pipeline stage's host time and ``device_span`` its span on the device
    (the tr.* ranges of ops/pipeline.py); ``top`` the largest device
    events by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    scene.render()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            scene.render()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    host, span, device = {}, {}, {}
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / n_frames
        if e.name.startswith("tr."):
            into = host if e.device_type == DeviceType.CPU else span
            into[e.name[3:]] = into.get(e.name[3:], 0.0) + ms
        elif e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + ms
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    # The kernels alone, without the torch binning their wrappers run
    # (phase 3 times the wrappers).
    kernels = {n: sum(v for k, v in device.items() if f"::{n}_kernel(" in k)
               for n in ("visibility", "gbuffer", "sample", "stencil")}
    r = lambda d: {k[:60]: round(v, 4) for k, v in d}
    return {"wall": wall_ms, "busy": busy, "busy_share": busy / wall_ms,
            "host": r(host.items()), "device_span": r(span.items()),
            "kernels": r(kernels.items()), "top": r(top)}


SOURCES = {
    "visibility": ("tpu_renderer_torch/csrc/visibility.cu",
                   "tpu_renderer/ops/raster_pallas.py:1405"),
    "gbuffer": ("tpu_renderer_torch/csrc/gbuffer.cu",
                "tpu_renderer/ops/raster_pallas.py:1322"),
    "sample_textures": ("tpu_renderer_torch/csrc/sample_textures.cu",
                        "tpu_renderer/ops/raster_pallas.py:1886"),
    "stencil": ("tpu_renderer_torch/csrc/stencil.cu",
                "tpu_renderer/ops/raster_pallas.py:964"),
}


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on a CUDA card only")
    import tpu_renderer_torch as tr
    from tpu_renderer_torch.ops import _build
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    # 1. environment
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    nvcc = subprocess.run([_build.nvcc_path(), "--version"],
                          capture_output=True, text=True, check=True).stdout
    nvcc_line = [ln for ln in nvcc.splitlines() if "release" in ln][0]
    print(f"[1 env] card: {smi} | torch {torch.__version__} | cuda "
          f"{torch.version.cuda} | nvcc: {nvcc_line.strip()}", flush=True)

    # 2. build
    t0 = time.perf_counter()
    _build.load()
    regs = [ln.strip() for ln in _build.last_build["log"].splitlines()
            if "registers" in ln]
    print(f"[2 build] {time.perf_counter() - t0:.2f} s for "
          f"{_build.last_build['path']}; ptxas: {' | '.join(regs)}",
          flush=True)

    # 3. per kernel, at the flagship frame's shapes
    scene = build_flagship(tr, "cuda")
    inputs = kernel_inputs(scene)
    records = {}
    for name, args in inputs.items():
        kern = getattr(rc, name)
        plain = getattr(rc, f"{name}_plain")
        got = kern(*args)
        torch.cuda.synchronize()
        ref = plain(*args)
        err, verdict = _compare(name, got, ref)
        ms = _time_ms(lambda: kern(*args))
        plain_ms = _time_ms(lambda: plain(*args), runs=3)
        records[name] = {"name": name, "route": "cuda",
                         "source": SOURCES[name][0],
                         "replaces": SOURCES[name][1], "max_abs_err": err,
                         "ms": ms, "plain_ms": plain_ms}
        print(f"[3 kernel] {name}: {verdict}; max_abs_err {err:.3g}; "
              f"kernel {ms:.4f} ms (its wrapper, binning included), plain "
              f"{plain_ms:.2f} ms", flush=True)

    # 4. end to end through Scene.render()
    rc.reset_launches()
    frame = scene.render()
    torch.cuda.synchronize()
    launches = dict(rc.LAUNCHES)
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    tid, stencil = scene.last_tid, scene.last_stencil
    cfg, dyn = scene._prepare()
    f_p, _, tid_p, st_p = pl.render_frame(cfg, dyn, ops=rc.PLAIN)
    f_p = f_p.cpu().numpy()
    tid_match = (tid == tid_p).float().mean().item()
    frame_match = float((frame == f_p).all(-1).mean())
    if frame.shape != (*RES, 3) or tid_match < 0.999 or frame_match < 0.999 \
            or not torch.equal(stencil, st_p):
        raise AssertionError(f"frame vs plain path: tid {tid_match}, frame "
                             f"{frame_match}, stencil equal "
                             f"{torch.equal(stencil, st_p)}")
    fg = (tid >= 0).float().mean().item()
    shadowed = int((stencil != 0).sum().item())
    if fg == 0.0 or shadowed == 0:
        raise AssertionError(f"degenerate frame: foreground {fg}, "
                             f"shadowed pixels {shadowed}")
    n_frames = 20
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_frames):
        scene.camera.set_position(orbit_position(2 * np.pi * i / n_frames))
        scene.render()
    dt = (time.perf_counter() - t0) / n_frames
    print(f"[4 e2e] {RES[0]}x{RES[1]}, {sum(m.num_faces for m in scene.models)}"
          f" faces: launches {launches}; vs plain path tid {tid_match:.6f}, "
          f"frame {frame_match:.6f}, stencil equal; foreground {fg:.3f}, "
          f"shadowed px {shadowed}; orbit {dt * 1e3:.2f} ms/frame = "
          f"{1.0 / dt:.2f} fps (Scene.render, host clock, {n_frames} frames)",
          flush=True)

    print(f"[4 profile] {json.dumps(_profile(scene))}", flush=True)

    for name, rec in records.items():
        rec["launches"] = launches[name]
    print(smi)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
