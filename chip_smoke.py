"""Drive the PyTorch/CUDA port's render paths once on one CUDA card.

    python3 chip_smoke.py

Phases (each prints one line or a few; any failure raises, so the script
exits non-zero without the final line):

1. environment: the card (nvidia-smi name and power limit), torch, CUDA and
   nvcc versions;
2. build: compile ``tpu_renderer_torch/csrc/*.cu`` with nvcc for sm_90a;
   K8's ptxas report (registers, stack, spills: the kernel fails the
   phase if it uses any local memory) and its persistent grid; K3's, for
   both its instances (16-byte and 4-byte accesses), and K9's, for its 24
   (access width, light type, shadows, background kind), and K10's, for
   its 16 (layout, culling, debug camera), under the same rule;
3. per kernel: K1-K10 (K5 in its flat, gouraud and pbr layouts; K8 on the
   flagship's silhouette rows, its tables compared over all their rows,
   NaN where NaN, and, as K3 and K9, also timed as a captured graph of
   calls; K4 on K8's tables with their count; K9 on the frame's G-buffer,
   samples and stencil; K10 on the flagship's face tables, and with the
   debug camera) against
   their plain PyTorch versions on the card, at the flagship frame's
   shapes, each timed with CUDA events (median of a few runs after a
   warm-up) and alone in a profile, beside its bound: the larger of the
   bytes its function must move in this run (``needed_bytes``; K8's
   tables whole, and also without the zero rows past its count) over
   3.35 TB/s and a lower count of its float operations over 67 TFLOP/s;
   the wrappers of K1, K4, K6, K7 and K8 must run under torch's sync debug
   mode "error" (no wait for the device), and K1's, K4's and K7's coarse
   lists (csrc/bins.cu) must equal their plain version, their lines
   showing the lists' scratch bytes; then the sharded modes on the inputs
   of rank 1 of phase 6's 1x2 (rows, tris) mesh, the whole frame height
   and the second half of each model's faces (``shard_inputs``): K1 z
   only, K7, and the owned ranges of K2, K5 (gouraud, pbr) and K3, each
   equal to its plain version; then K1 (both modes) and K7 with a debug
   camera whose frustum cuts the mesh (``flagship_debug_camera``): K1 on
   the flagship's face table and its debug planes, K1 z only and K7 on the
   same rank's shard inputs, each equal to its plain version, checked and
   timed as above, with the faces that take the per-pixel clip test with
   and without the debug camera; then K3 on its adversarial inputs
   (``k3_adversarial_inputs``), through each of its instances, equal to
   its plain version; then K9 on its adversarial inputs
   (``k9_adversarial_inputs``: each light type, shadows on and off, a
   colour and a skybox plane, H*W not a multiple of 4, model ids that
   name no row, a frame without maps), equal to its plain version; then
   K10 on its adversarial tables (``k10_adversarial_inputs``) in each of
   its 16 instances, equal to its plain version; then K11 and K12 at the
   ``reference-main`` frame's shapes (``overlay_inputs``: 1500², main.py's
   camera2 as the debug camera, the segment table of
   ``ops/overlay.frustum_segments``, render_core's frame and z-buffer cast
   to float64), each equal to its plain version in every bit of every
   output (K11 the frame, the z-buffer and the pixel counter, K12 the
   uint8 frame: max_abs_err 0), without a host sync, timed as above
   beside K12's byte bound (K11 is bound by latency);
4. end to end, general shader: the flagship frame — a seeded procedural
   shadow-casting mesh of 4,992 faces with 1024² diffuse and tangent-space
   normal maps over a textured floor, point light, shadow volumes,
   1024×1024, LH/OpenGL — through ``Scene.render()``, whose first frame
   captures the compiled program (ops/compiled.py) and whose second
   replays it; K1-K4's and K8-K10's launch counts must rise in the replay,
   and tid, stencil and frame must match the same render through the plain
   versions; then a camera orbit of ``Scene.render()`` frames is timed,
   and a few frames through the eager entry points (``render_eager``) are
   profiled (device busy share, each stage's host time and device span);
   every later profile runs eager frames too, so the ``tr.<stage>`` ranges
   keep their meaning, while every ``Scene.render()`` time is compiled;
5. the other shaders: the same frame through ``Scene.render()`` under
   flat, gouraud, pbr, wireframe and points, and under the general shader
   over a seeded procedural cubemap skybox (6 × 512² faces); each render
   must launch the kernels of its path and match its plain-path render;
   each is timed against the general shader (without the skybox) as
   interleaved orbits, general then variant, PAIRS times, and profiled
   (wireframe also prints K6's ``tr.lines`` host range);
6. sharded: ``render_frame_sharded`` on 1x2 (general, gouraud, pbr) and
   2x2 (general) meshes of ranks, one python3 subprocess each, started
   after the build and killed and waited for before the phase ends, gloo through a FileStore, every rank on ``cuda:0`` (one
   card cannot host two NCCL ranks), and 1x2 gouraud with the debug camera
   (K1 z only and K7 in their debug modes); each rank builds the flagship
   from the seed. Each frame must match the one-device ``Scene.render()`` frame
   (frame >= 99.9%, stencil equal, zbuf within rtol 1e-6, tid >= 99.9%
   after mapping global ids to one-device faces) and, on every rank, equal
   its own render through the plain versions in all four buffers (every
   kernel equals its plain version, and the merges are the same
   collectives); every rank's launch counts must show the kernels of the
   sharded path. Rank 0 prints ms/frame (host clock,
   after a barrier), the traced share of the merges (``tr.merge_*``) and
   K7's host range (``tr.tidpass``).
   The ranks share one card and gloo stages each collective through host
   memory: these are not multi-card numbers.
7. the debug-camera frame: the flagship with the debug camera and both
   gizmos (``Light(show=True)``, a shown debug camera) through
   ``Scene.render()``, which draws the debug camera's frustum over it;
   K1's debug mode, K2, K3 and K4 must launch, K11 and K12 once each after
   the replay (``OVERLAY_KERNELS``); tid, stencil and frame must
   match the same render through the plain versions; the uint8 frame,
   ``last_zbuf`` and the overlay's line pixels must equal, bit for bit,
   the numpy overlay drawn on the same float frame and z-buffer
   (``_check_overlay``); the overlay must draw red pixels, and the debug camera must change tid on more than 1% of the
   mesh's pixels. It is timed against the flagship without them in
   interleaved orbit pairs and profiled (``tr.overlay``'s host range); then
   a wireframe render with the debug camera must match its plain path.
8. supersampling, ``stats()`` and the host API: ``Scene.stats()`` on the
   phase-4 frame (each model's total its face count, the counters summing
   to at least total - 1, ``rendered`` the distinct ids of the model in
   tid, every counter equal to ``face_statistics`` on CPU copies of the
   same scene and tid); the flagship with ``supersample = 2`` (2048²
   inside) through ``Scene.render()``, which must launch K1-K4 and match
   its plain-path render at the bars above and show more distinct colours
   than the frame at ss = 1, timed against ss = 1 in SSAA_PAIRS interleaved
   SSAA_ORBIT-frame orbit pairs and profiled (``tr.ssaa`` and the kernels
   alone); gouraud at ss = 2 through K5; ss = 4 (4096²) once, against its
   plain path, with the coarse-list scratch and the device's peak memory;
   K1-K5 and K8-K10 timed at 2048² and 4096² beside their bounds
   (``needed_bytes``), K3 and K8-K10 equal to their plain versions there,
   each as its wrapper (CUDA events) and as the device time per call of a
   captured graph of 20 wrapper calls (``_graph_ms``: no profile, whose
   events went missing there); then the flagship mesh written with
   ``utils.objwrite.write_obj`` and loaded with the native loader (built
   with g++) and the Python parser, which must agree, and
   ``utils.profiling.trace`` around two eager frames, whose
   ``summarize_device_trace`` must name K1-K4 (and around two compiled
   frames, whose kernels it lists without a bar);
9. the compiled frame, for each of ``COMPILED_PATHS`` (general, flat,
   gouraud, pbr, wireframe, points, general over the cubemap, ss = 2 and
   the debug camera's ``render_core_jit``): a COMPILED_ORBIT-frame orbit
   of the camera and the light, then one frame after new vertex positions
   and a new diffuse map of the same shape, each through the compiled
   entry point and the eager one, which must be equal in frame, zbuf, tid
   and stencil; one capture for the key, its ms and its graph pool's
   bytes; no host sync in a replay (``_assert_no_sync``); a replay's
   launches, which must be the capture's tally and cover the path's
   kernels, K8 once. The frame's times are the benchmark's
   (benchmark/run.py), not this script's;
10. bench.py's configurations (``bench_torch.build_config``, procedural
   stand-ins): cfg1 (gouraud, K5), cfg2-persp and cfg2-ortho (culling),
   cfg3 (spot light, tangent normal map), cfg3-rh-shadows (SYSTEM.RH,
   SUBSYSTEM.DIRECTX, shadows: the kernels at sign +1, the spot light's
   w = 2 extrusion), cfg4 (cubemap, chained transforms), cfg5-merged and
   cfg5-instances (the crowd: 99,842 faces, 1024², shadows, culling, one
   merged model or 20 instances that share their packing) and cfg6 (ten
   distinct textured models, shadows), each through ``Scene.render()``:
   one capture, then a CONFIG_ORBIT-frame orbit of its camera
   (CROWD_ORBIT for the crowd), timed; at its own camera a replay that
   launches the path's kernels (``CONFIG_KERNELS``) and does not sync,
   equals the eager frame in all four outputs and matches the plain path
   at the bars of phases 4-9, and launches K8 once if the path has
   shadows and never otherwise; the replay alone (CUDA events), the
   shadowing models' edges E, the silhouette rows n_sil that K8 prepares
   and K4 bins, the active shadow quads, texel-pool bytes, distinct
   texture stacks and an eager profile, with the ``shadow_quads`` and
   ``stencil`` stages' busy ms; K1-K4 and K8-K10 at the crowd's shapes
   timed with ``_graph_ms`` beside their bounds (K3 and K8-K10 equal to
   their plain versions there, K8 also timed with a count of 0: its zero
   rows alone),
   with K1's and K4's coarse lists against their plain version; the two
   crowd paths must give equal frames and stencils, the same texel pool,
   and one stack tensor per map in the instances' packets.

Before the last line it prints the card's ``name, power.limit`` line and
one JSON object with the per-kernel records (each with its launches in
the render of its path: K1-K4 and K8-K10 from phase 4, each K5 layout from its
shader's render, K6 from the wireframe render, the sharded modes from
the 1x2 renders' rank whose inputs phase 3 took, the debug modes, K11
and K12 from phase 7 and the debug 1x2 render); the last line is
``{"ok": true, "device": {...}}``. Nothing here imports JAX: the card's
host runs the port alone.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

from bench_torch import (RES, SEED, build_config,  # noqa: E402
                         build_scene as build_flagship, flagship_light,
                         orbit_position, procedural_cubemap)

#: Published H100 SXM peaks (NVIDIA H100 datasheet): HBM bytes/s and
#: float32 operations/s outside the tensor cores.
PEAK_BYTES = 3.35e12
PEAK_F32 = 67e12


def flagship_debug_camera(tr, show=False):
    """A debug camera over the flagship mesh looking down, as the golden
    tests' (tests/test_golden.py:117-119) at this scale: near and far cut
    the mesh's top cap off (y > 0.5) and keep the floor, so the second
    clip space takes pixels from the mesh while both triangle shards of
    phase 6 keep some. ``show=True`` adds its camera gizmo to a scene."""
    return tr.Camera((0, 3, 0.01), center=(0, 0, 0), fovy=80, near=2.5,
                     far=4.5, show=show)


def _stencil_constants(dyn, device):
    """K4's depth constants for the scene's camera, a (3,) float32 tensor
    on ``device`` (the frame stages them: pipeline.frame_inputs)."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    return torch.tensor(rc.stencil_scalars(dyn["camera"]["near"],
                                           dyn["camera"]["far"]),
                        device=device)


def vertex_stage(cfg, dyn, cam_m, dbg_mvp=None):
    """The face batch of ``pipeline.render_core``'s vertex stage over
    ``dyn``, which carries its face tables (``pipeline.with_face_tables``):
    the composition that K10's plain version packs (raster_cuda.face_batch),
    as (faces, attrs, the keywords ``verts`` and ``world`` of the shadow
    pass, ``shadow.quad_tables``)."""
    from tpu_renderer_torch.ops import pipeline as pl

    verts = pl.stacked_vertices(dyn)
    faces, attrs = pl._build_face_batch(cfg, dyn, cam_m, dbg_mvp,
                                        verts=verts)
    return faces, attrs, {"verts": verts, "world": attrs["world"]}


def kernel_inputs(scene):
    """Every kernel's inputs at the scene's shapes, keyed by case (K5 once
    per layout), as (args, kwargs): the stage calls of pipeline.render_core
    and render_debug_frame, through the plain versions, then the sharded
    modes (``shard_inputs``). Returns (inputs, zb_sign)."""
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], scene.device)
    faces, attrs, _ = vertex_stage(cfg, dyn, cam_m)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    zb_sign, tid = rc.visibility_plain(fdata, flags, h, w, cfg.system)
    adata = rc.pack_face_attrs(attrs)
    gb = rc.gbuffer_plain(fdata, adata, tid)
    tables = pl.texture_tables(cfg, dyn, attrs)
    prep_args = quad_prep_args(cfg, dyn, cam_m)
    qdata, qi = rc.quad_prep_plain(*prep_args)
    zc = _stencil_constants(dyn, scene.device)
    inputs = {
        "visibility": (fdata, flags, h, w, cfg.system),
        "gbuffer": (fdata, adata, tid),
        "sample_textures": (tid, gb[rc.GB_IU].contiguous(),
                            gb[rc.GB_IV].contiguous(), *tables),
        "stencil": (qdata, qi, zb_sign, cfg.system, zc),
    }
    for layout in rc.SLIM_CHANNELS:
        inputs[f"gbuffer_slim_{layout}"] = (
            fdata, rc.pack_slim_attrs(attrs, layout), tid, layout)
    # The wireframe frame's K6 call: its z-buffer is K1's (the shader does
    # not change visibility), its edges every face's (no culling).
    sx, sy, sz, _, valid = pl._debug_vertices(cfg, dyn, cam_m)
    inputs["lines"] = pl._wireframe_lines(sx, sy, sz, valid,
                                          zb_sign * cfg.system, h, w)
    inputs["quad_prep"] = prep_args
    inputs["vertex"] = vertex_args(cfg, dyn, cam_m)
    inputs = {case: (args, {}) for case, args in inputs.items()}
    inputs["stencil"] = (inputs["stencil"][0], {"n_rows": prep_args[2]})
    inputs["shade"] = shade_inputs(cfg, dyn)
    inputs.update(shard_inputs(cfg, dyn, zb_sign))
    inputs.update(debug_inputs(cfg, dyn))
    return inputs, zb_sign


def vertex_args(cfg, dyn, cam_m, dbg_mvp=None):
    """K10's arguments for the frame, as render_core calls it: the stacked
    vertices, the face tables, the camera, the frame size, the culling
    flag, the shader's layout and the debug camera's MVP."""
    from tpu_renderer_torch.ops import pipeline as pl

    slim = cfg.shader in pl.SLIM_SHADERS
    return (pl.stacked_vertices(dyn), dyn["faces"], cam_m, *cfg.resolution,
            cfg.backface_culling, cfg.shader if slim else "general", dbg_mvp)


def quad_prep_args(cfg, dyn, cam_m):
    """K8's arguments for the frame (``shadow.prepare_quads`` on the vertex
    stage's vertices and face positions, and the camera's planes and
    matrices): (quad, order, n_sil, planes, MVP, viewport, H, W)."""
    from tpu_renderer_torch.ops.shadow import prepare_quads

    stage = vertex_stage(cfg, dyn, cam_m)[2]
    return (*prepare_quads(cfg, dyn, **stage), cam_m["frustum_planes"],
            cam_m["MVP"], cam_m["viewport"], *cfg.resolution)


def debug_inputs(cfg, dyn):
    """K1's, K7's and K10's debug-mode inputs: the scene with
    ``flagship_debug_camera``, its face table and debug planes for K1
    (``visibility_dbg``), the SHARD_RANK rank's shard inputs for K1 z
    only and K7 (``visibility_z_dbg``, ``tidpass_dbg``), all with fdbg,
    and K10's arguments with the debug camera's MVP (``vertex_dbg``)."""
    import tpu_renderer_torch as tr
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    cam = flagship_debug_camera(tr)
    cfg = dataclasses.replace(cfg, has_debug_camera=True,
                              dbg_projection_type=cam.projection_type)
    dyn = dict(dyn, debug_camera=tr.Scene._cam_dyn(cam))
    device = dyn["light"]["position"].device
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], device)
    dbg_mvp = pl._debug_mvp(cfg, dyn, device)
    faces, _, _ = vertex_stage(cfg, dyn, cam_m, dbg_mvp)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    fdbg = rc.pack_debug_planes(faces)
    zb_sign, _ = rc.visibility_plain(fdata, flags, h, w, cfg.system,
                                     want_tid=False, fdbg=fdbg)
    shard = shard_inputs(cfg, dyn, zb_sign)
    return {"visibility_dbg": ((fdata, flags, h, w, cfg.system),
                               {"fdbg": fdbg}),
            "vertex_dbg": (vertex_args(cfg, dyn, cam_m, dbg_mvp), {}),
            "visibility_z_dbg": shard["visibility_z"],
            "tidpass_dbg": shard["tidpass"]}


#: The frame of the ``reference-main`` configuration (the reference's
#: obj/main.py, benchmark/configs/reference-main.json): 1500².
MAIN_RES = (1500, 1500)


def main_frame_scene(tr, device="cuda", resolution=MAIN_RES):
    """reference-main's frame with the flagship's stand-ins: the mesh and
    floor at ``resolution``, bench.py's camera at (0.5, 3, 5), a
    directional light from (5, 5, 0) towards (0, 0.5, 0.5), shadows, and
    main.py's camera2 (main.py:84-92: from (0, 3, 0.01) down to the
    origin, fovy 80, near 1, far 3) as the debug camera."""
    scene = build_flagship(device, resolution=resolution)
    scene.light = tr.Light((5, 5, 0),
                           light_type=tr.Lightning.DIRECTIONAL_LIGHTNING,
                           center=(0, 0.5, 0.5), ambient_strength=0.1,
                           specular_strength=0.1, linear=1e-9,
                           quadratic=1e-10)
    scene.debug_camera = tr.Camera((0, 3, 0.01), center=(0, 0, 0), fovy=80,
                                   near=1, far=3, backface_culling=True)
    return scene


def overlay_inputs(tr, device="cuda", resolution=MAIN_RES):
    """K11's and K12's inputs at reference-main's shapes
    (``main_frame_scene``), as Scene._render_overlay makes them: the
    frame and the z-buffer of ``pipeline.render_core`` through the kernels,
    cast to float64 on their device, the segment table of
    ``ops/overlay.frustum_segments`` for both cameras (on the host), the
    scene's depth sign and a zeroed pixel counter for K11; for K12 that
    frame with the frustum drawn on it (through K11's plain version).
    Returns {case: args}."""
    import torch
    from tpu_renderer_torch.ops import overlay as ov
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    scene = main_frame_scene(tr, device, resolution)
    cfg, dyn = scene._prepare()
    frame, zbuf = pl.render_core(cfg, dyn)[:2]
    frame, zbuf = frame.to(torch.float64), zbuf.to(torch.float64)
    table = torch.from_numpy(ov.frustum_segments(
        scene.camera._matrices(torch.float64),
        scene.debug_camera._matrices(torch.float64), scene.camera.position,
        scene.camera.near, scene.camera.far, scene.resolution))
    counter = torch.zeros(1, dtype=torch.int64, device=frame.device)
    drawn = rc.overlay_plain(table, frame.clone(), zbuf.clone(), cfg.system,
                             counter.clone())[0]
    return {"overlay": (table, frame, zbuf, cfg.system, counter),
            "overlay_quantize": (drawn,)}


#: The rank of a phase-6 mesh on whose inputs phase 3 holds the sharded
#: modes to their plain versions, as ((n_rows, n_tris), (row_idx,
#: tris_idx)): the second triangle shard of the 1x2 mesh, the whole frame
#: height. Its launches in phase 6 go into their records.
SHARD_RANK = ((1, 2), (0, 1))


def shard_inputs(cfg, dyn, zb_sign, mesh=SHARD_RANK[0], at=SHARD_RANK[1]):
    """The sharded modes' inputs on rank ``at`` = (row_idx, tris_idx) of a
    ``mesh`` = (n_rows, n_tris) mesh, built in one process with the plain
    versions: its block of rows of the one-device z-buffer (the MIN of the
    shards' z-buffers is that buffer), the MAX over shards of their K7
    claims as the merged tid, and the SUM over shards of their owned
    G-buffers for K3's iu/iv. Keyed by case, as (args, kwargs). With a
    debug camera in the scene, K1's and K7's calls take the shard's debug
    planes (``fdbg``), as render_core's do. Raises unless the rank's shard
    wins some pixels of its rows and another shard wins others (on the
    flagship frame the second half of the faces wins nothing in rows
    512-1023)."""
    import torch
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.parallel.sharded import (pad_models_for_tris,
                                                     shard_config, shard_dyn)

    (n_rows, n_tris), (row_idx, tris_idx) = mesh, at
    h, w = cfg.resolution
    lh = h // n_rows
    row0 = row_idx * lh
    zb = zb_sign[row0:row0 + lh].contiguous()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], zb.device)
    dbg_mvp = pl._debug_mvp(cfg, dyn, zb.device)
    padded = pad_models_for_tris(dyn, n_tris)
    shards = []
    for t in range(n_tris):
        # As render_frame_sharded: the shard's rows in its config, its face
        # tables built before the stage.
        d = shard_dyn(padded, n_tris, t)
        c = shard_config(cfg, d)
        d = pl.with_face_tables(c, d)
        faces, attrs, _ = vertex_stage(c, d, cam_m, dbg_mvp)
        fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
        shards.append(((c, d), attrs, fdata, flags, t * fdata.shape[0],
                       rc.pack_debug_planes(faces)))
    tid = torch.stack([rc.tidpass_plain(f, fl, zb, cfg.system, row0, g0, fd)
                       for _, _, f, fl, g0, fd in shards]).amax(0)
    gb = sum(rc.gbuffer_plain(f, rc.pack_face_attrs(a), tid, row0, g0)
             for _, a, f, _, g0, _ in shards)
    (c, d), attrs, fdata, flags, gid0, fdbg = shards[tris_idx]
    owned = (tid >= gid0) & (tid < gid0 + fdata.shape[0])
    if not (owned.any() and ((tid >= 0) & ~owned).any()):
        raise AssertionError(f"rank {at} of {mesh}: degenerate shard inputs")
    own = {"row0": row0, "gid0": gid0}
    dbg = {} if fdbg is None else {"fdbg": fdbg}
    inputs = {
        "visibility_z": ((fdata, flags, lh, w, cfg.system),
                         {"row0": row0, "want_tid": False, **dbg}),
        "tidpass": ((fdata, flags, zb, cfg.system), {**own, **dbg}),
        "gbuffer_owned": ((fdata, rc.pack_face_attrs(attrs), tid), own),
        "sample_textures_owned": (
            (tid, gb[rc.GB_IU].contiguous(), gb[rc.GB_IV].contiguous(),
             *pl.texture_tables(c, d, attrs)), {"gid0": gid0}),
    }
    for layout in ("gouraud", "pbr"):
        inputs[f"gbuffer_slim_{layout}_owned"] = (
            (fdata, rc.pack_slim_attrs(attrs, layout), tid, layout), own)
    return inputs


#: K3's adversarial frame: H*W = 7,275, three more than a multiple of 4.
K3_ADV_RES = (97, 75)
#: Its textures (TH, TW): 1x1, a row, a column, sizes no power of two.
K3_ADV_TEXTURES = ((1, 1), (1, 7), (5, 1), (3, 5), (13, 11), (37, 100),
                   (64, 48))
#: Its face table's rows and their first global id.
K3_ADV_FACES, K3_ADV_GID0 = 64, 37
#: uv values planted among uniform ones in [-2, 3).
K3_ADV_UV = (np.nan, np.inf, -np.inf, -0.0, 0.0, 1.0, np.nextafter(
    np.float32(1), np.float32(2)), -1.0, 1e30, -1e30, 2.5, -3.75)


def k3_adversarial_inputs(seed=0, vector=False, device="cpu"):
    """K3's adversarial inputs on K3_ADV_RES, owned range from K3_ADV_GID0,
    as (args, kwargs). The flat tid runs through background, runs of one
    face, a new face at every pixel and other shards' ids, and its last
    three pixels (the tail past the last group of 4) are face 0's, whose
    kinds all have maps. uv is seeded in [-2, 3) with NaN, ±inf, ±0, 1,
    the float after 1 and ±1e30 planted. Per face and kind the slot is one
    of K3_ADV_TEXTURES', -1, past the slot table, or one of two slots whose
    indices leave the pool (one past its end, one at a negative offset).
    With ``vector=False`` iu and iv are planes 3 and 4 of a 5-plane buffer,
    as K3 gets them from the G-buffer, so iu is not 16-byte aligned and K3
    takes its scalar instance; with ``vector=True`` they are fresh tensors
    and ftex keeps the first kind only, so every plane, samp's one
    included, is aligned and K3 takes its vector instance, with a tail."""
    import torch

    rng = np.random.default_rng(seed)
    h, w = K3_ADV_RES
    n, g, gid0 = h * w, K3_ADV_FACES, K3_ADV_GID0
    dims = np.array(K3_ADV_TEXTURES)
    sizes = dims.prod(1)
    pool = rng.integers(0, 1 << 24, sizes.sum()).astype(np.int32)
    slots = np.stack([np.cumsum(sizes) - sizes, dims[:, 1]], 1)
    slots = np.concatenate([slots, [[pool.size - 3, 50], [-40, 7]]])
    n_tex, n_slots = len(dims), len(slots)
    pick = rng.random((g, 3))
    slot = rng.integers(0, n_tex, (g, 3))
    slot = np.where(pick < 0.15, -1, slot)
    slot = np.where((pick >= 0.15) & (pick < 0.25), rng.choice(
        [n_slots, n_slots + 4, 2 ** 30], (g, 3)), slot)
    slot = np.where((pick >= 0.25) & (pick < 0.35),
                    rng.integers(n_tex, n_slots, (g, 3)), slot)
    slot[0] = (0, 4, 5)
    shape = np.where((slot >= 0)[..., None] & (slot < n_tex)[..., None],
                     dims[np.clip(slot, 0, n_tex - 1)],
                     dims[rng.integers(0, n_tex, (g, 3))])
    ftex = np.concatenate([slot[..., None], shape], -1).astype(np.int32)
    others = np.concatenate([np.arange(gid0), gid0 + g + np.arange(50)])
    anything = np.concatenate([[-1], others, gid0 + np.arange(g)])
    runs = []
    while sum(map(len, runs)) < n:
        kind, length = rng.integers(0, 5), rng.integers(1, 24)
        # Background, one face, a new face at every pixel, other shards'
        # faces, or any of these at every pixel.
        runs.append([np.full(length, -1),
                     np.full(length, gid0 + rng.integers(g)),
                     gid0 + rng.integers(0, g, length),
                     rng.choice(others, length),
                     rng.choice(anything, length)][kind])
    tid = np.concatenate(runs)[:n].astype(np.int32)
    tid[-3:] = gid0
    planes = np.zeros((5, n), np.float32)
    for c in (3, 4):
        planes[c] = rng.uniform(-2.0, 3.0, n)
        at = rng.random(n) < 0.1
        planes[c, at] = rng.choice(np.array(K3_ADV_UV, np.float32), at.sum())
    to = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(device)
    gb = to(planes.reshape(5, h, w))
    iu, iv = gb[3], gb[4]
    if vector:
        iu, iv, ftex = iu.clone(), iv.clone(), ftex[:, :1]
    return ((to(tid.reshape(h, w)), iu, iv, to(ftex),
             to(slots.astype(np.int32)), to(pool)), {"gid0": gid0})


def shade_inputs(cfg, dyn, ops=None, **core_kw):
    """K9's arguments in the frame of (cfg, dyn), as
    ``pipeline.render_core`` (its ``local_height`` and ``row0`` in
    ``core_kw``) calls ``ops.shade``, through ``ops`` (default the plain
    versions), as (args, kwargs)."""
    import copy

    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    got = []
    ops = copy.copy(rc.PLAIN if ops is None else ops)
    shade = ops.shade

    def capture(*args):
        got.append(args)
        return shade(*args)

    ops.shade = capture
    pl.render_core(cfg, dyn, ops, **core_kw)
    return got[0], {}


#: K9's adversarial frames (``k9_adversarial_inputs``): case -> (light
#: type, shadows, background "sky" (a plane) or "color", (H, W), maps).
#: Their H*W are 37*61 = 1 and 33*35 = 3 past a multiple of 4.
K9_ADV = {"shade-adv-spot-sky": ("SPOT_LIGHTNING", True, "sky", (37, 61),
                                 True),
          "shade-adv-directional": ("DIRECTIONAL_LIGHTNING", False, "color",
                                    (48, 64), True),
          "shade-adv-point-nomaps": ("POINT_LIGHTNING", True, "color",
                                     (33, 35), False)}
#: The adversarial frames' models: per model, its maps' (scale, offset) by
#: kind; model 0 has none, models 1 and 2 are instances (equal rows),
#: model 3 has a specular map and a diffuse map of its own scale.
K9_ADV_MODELS = ({}, {"kd": (1.0, 0.0), "norm": (2.0, -1.0)},
                 {"kd": (1.0, 0.0), "norm": (2.0, -1.0)},
                 {"kd": (0.5, 0.25), "ks": (1.0, 0.0)},
                 {"norm": (2.0, -1.0), "ks": (0.75, 0.125)})
#: Model ids that name no row of the table (planted at a few pixels).
K9_ADV_UNKNOWN = (-1.0, 5.0, 1.5, float("nan"), 1e10, -0.0)


def k9_adversarial_inputs(case, seed=0, device="cpu"):
    """K9's seeded adversarial inputs for a case of ``K9_ADV``, as (args,
    kwargs). Per pixel: background (tid -1) at a quarter; a model of
    K9_ADV_MODELS, or at 3% an id of K9_ADV_UNKNOWN; world positions
    around the light's axis (some inside the spot's cone, some on the
    light and on the camera: zero distances); normals, tangents and
    bitangents with zero vectors planted; tangent-space or object-space
    normal maps; Ns from 0 to 100; each kind's mask bit set at 80% of the
    pixels whose model has the map and 5% of the others (whose rows are
    zeros); stencil from -1 to 2 with shadows; a colour or a per-pixel
    skybox plane."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops.lightning import Lightning
    from tpu_renderer_torch.ops.transforms import normalize

    light_type, shadows, bg_kind, (h, w), maps = K9_ADV[case]
    rng = np.random.default_rng(seed)
    n = h * w
    to = lambda a, dt=torch.float32: torch.as_tensor(
        np.ascontiguousarray(a)).to(dt).to(device)
    vec3 = lambda lo, hi: rng.uniform(lo, hi, (3, n)).astype(np.float32)
    tid = np.where(rng.random(n) < 0.25, -1, rng.integers(0, 1000, n))
    n_models = len(K9_ADV_MODELS)
    model = rng.integers(0, n_models, n).astype(np.float32)
    odd = rng.random(n) < 0.03
    model[odd] = rng.choice(np.array(K9_ADV_UNKNOWN, np.float32), odd.sum())
    position = np.array([0.5, 3.0, 1.0], np.float32)
    center = np.array([0.0, 0.0, 0.0], np.float32)
    camera = np.array([2.0, 2.5, 4.0], np.float32)
    gb = rng.uniform(-1.0, 1.0, (rc.GB_CHANNELS, n)).astype(np.float32)
    gb[rc.GB_WORLD:rc.GB_WORLD + 3] = (center[:, None] + vec3(-1.5, 1.5))
    on = rng.random(n)
    gb[rc.GB_WORLD:rc.GB_WORLD + 3, on < 0.01] = position[:, None]
    gb[rc.GB_WORLD:rc.GB_WORLD + 3, (on >= 0.01) & (on < 0.02)] = \
        camera[:, None]
    for c in (rc.GB_N, rc.GB_TAN, rc.GB_BIT):
        gb[c:c + 3, rng.random(n) < 0.02] = 0.0
    gb[rc.GB_KD:rc.GB_KD + 6] = rng.random((6, n))
    gb[rc.GB_NS] = rng.choice(np.array([0.0, 0.5, 1.0, 5.0, 20.0, 100.0],
                                       np.float32), n)
    gb[rc.GB_NORM_SLOT + 3] = rng.random(n) < 0.5
    gb[rc.GB_MODEL] = model
    gb[:, tid < 0] = 0.0
    args = [to(tid.reshape(h, w), torch.int32),
            to(rng.integers(-1, 3, (h, w)), torch.int32) if shadows else None,
            to(gb.reshape(rc.GB_CHANNELS, h, w)), None, None, None]
    if maps:
        so = np.zeros((n_models, rc.N_KINDS, 2), np.float32)
        has = np.zeros((n_models + 1, rc.N_KINDS), bool)
        for m, kinds in enumerate(K9_ADV_MODELS):
            for k, kind in enumerate(rc.KINDS):
                if kind in kinds:
                    so[m, k], has[m, k] = kinds[kind], True
        m_idx = np.where(odd, n_models, np.where(odd, 0, model).astype(
            np.int64))
        p_bit = np.where(has[m_idx], 0.8, 0.05)
        bits = rng.random((n, rc.N_KINDS)) < p_bit
        mask = (bits * (1 << np.arange(rc.N_KINDS))).sum(1)
        args[3:] = [to(rng.integers(0, 1 << 24, (rc.N_KINDS, h, w)),
                       torch.int32), to(mask.reshape(h, w), torch.int32),
                    to(so)]
    kind = Lightning[light_type]
    light = {"position": to(position), "center": to(center),
             "color": to([1.0, 0.9, 0.8]), "ambient": to([0.1, 0.12, 0.08]),
             "specular_strength": to(0.5), "constant": to(1.0),
             "linear": to(0.05), "quadratic": to(0.01), "light_type": kind}
    light["direction"] = normalize(light["position"]
                                   - light["center"]).reshape(-1)
    background = (rng.random((h, w, 3)) if bg_kind == "sky"
                  else [64 / 255, 0.5, 198 / 255])
    return (*args, light, to(camera), to(background)), {}


#: K10's adversarial tables (``k10_adversarial_inputs``): frame (H, W),
#: vertices, faces, and the padding rows at the end of the faces.
K10_ADV_RES = (61, 97)
K10_ADV_VERTS, K10_ADV_FACES, K10_ADV_PAD = 300, 512, 32
#: Its first faces: name -> (vertex ids, valid without culling: True,
#: False, or None where the kind of face does not say).
K10_ADV_ROWS = {"one vertex": ((12, 12, 12), False),
                "collinear": ((7, 8, 9), None),
                "zero area": ((12, 12, 13), False),
                "w = 0": ((0, 11, 12), None),
                "behind": ((1, 11, 12), None),
                "nan": ((2, 11, 12), None),
                "inf": ((3, 11, 12), None),
                "1e30": ((4, 11, 12), None),
                "off the frame": ((5, 6, 14), False),
                "front": ((11, 12, 13), True),
                "back": ((11, 13, 12), True),
                "near": ((10, 11, 12), None),
                "eye, behind, near": ((0, 1, 10), None),
                "behind, two": ((1, 12, 13), None)}


def k10_adversarial_inputs(layout="general", culling=False, debug=False,
                           seed=0, device="cpu"):
    """K10's seeded adversarial inputs, as (args, kwargs) of
    ``raster_cuda.vertex_faces``: K10_ADV_VERTS vertices about the origin
    seen by a camera at (0.5, 0.8, 3) (fovy 60, near 0.1, far 20, LH,
    OpenGL, K10_ADV_RES), among them the camera's own position (clip w =
    0), points behind it and just in front of it, a NaN, an inf and a 1e30
    coordinate, points far off the frame and three collinear ones;
    K10_ADV_FACES faces of seeded ids, among them a face of one vertex
    three times, a collinear one, a zero-area one (two ids equal), faces
    through each special vertex (straddling w = 0, behind the camera, not
    finite, off the frame) and one face in both windings (K10_ADV_ROWS), a
    tenth of the rest with a special vertex, and K10_ADV_PAD padding rows at
    the end;
    per face seeded constants (uv with NaN planted, slots from -1, map
    shapes, Ka, Pm, Pr), vertex normals on about half the faces, clip and
    z-write each on about half. With ``debug`` the debug camera's MVP (at
    (-1, 2, 1.5), near 1, far 4, which cut the vertices)."""
    import torch
    import tpu_renderer_torch as tr
    from tpu_renderer_torch.constants import SUBSYSTEM, SYSTEM
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops.lightning import Lightning

    rng = np.random.default_rng(seed)
    h, w = K10_ADV_RES
    cam = tr.Camera((0.5, 0.8, 3.0), center=(0, 0, 0), fovy=60, near=0.1,
                    far=20)
    dbg = tr.Camera((-1.0, 2.0, 1.5), center=(0, 0, 0), fovy=70, near=1.0,
                    far=4.0)
    cfg = pl.SceneConfig(resolution=(h, w), system=SYSTEM.LH,
                         subsystem=SUBSYSTEM.OPENGL, shadows=False,
                         cam_projection_type=cam.projection_type,
                         backface_culling=culling,
                         light_type=Lightning.POINT_LIGHTNING, models=())
    cam_m = pl._cam_matrices(cfg, tr.Scene._cam_dyn(cam), device)
    dbg_mvp = (pl._cam_matrices(cfg, tr.Scene._cam_dyn(dbg), device,
                                dbg.projection_type)["MVP"]
               if debug else None)
    eye = np.array([0.5, 0.8, 3.0])
    v = np.ones((K10_ADV_VERTS, 4))
    v[:, :3] = rng.uniform(-2.0, 2.0, (K10_ADV_VERTS, 3))
    v[0, :3] = eye                                  # clip w = 0
    v[1, :3] = eye * 1.5                            # behind the camera
    v[2, :3] = (np.nan, 0.0, 0.0)
    v[3, :3] = (np.inf, 0.0, 0.0)
    v[4, :3] = (1e30, 1e30, 0.0)
    v[5, :3] = (40.0, 0.0, 0.0)                     # off the frame
    v[6, :3] = (40.0, 1.0, 0.0)
    v[7:10, :3] = ((0.0, 0.0, 0.0), (0.5, 0.5, 0.5), (1.0, 1.0, 1.0))
    v[10, :3] = eye * 0.97                          # just in front
    v[11:14, :3] = ((0.0, 0.0, 0.0), (0.5, 0.0, 0.0), (0.0, 0.5, 0.0))
    v[14, :3] = (40.0, 0.0, 1.0)
    g = K10_ADV_FACES
    vid = rng.integers(15, K10_ADV_VERTS, (g, 3))
    special = rng.random(g) < 0.1
    vid[special, rng.integers(0, 3, int(special.sum()))] = rng.integers(
        0, 11, int(special.sum()))
    vid[:len(K10_ADV_ROWS)] = [ids for ids, _ in K10_ADV_ROWS.values()]
    f32 = lambda a: torch.tensor(np.asarray(a, np.float32), device=device)
    i32 = lambda a: torch.tensor(np.asarray(a, np.int32), device=device)
    flag = lambda p: torch.tensor(rng.random(g) < p, device=device)
    uv = rng.random((g, 3, 2))
    uv[rng.random((g, 3, 2)) < 0.02] = np.nan
    has_vn = flag(0.5)
    vn = f32(rng.normal(size=(g, 3, 3))) * has_vn[:, None, None]
    ft = {"vid": torch.tensor(vid, device=device), "uv": f32(uv),
          "kd": f32(rng.random((g, 3))), "ks": f32(rng.random((g, 3))),
          "ns": f32(rng.random(g) * 100), "pm": f32(rng.random(g)),
          "pr": f32(rng.random(g)), "ka": f32(rng.random((g, 3))),
          **{f"{k}_slot": i32(rng.integers(-1, 6, g))
             for k in ("kd", "ks", "norm")},
          **{f"{k}_shape": f32(rng.integers(1, 65, (g, 2)))
             for k in ("kd", "ks", "norm")},
          "norm_tangent": flag(0.5), "vn": vn, "has_vn": has_vn,
          "clip_en": flag(0.5), "z_write": flag(0.5),
          "pad_valid": torch.arange(g, device=device) < g - K10_ADV_PAD,
          "model_id": i32(rng.integers(0, 6, g))}
    ft["attr_consts"] = rc.attr_consts(ft)
    ft["face_bits"] = rc.face_bits(ft)
    return (f32(v), ft, cam_m, h, w, culling, layout, dbg_mvp), {}


def wrapper_of(case):
    """raster_cuda wrapper name of a kernel case."""
    case = case.removesuffix("_dbg").removesuffix("_fill")
    if case == "vertex":
        return "vertex_faces"
    if case.startswith("gbuffer_slim"):
        return "gbuffer_slim"
    if case == "visibility_z":
        return "visibility"
    return case.removesuffix("_owned")


def _tile_counts(bbox, active, h, w, row0=0):
    """Items per binning tile, as the wrapper's tile_bins lists them."""
    from tpu_renderer_torch.ops import raster_cuda as rc

    off, _ = rc.tile_bins(bbox, active, h, w, row0=row0)
    return (off[1:] - off[:-1]).double()


def _tile_sums(mask):
    """Pixels of ``mask`` (H, W) in each binning tile, tile-row-major."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    t = rc.TILE
    h, w = mask.shape
    m = torch.zeros((-(-h // t) * t, -(-w // t) * t), dtype=torch.float64,
                    device=mask.device)
    m[:h, :w] = mask.double()
    return m.reshape(m.shape[0] // t, t, m.shape[1] // t, t).sum((1, 3)
                                                                ).reshape(-1)


#: Lower counts of float operations (multiply, add, compare, floor) per
#: (pixel, listed item) visit of the tile-binned kernels — K1's coverage and
#: depth test of one face in one pass (K7's claim test likewise); K4's first
#: edge test, on geometry pixels only (it skips background) — per pixel an
#: edge reaches for K6 (one candidate test: kk, the minor coordinate, six
#: compares, the depth and its test), per row K8 prepares (the projection
#: of its 12 slots alone: two 4x4 row-vector products and four divides
#: each; the clip and pack not counted), per face K10 transforms (its three
#: vertices through two 4x4 row-vector products, 1/w and the depth, 70
#: each; the coefficients, box and planes not counted), and per computed
#: pixel of the per-pixel kernels (K3: per kind).
OPS_PER_VISIT = {"visibility": 20, "tidpass": 20, "stencil": 5, "lines": 16,
                 "quad_prep": 720, "vertex_faces": 210}
OPS_PER_PIXEL = {"gbuffer": 100, "sample_textures": 45,
                 "gbuffer_slim_flat": 0, "gbuffer_slim_gouraud": 25,
                 "gbuffer_slim_pbr": 40, "shade": 100}


#: Columns of each face table a G-buffer kernel reads per winning face:
#: K2 the six barycentric and three 1/w columns of fdata and every column of
#: adata; K5 the slim table, and the six barycentric columns of fdata unless
#: the layout is flat.
WINNER_COLS = {"gbuffer": 9 + 42, "gbuffer_slim_flat": 3,
               "gbuffer_slim_gouraud": 6 + 9, "gbuffer_slim_pbr": 6 + 23}


def _computed(case, args, kw):
    """(pixels a per-pixel kernel computes: those whose tid is one of its
    table's ids [gid0, gid0 + G); the table's local indices of their
    faces)."""
    import torch

    if wrapper_of(case) == "shade":
        own = args[0] >= 0
        return own, torch.zeros(0, dtype=torch.long, device=own.device)
    if wrapper_of(case) == "sample_textures":
        tid, table = args[0], args[3]
    else:
        tid, table = args[2], args[0]
    gid0 = kw.get("gid0", 0)
    own = (tid >= gid0) & (tid < gid0 + table.shape[0])
    return own, torch.unique(tid[own] - gid0).long()


def needed_bytes(case, args, kw, out):
    """Bytes the call's function must move in this run: each output written
    once, and of its inputs only what its outputs depend on, each read once
    — per-pixel planes where the function reads them, the table rows of the
    faces that win a computed pixel (or of the valid faces, active quads
    and edges), and the texels that some pixel samples."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops import raster_plain as rp

    kind = wrapper_of(case)
    if kind == "vertex_faces":
        return vertex_bytes(args, out)
    outs = [t for t in (out if isinstance(out, tuple) else (out,))
            if t is not None]
    n = sum(t.numel() * t.element_size() for t in outs)
    if kind == "quad_prep":
        # The silhouette flags and the order over every edge, per
        # silhouette row its quad and order entry read (68 B), and both
        # tables written whole (208 B a row): the rows past the count are
        # zeros by contract (no stale row may reach K4), so outputs too;
        # zero_row_bytes gives their share.
        return (args[0].shape[0] * 5 + _prep_rows(args) * 68
                + args[1].shape[0] * (rc.Q_COLS + rc.QI_COLS) * 4)
    if kind in ("visibility", "tidpass"):
        # Every valid face's row, every face's flag word; K7's zb where a
        # face claims the pixel (a lower count: there the id depends on it);
        # with a debug camera, the debug planes of the valid faces that
        # take the per-pixel clip test.
        flags = args[1]
        valid = (flags & rp.FLAG_VALID) > 0
        n += int(valid.sum()) * rp.F_COLS * 4 + flags.numel() * 4
        if kw.get("fdbg") is not None:
            ppc = valid & ((flags & rp.FLAG_PPC) > 0)
            n += int(ppc.sum()) * rp.DBG_COLS * 4
        return n + (int((out >= 0).sum()) * 4 if kind == "tidpass" else 0)
    if kind == "stencil":
        # The active quads' rows and every quad's flag; zb where the
        # stencil is nonzero (a lower count: there the output certainly
        # depends on it); the three depth constants.
        qi = args[1]
        active = int((qi[:, 5] > 0).sum())
        return (n + active * (rc.Q_COLS + rc.QI_COLS) * 4 + qi.shape[0] * 4
                + int((outs[0] != 0).sum()) * 4 + 3 * 4)
    if kind == "lines":
        # The active edges' rows and every edge's flag; zbuf on the pixels
        # where some edge's DDA pixel lands.
        active = args[2]
        return (n + int(active.sum()) * (rc.L_COLS + 4) * 4 + active.numel()
                + _lines_reach(args) * 4)
    if kind == "shade":
        return n + shade_bytes(args)
    _, faces = _computed(case, args, kw)
    if kind != "sample_textures":
        return (n + args[2].numel() * 4
                + faces.numel() * WINNER_COLS[case.removesuffix("_owned")] * 4)
    # K3: tid everywhere; iu and iv where some kind is sampled; the winning
    # faces' texture rows, the slots they name, and each sampled texel.
    tid, _, _, ftex, slots, _ = args
    idx, hit = rc.texel_indices(*args, **kw)
    used = torch.unique(ftex[faces, :, 0])
    used = used[(used >= 0) & (used < slots.shape[0])]
    return (n + tid.numel() * 4 + int(hit.any(0).sum()) * 8
            + faces.numel() * ftex.shape[1] * 3 * 4 + used.numel() * 8
            + torch.unique(idx[hit]).numel() * 4)


#: Packing-constant columns K10 reads per face and layout
#: (raster_cuda.attr_consts), besides vn: the general row's uv and its 18
#: columns from kd, and the pbr row's pm, pr and ka.
VERTEX_CONST_COLS = {"general": 6 + 18, "flat": 0, "gouraud": 0, "pbr": 5}


def vertex_bytes(args, out):
    """Bytes K10 must move for its frame: every output written once (fdata,
    flags, the debug planes, the shading row, and the slim layouts' world
    table; the general layout's world is a view of its row); per face its
    three ids, its bits word and the constant columns of its layout, vn
    where the face has vertex normals and the layout reads vn; each
    vertex some face names, once; the camera (34 floats, 16 more with a
    debug camera)."""
    import torch

    verts, ft, _, _, _, _, layout, dbg_mvp = args
    fdata, flags, fdbg, rows, world = out
    outs = [fdata, flags, fdbg, rows] + ([] if layout == "general"
                                         else [world])
    n = sum(t.numel() * t.element_size() for t in outs if t is not None)
    g = ft["vid"].shape[0]
    vn = 0 if layout == "flat" else int(ft["has_vn"].sum()) * 9 * 4
    return (n + g * (3 * 8 + 4 + VERTEX_CONST_COLS[layout] * 4) + vn
            + torch.unique(ft["vid"]).numel() * verts.shape[1] * 4
            + (34 + (0 if dbg_mvp is None else 16)) * 4)


def shade_bytes(args):
    """Bytes K9 must read for its frame: tid and the light table; per
    foreground pixel the world position, normal and Ns planes, Kd where
    no diffuse sample replaces it and Ks where no specular one does, the
    stencil with shadows, and with maps the mask, the model id where a
    sample is taken, each sample taken, the tangent flag where the normal
    map's is, the tangent and bitangent where that map is in tangent space,
    and the model table; per background pixel its skybox texel, or the
    colour once."""
    from tpu_renderer_torch.ops import raster_cuda as rc

    tid, stencil, gb, samp, mask, scale_off, _, _, background = args
    fg = tid >= 0
    n_fg = int(fg.sum())
    n = tid.numel() * 4 + 19 * 4 + n_fg * 7 * 4
    if stencil is not None:
        n += n_fg * 4
    if samp is None:
        n += n_fg * 6 * 4
    else:
        hit = [fg & (((mask >> k) & 1) > 0) for k in range(rc.N_KINDS)]
        norm = hit[rc.KINDS.index("norm")]
        tangent = norm & (gb[rc.GB_NORM_SLOT + 3] > 0.5)
        n += ((n_fg - int(hit[0].sum())) * 12
              + (n_fg - int(hit[2].sum())) * 12 + n_fg * 4
              + int((hit[0] | hit[1] | hit[2]).sum()) * 4
              + sum(int(h.sum()) for h in hit) * 4 + int(norm.sum()) * 4
              + int(tangent.sum()) * 24 + scale_off.numel() * 4)
    return n + (int((~fg).sum()) * 12 if background.dim() == 3 else 12)


def _prep_rows(args):
    """The rows K8 prepares: its count, within the table's capacity."""
    return max(0, min(int(args[2]), args[1].shape[0]))


def zero_row_bytes(args):
    """Bytes of the zero rows K8 writes past its count (both tables)."""
    from tpu_renderer_torch.ops import raster_cuda as rc

    return (args[1].shape[0] - _prep_rows(args)) * (rc.Q_COLS
                                                    + rc.QI_COLS) * 4


def _lines_reach(args):
    """Pixels where some active edge's DDA pixel lands: K6's mask with
    every z test passed."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    ldata, bbox, active, zbuf, h, w = args
    return int(rc.lines_plain(ldata, bbox, active,
                              torch.full_like(zbuf, float("inf")), h,
                              w).sum())


def bound(case, args, kw, out, zb_sign):
    """(bound_ms, "bytes" or "operations", bytes, operations): the least time
    the card could take for this call, the larger of needed_bytes over
    PEAK_BYTES and its operations on these inputs over PEAK_F32."""
    import torch
    from tpu_renderer_torch.ops import raster_plain as rp

    nbytes = needed_bytes(case, args, kw, out)
    kind = wrapper_of(case)
    fg = zb_sign < 3e38
    if kind in ("visibility", "tidpass"):
        fdata, flags = args[0], args[1]
        h, w = args[2:4] if kind == "visibility" else args[2].shape
        lists = _tile_counts(fdata[:, rp.F_BBOX:rp.F_BBOX + 4].to(torch.int32),
                             (flags & rp.FLAG_VALID) > 0, h, w,
                             kw.get("row0", 0))
        if kind == "visibility":
            # One pass over every listed face (K1's z pass).
            ops = lists @ _tile_sums(torch.ones((h, w), dtype=torch.bool,
                                                device=fdata.device))
        else:
            # K7, a lower count: one visit where a face claims the pixel
            # (a walk from the list's end could stop there), the tile's
            # whole list where none does.
            claimed = out >= 0
            ops = claimed.double().sum() + lists @ _tile_sums(~claimed)
    elif kind == "stencil":
        h, w = zb_sign.shape
        qi = args[1]
        ops = _tile_counts(qi[:, 0:4], qi[:, 5] > 0, h, w) @ _tile_sums(fg)
    elif kind == "lines":
        # One full candidate test per pixel an edge reaches, whatever the
        # kernel's layout.
        ops = _lines_reach(args)
    elif kind == "quad_prep":
        ops = _prep_rows(args)
    elif kind == "vertex_faces":
        ops = args[1]["vid"].shape[0]
    else:
        ops = _computed(case, args, kw)[0].double().sum()
    per = OPS_PER_VISIT.get(kind, OPS_PER_PIXEL.get(
        case.removesuffix("_owned")))
    ops = float(ops) * per
    t_bytes, t_ops = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations",
            nbytes, ops)


def ptxas_report(log, kernel):
    """{"registers", "stack", "spill_stores", "spill_loads"} of the entry
    function whose mangled name holds ``kernel`` in nvcc's ``-Xptxas -v``
    log (one entry per kernel; a template's instances give their last).
    Raises when the log has no such kernel."""
    out, inside = None, False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            inside = kernel in line
            continue
        if not inside:
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m:
            out = dict(out or {}, stack=int(m[1]), spill_stores=int(m[2]),
                       spill_loads=int(m[3]))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out = dict(out or {}, registers=int(m[1]))
    if out is None or len(out) != 4:
        raise RuntimeError(f"ptxas log: no report of {kernel}")
    return {k: out[k] for k in ("registers", "stack", "spill_stores",
                                "spill_loads")}


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


#: The port's kernels as the profiler names them (csrc/*.cu).
_OUR_KERNEL = re.compile(r"::(visibility|tidpass|gbuffer|gbuffer_slim|sample|"
                         r"stencil|lines|lines_clear|coarse_bins|quad_prep|"
                         r"shade|vertex|overlay_quantize|overlay)_kernel[<(]")
#: The kernels (``_OUR_KERNEL``'s names) each wrapper launches once per call
#: where they are not just the wrapper's name: K1, K4 and K7 bin first with
#: csrc/bins.cu, K6 clears its mask first.
_WRAPPER_KERNELS = {"visibility": ("coarse_bins", "visibility"),
                    "stencil": ("coarse_bins", "stencil"),
                    "tidpass": ("coarse_bins", "tidpass"),
                    "lines": ("lines_clear", "lines"),
                    "sample_textures": ("sample",),
                    "vertex_faces": ("vertex",)}


def _alone_ms(fn, wrapper, runs=3, tries=3):
    """Device time per call of the kernels that ``wrapper`` launches through
    ``fn``, without the wrapper's host work (checks, allocation): a
    profile of ``runs`` calls, each in a ``tr.alone`` range, summed over the
    wrapper's kernels of each one's mean time. A trace can come back short
    of some events: then the profile is taken again, up to ``tries`` times,
    until every kernel of the wrapper has exactly ``runs`` events. If every
    trace is short, the last one's means stand (each event is one launch);
    when a kernel has no event or more than ``runs``, it raises."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    names = _WRAPPER_KERNELS.get(wrapper, (wrapper,))
    for _ in range(tries):
        # CPU activity too: after a profile of both (``_profile``), one of
        # CUDA activity alone recorded no kernel event on the H100.
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(runs):
                with torch.profiler.record_function("tr.alone"):
                    fn()
            torch.cuda.synchronize()
        times = {name: [] for name in names}
        for e in prof.events():
            m = (_OUR_KERNEL.search(e.name)
                 if e.device_type == DeviceType.CUDA else None)
            if m and m.group(1) in times:
                times[m.group(1)].append(e.time_range.elapsed_us())
        if all(len(t) == runs for t in times.values()):
            break
    if not all(0 < len(t) <= runs for t in times.values()):
        raise RuntimeError(f"{wrapper}: a profile of {runs} calls has "
                           f"{ {k: len(v) for k, v in times.items()} } "
                           f"events of {names}")
    return sum(statistics.mean(t) for t in times.values()) / 1e3


def _graph_ms(fn, calls=20, runs=5):
    """Device ms per call of ``fn`` (a kernel wrapper on fixed inputs):
    ``calls`` calls captured into one CUDA graph, whose replay is timed
    with CUDA events (``_time_ms``: median of ``runs`` after a warm-up), so
    no host work and no profiler is in the time. The capture's launches
    count nowhere (``raster_cuda.counting_into``)."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with rc.counting_into({}), torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    ms = _time_ms(graph.replay, runs) / calls
    del graph
    return ms


def _same(a, b):
    """Equal values (NaN where the other is NaN), shapes and types; None
    only against None."""
    import torch

    if a is None or b is None:
        return a is b
    if isinstance(a, tuple):
        return all(_same(x, y) for x, y in zip(a, b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.is_floating_point():
        return bool(((a == b) | (torch.isnan(a) & torch.isnan(b))).all())
    return torch.equal(a, b)


#: Cases held to their plain version exactly: K5, K6, K8 (NaN where NaN),
#: every sharded mode and every debug mode.
EXACT = ("visibility_z", "tidpass", "gbuffer_owned", "sample_textures_owned",
         "gbuffer_slim_gouraud_owned", "gbuffer_slim_pbr_owned",
         "visibility_dbg", "visibility_z_dbg", "tidpass_dbg", "quad_prep")


def ulps_apart(a, b):
    """(values that differ, the most units in the last place between two
    of them, the pixels they lie in) of two float32 tensors of one shape
    (H, W, ...); NaN where the other is NaN counts as equal."""
    import torch

    bits = lambda t: t.contiguous().view(torch.int32).to(torch.int64)
    ia, ib = bits(a), bits(b)
    # Order the float bit patterns as integers: negatives count down.
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    off = (a != b) & ~(torch.isnan(a) & torch.isnan(b))
    px = off.reshape(off.shape[0], off.shape[1], -1).any(-1)
    return (int(off.sum()), int((ia - ib).abs()[off].max()) if off.any()
            else 0, int(px.sum()))


def _compare(name, got, ref):
    """(max_abs_err, verdict) against the kernel's stated tolerance; raises
    on disagreement."""
    import torch

    if wrapper_of(name) in ("shade", "vertex_faces"):
        if not _same(got, ref):
            raise AssertionError(f"{name}: differs from its plain version: "
                                 f"{ulps_apart(got, ref)}")
        return 0.0, "exact"
    if name in EXACT or wrapper_of(name) in ("gbuffer_slim", "lines"):
        if not _same(got, ref):
            raise AssertionError(f"{name}: differs from its plain version")
        return 0.0, "exact"
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


def _check_coarse_bins(case, args, kw):
    """K1's, K4's or K7's coarse lists for this call, built by csrc/bins.cu
    on the card, against ``coarse_bins_plain``; raises if they differ. K4's
    lists scan the count ``kw["n_rows"]`` of rows where the call gives one.
    Returns (the wrapper's scratch bytes, the longest coarse list, entries
    in all, the longest list of a 16x16 tile before the kernel's
    refinement)."""
    import torch
    from tpu_renderer_torch.ops import _build
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops import raster_plain as rp

    row0 = kw.get("row0", 0)
    kind = wrapper_of(case)
    if kind in ("visibility", "tidpass"):
        fdata, words = args[:2]
        h, w = args[2:4] if kind == "visibility" else args[2].shape
        kind, bbox = 0, fdata[:, rp.F_BBOX:rp.F_BBOX + 4]
        active = (words & rp.FLAG_VALID) > 0
    else:
        fdata, words = None, args[1]
        h, w = args[2].shape
        kind, bbox, active = 1, words[:, 0:4], words[:, 5] > 0
    n = words.shape[0]
    n_rows = kw.get("n_rows")
    tiles = rc._coarse_tiles(h, w)
    counts = torch.empty(tiles, dtype=torch.int32, device=words.device)
    items = torch.empty((tiles, max(n, 1)), dtype=torch.int32,
                        device=words.device)
    code = _build.load().tr_coarse_bins(
        kind, None if fdata is None else fdata.data_ptr(), words.data_ptr(),
        n, None if n_rows is None else n_rows.data_ptr(), h, w, row0,
        counts.data_ptr(), items.data_ptr(),
        torch.cuda.current_stream().cuda_stream)
    if code != 0:
        raise RuntimeError(f"{case}: coarse_bins failed: cudaError {code}")
    want_counts, want_items = rc.coarse_bins_plain(bbox, active, h, w, row0,
                                                   n_rows)
    keep = torch.arange(n, device=words.device)[None] < want_counts[:, None]
    if not (torch.equal(counts, want_counts)
            and torch.equal(items[:, :n][keep], want_items[keep])):
        raise AssertionError(f"{case}: coarse lists differ from plain")
    if n_rows is not None:
        active = active & (torch.arange(n, device=words.device) < n_rows)
    return (rc.bin_scratch_bytes(n, h, w), int(want_counts.max()),
            int(want_counts.sum()),
            int(_tile_counts(bbox.to(torch.int32), active, h, w, row0).max()))


def _assert_no_sync(fn):
    """Run ``fn`` under torch's sync debug mode "error", which raises on any
    op that waits for the device; first show that the mode is armed here
    (tile_bins' nonzero raises under it)."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    box = torch.zeros((4, 4), dtype=torch.int32, device="cuda")
    active = torch.ones(4, dtype=torch.bool, device="cuda")
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        try:
            rc.tile_bins(box, active, 32, 32)
        except RuntimeError:
            pass
        else:
            raise AssertionError("sync debug mode did not catch nonzero")
        fn()
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def render_eager(scene):
    """Scene.render()'s frame through the eager entry points (stage, then
    the body op by op, no graph), so that a profile's ``tr.<stage>`` ranges
    time each stage as the host runs it. Returns the uint8 frame."""
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    debug = scene.shader in pl.DEBUG_SHADERS
    ss = scene.supersample if not debug and scene.debug_camera is None else 1
    h, w = scene.resolution
    cfg, dyn = scene._prepare(resolution=(h * ss, w * ss))
    if ss > 1:
        return pl.render_ssaa(cfg, dyn, ss)[0].cpu().numpy()
    if debug:
        return pl.render_debug_frame(cfg, dyn, scene.shader)[0].cpu().numpy()
    if scene.debug_camera is not None and scene.debug_overlay:
        return scene._render_overlay(cfg, dyn, ops=rc.KERNELS)[0]
    return pl.render_frame(cfg, dyn)[0].cpu().numpy()


def _profile(scene, n_frames=5):
    """Where an eager frame's time goes: torch.profiler over a few
    ``render_eager`` frames, all per frame in ms. ``busy`` sums the
    device's kernel and copy events, so ``busy / wall`` is the device's
    busy share; ``host`` is each pipeline stage's host time and
    ``device_span`` its span on the device (the tr.* ranges of
    ops/pipeline.py); ``stage_busy`` the device's busy time inside each
    stage's device span (the kernel and copy events that start in it);
    ``top`` the largest device events by name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    render_eager(scene)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            render_eager(scene)
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / n_frames
    host, span, device = {}, {}, {}
    windows, work = [], []
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / n_frames
        if e.name.startswith("tr."):
            into = host if e.device_type == DeviceType.CPU else span
            into[e.name[3:]] = into.get(e.name[3:], 0.0) + ms
            if e.device_type == DeviceType.CUDA:
                windows.append((e.time_range.start, e.time_range.end,
                                e.name[3:]))
        elif e.device_type == DeviceType.CUDA:
            device[e.name] = device.get(e.name, 0.0) + ms
            work.append((e.time_range.start, ms))
    stage_busy = {}
    for start, ms in work:
        stage = next((n for a, b, n in windows if a <= start < b), "other")
        stage_busy[stage] = stage_busy.get(stage, 0.0) + ms
    busy = sum(device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1])[:8]
    # The kernels alone (phase 3 times the wrappers).
    kernels = {n: sum(v for k, v in device.items()
                      if f"::{n}_kernel(" in k or f"::{n}_kernel<" in k)
               for n in ("visibility", "gbuffer", "sample", "stencil",
                         "gbuffer_slim", "lines", "lines_clear", "tidpass",
                         "coarse_bins", "quad_prep", "shade", "overlay",
                         "overlay_quantize")}
    kernels = {k: v for k, v in kernels.items() if v > 0}
    r = lambda d: {k[:60]: round(v, 4) for k, v in d}
    return {"wall": wall_ms, "busy": busy, "busy_share": busy / wall_ms,
            "host": r(host.items()), "device_span": r(span.items()),
            "stage_busy": r(sorted(stage_busy.items(),
                                   key=lambda kv: -kv[1])),
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
    "gbuffer_slim": ("tpu_renderer_torch/csrc/gbuffer_slim.cu",
                     "tpu_renderer/ops/raster_pallas.py:1294"),
    "lines": ("tpu_renderer_torch/csrc/lines.cu",
              "tpu_renderer/ops/raster_pallas.py:2561"),
    "tidpass": ("tpu_renderer_torch/csrc/tidpass.cu",
                "tpu_renderer/ops/raster_pallas.py:2676"),
    # Not a pallas_call: the XLA clip, projection and pack of the compacted
    # silhouette (shadow.py:262-339 and raster_pallas.pack_quads :903).
    "quad_prep": ("tpu_renderer_torch/csrc/quad_prep.cu",
                  "tpu_renderer/ops/shadow.py:262"),
    # Not a pallas_call: the XLA deferred shade (pipeline._shade_gbuffer
    # :388, then shading.shade_general).
    "shade": ("tpu_renderer_torch/csrc/shade.cu",
              "tpu_renderer/ops/pipeline.py:388"),
    # Not a pallas_call: the XLA vertex stage (vertex.py, then
    # pipeline._build_face_batch :133 and raster_pallas.pack_faces :261).
    "vertex_faces": ("tpu_renderer_torch/csrc/vertex.cu",
                     "tpu_renderer/ops/pipeline.py:133"),
    # Not a pallas_call: the host overlay and the host flip, gamma and
    # uint8 after it (the JAX package's Scene.render).
    "overlay": ("tpu_renderer_torch/csrc/overlay.cu",
                "tpu_renderer/models/scene.py:824"),
    "overlay_quantize": ("tpu_renderer_torch/csrc/overlay.cu",
                         "tpu_renderer/models/scene.py:848"),
}
#: The TPU kernel a sharded mode replaces, where its wrapper's differs.
REPLACES = {
    "visibility_z": "tpu_renderer/ops/raster_pallas.py:602",
    "visibility_z_dbg": "tpu_renderer/ops/raster_pallas.py:602",
    "gbuffer_owned": "tpu_renderer/ops/raster_pallas.py:2776",
    "gbuffer_slim_gouraud_owned": "tpu_renderer/ops/raster_pallas.py:2776",
    "gbuffer_slim_pbr_owned": "tpu_renderer/ops/raster_pallas.py:2776",
    "sample_textures_owned": "tpu_renderer/ops/raster_pallas.py:2262",
}

#: The kernels each render path launches (flagship frame, shadows on: K8
#: then K4).
PATH_KERNELS = {
    "general": ("vertex", "visibility", "gbuffer", "sample_textures",
                "quad_prep", "stencil", "shade"),
    "slim": ("vertex", "visibility", "gbuffer_slim", "quad_prep", "stencil"),
    "wireframe": ("vertex", "visibility", "gbuffer_slim", "quad_prep",
                  "stencil", "lines"),
    "sharded": ("vertex", "visibility_z", "tidpass", "gbuffer",
                "sample_textures", "quad_prep", "stencil", "shade"),
    "sharded_slim": ("vertex", "visibility_z", "tidpass", "gbuffer_slim",
                     "quad_prep", "stencil"),
    "overlay": ("vertex_dbg", "visibility_dbg", "gbuffer", "sample_textures",
                "quad_prep", "stencil", "shade"),
    "wireframe_dbg": ("vertex_dbg", "visibility_dbg", "gbuffer_slim",
                      "quad_prep", "stencil", "lines"),
    "sharded_slim_dbg": ("vertex_dbg", "visibility_z_dbg", "tidpass_dbg",
                         "gbuffer_slim", "quad_prep", "stencil"),
}


def _check_render(scene, frame, debug):
    """Hold the scene's last render to the same frame through the plain
    versions: tid >= 99.9%, stencil equal, frame >= 99.9%; a supersampled
    render (``scene.supersample`` > 1, no debug shader or camera) through
    ``render_ssaa`` at the scaled size. Returns (tid match, frame match,
    foreground share)."""
    import torch
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    tid, stencil = scene.last_tid, scene.last_stencil
    ss = (scene.supersample if not debug and scene.debug_camera is None
          else 1)
    h, w = scene.resolution
    cfg, dyn = scene._prepare(resolution=(h * ss, w * ss))
    if ss > 1:
        f_p, _, tid_p, st_p = pl.render_ssaa(cfg, dyn, ss, ops=rc.PLAIN)
        f_p = f_p.cpu().numpy()
    elif debug:
        f_p, _, tid_p, st_p = pl.render_debug_frame(cfg, dyn, scene.shader,
                                                     ops=rc.PLAIN)
        f_p = f_p.cpu().numpy()
    elif scene.debug_camera is not None and scene.debug_overlay:
        f_p, _, tid_p, st_p = scene._render_overlay(cfg, dyn, ops=rc.PLAIN)
    else:
        f_p, _, tid_p, st_p = pl.render_frame(cfg, dyn, ops=rc.PLAIN)
        f_p = f_p.cpu().numpy()
    tid_match = (tid == tid_p).float().mean().item()
    frame_match = float((frame == f_p).all(-1).mean())
    if frame.shape != (*scene.resolution, 3) or tid.shape != tid_p.shape \
            or tid_match < 0.999 or frame_match < 0.999 \
            or not torch.equal(stencil, st_p):
        raise AssertionError(f"{scene.shader}: frame vs plain path: tid "
                             f"{tid_match}, frame {frame_match}, stencil "
                             f"equal {torch.equal(stencil, st_p)}")
    fg = (tid >= 0).float().mean().item()
    if fg == 0.0:
        raise AssertionError(f"{scene.shader}: degenerate frame, no "
                             "foreground")
    return tid_match, frame_match, fg


def _bits_equal(a, b):
    """Equal bit for bit: dtype, shape and every byte (NaN payloads and the
    sign of zero included)."""
    import torch

    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    a, b = a.contiguous(), b.contiguous()
    if a.is_floating_point():
        a, b = a.view(torch.uint8), b.view(torch.uint8)
    return torch.equal(a, b)


def _overlay_kernels(tr, records):
    """Phase 3's K11 and K12 (module docstring) on ``overlay_inputs``: each
    call on fresh copies of the inputs it writes, against its plain version
    on others: every output equal bit for bit (K11 the frame, the z-buffer
    and the pixel counter, K12 the uint8 frame), so max_abs_err 0; no
    host sync; timed as its wrapper and alone (K12 also as a captured
    graph) beside its bound: K12's bytes, K11 latency (its rows' points
    walked twice, in one block). Puts their records into ``records``."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    inputs = overlay_inputs(tr)
    for name, args in inputs.items():
        kern, plain = getattr(rc, name), getattr(rc, f"{name}_plain")
        fresh = lambda args=args: tuple(
            a.clone() if isinstance(a, torch.Tensor) and a.is_cuda else a
            for a in args)
        got, ref = kern(*fresh()), plain(*fresh())
        torch.cuda.synchronize()
        got, ref = ((got, ref) if isinstance(got, tuple)
                    else ((got,), (ref,)))
        err = max((g.double() - r.double()).abs().nan_to_num(0.0).max()
                  .item() for g, r in zip(got, ref))
        if err != 0.0 or not all(map(_bits_equal, got, ref)):
            raise AssertionError(f"{name}: differs from its plain version at "
                                 f"reference-main's shapes (max_abs_err "
                                 f"{err})")
        _assert_no_sync(lambda: kern(*fresh()))
        timed = fresh()
        ms = _time_ms(lambda: kern(*timed))
        alone = _alone_ms(lambda: kern(*timed), name)
        plain_ms = _time_ms(lambda: plain(*timed), runs=3)
        h, w = MAIN_RES
        if name == "overlay":
            table = args[0]
            points = int(table[:, 6].sum())
            shown = (f"{table.shape[0]} rows of {points} points, "
                     f"{int(table[:, 7].sum())} dashed; line px "
                     f"{int(got[2])}")
            bound_ms, bound_by, extra = None, "latency", (
                f"bound: latency (one block walks {points} points twice, "
                f"a barrier after each pass of each row)")
        else:
            nbytes = h * w * 3 * (8 + 1)
            bound_ms, bound_by = nbytes / PEAK_BYTES * 1e3, "bytes"
            shown = f"{h}x{w}x3 float64 to uint8"
            graph = _graph_ms(lambda: kern(*timed))
            extra = (f"bound {bound_ms:.4f} ms by bytes ({nbytes / 1e6:.2f} "
                     f"MB: float64 read, uint8 written); graph {graph:.4f} "
                     f"ms (device ms per call of a captured graph of 20 "
                     f"calls)")
        source, replaces = SOURCES[name]
        records[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": replaces, "launches": None,
                         "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by,
                         "library_ms": None}
        print(f"[3 kernel] {name} (reference-main, {h}x{w}, camera2) "
              f"{shown}: exact in every bit; max_abs_err {err:.3g}; no host "
              f"sync; kernel {ms:.4f} ms (its wrapper), alone {alone:.4f} "
              f"ms, plain {plain_ms:.2f} ms (numpy on copies to the host); "
              f"{extra}", flush=True)


def _check_overlay(scene, frame, pixels):
    """Hold the overlay of the scene's last render (K11 and K12 after the
    replay) to its numpy path on the same float frame and z-buffer: the
    eager ``pipeline.render_core`` through the kernels (which a replay
    equals: phase 9), then ``ops/overlay.draw_view_frustum`` and numpy's
    flip, gamma 0.8 and uint8 on the host. The uint8 frame, ``last_zbuf``
    and the overlay's line pixels (``pixels``, from
    ``profiling.snapshot()``) must be equal bit for bit; raises otherwise.
    Returns the line pixels."""
    import torch
    from tpu_renderer_torch.ops import overlay as ov
    from tpu_renderer_torch.ops import pipeline as pl

    cfg, dyn = scene._prepare()
    f, z = pl.render_core(cfg, dyn)[:2]
    f = f.cpu().numpy().astype(np.float64)
    z = z.cpu().numpy().astype(np.float64)
    _, px = ov.draw_view_frustum(
        f, scene.camera._matrices(torch.float64),
        scene.debug_camera._matrices(torch.float64), scene.camera.position,
        scene.camera.near, scene.camera.far, scene.resolution, z,
        scene.system)
    want = (np.clip(f[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)
    zb = scene.last_zbuf
    same = (_bits_equal(torch.from_numpy(np.ascontiguousarray(frame)),
                        torch.from_numpy(want))
            and zb.dtype == torch.float64
            and _bits_equal(zb.cpu(), torch.from_numpy(z)))
    if not same or pixels != px:
        raise AssertionError(f"debug camera: the overlay differs from its "
                             f"numpy path: frame and z-buffer equal {same}, "
                             f"line px {pixels} against {px}")
    return px


#: Interleaved orbit pairs (general, variant) per phase-5 variant, and
#: frames per orbit.
PAIRS = 5
ORBIT = 20


def _orbit_ms(scene, n_frames):
    """ms per Scene.render() over ``n_frames`` of the orbit (host clock)."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n_frames):
        scene.camera.set_position(orbit_position(2 * np.pi * i / n_frames))
        scene.render()
    return (time.perf_counter() - t0) / n_frames * 1e3


#: Phase 6's renders, (shader, (n_rows, n_tris), with the debug camera),
#: by world size: one spawn of ranks each. Frames timed per render, and
#: seconds a spawn may take before its ranks are killed.
SHARDED_RUNS = {2: (("general", (1, 2), False), ("gouraud", (1, 2), False),
                    ("pbr", (1, 2), False), ("gouraud", (1, 2), True)),
                4: (("general", (2, 2), False),)}
SHARD_FRAMES = 5
RANK_DEADLINE = 300


def one_device_ids(cfg, n_tris, chunk=8):
    """The one-device face index of each shard-major global id (-1 for the
    faces sharding pads in): ids count a shard's slice of each model in
    model order, models padded as parallel.sharded.pad_models_for_tris."""
    padded = [mc.num_faces for mc in cfg.models]
    per_shard = [(p + (-p) % (n_tris * chunk)) // n_tris if n_tris > 1
                 else p for p in padded]
    base = np.cumsum([0] + padded[:-1])
    table = [np.where(f < p, b + f, -1)
             for s in range(n_tris)
             for p, b, n in zip(padded, base, per_shard)
             for f in [s * n + np.arange(n)]]
    return np.concatenate(table)


def _merge_share(render, n_frames=2):
    """A CPU profile of ``n_frames`` renders: traced ms per frame, the host
    time of each ``tr.merge_*`` range per frame (a collective's range
    includes its wait for the slowest rank) and of the ``tr.tidpass``
    range (K7's wrapper)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter()
        for _ in range(n_frames):
            render()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3 / n_frames
    merges, tidpass = {}, 0.0
    for e in prof.events():
        ms = e.time_range.elapsed_us() / 1e3 / n_frames
        if e.name.startswith("tr.merge_"):
            key = e.name[len("tr.merge_"):]
            merges[key] = merges.get(key, 0.0) + ms
        elif e.name == "tr.tidpass":
            tidpass += ms
    return {"traced_ms": wall, "merge_ms": merges,
            "merge_share": sum(merges.values()) / wall,
            "tidpass_host_ms": tidpass}


def to_device(tree, device):
    """A copy of a packed scene's dict/list tree with every tensor moved to
    ``device``."""
    import torch

    if isinstance(tree, dict):
        return {k: to_device(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(to_device(v, device) for v in tree)
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _run_key(shader, shape, debug):
    return f"{shader}_{shape[0]}x{shape[1]}" + ("_dbg" if debug else "")


def _sharded_rank(rank, world, tmp, runs):
    """One rank of phase 6: for each run, the sharded frame through the
    kernels (launch counts reset just before it, read just after) and
    through the plain versions, then SHARD_FRAMES timed frames and a
    profile. Rank 0 saves each frame's buffers; every rank its report."""
    import datetime

    import torch
    import torch.distributed as dist

    import tpu_renderer_torch as tr
    from tpu_renderer_torch.ops import raster_cuda as rc

    torch.cuda.set_device(0)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(tmp, "store"), world),
        rank=rank, world_size=world,
        timeout=datetime.timedelta(seconds=RANK_DEADLINE))
    try:
        scene = build_flagship("cuda")
        report = {}
        for shader, (n_rows, n_tris), debug in runs:
            scene.shader = shader
            scene.debug_camera = flagship_debug_camera(tr) if debug else None
            cfg, dyn = scene._prepare()
            mesh = tr.make_render_mesh(n_tris, "cuda")
            render = lambda ops=rc.KERNELS: tr.render_frame_sharded(
                cfg, dyn, mesh, ops)
            rc.reset_launches()
            out = render()
            torch.cuda.synchronize()
            launches = dict(rc.LAUNCHES)
            plain = render(rc.PLAIN)
            differ = [n for n, a, b in zip(("frame", "zbuf", "tid",
                                            "stencil"), out, plain)
                      if not _same(a, b)]
            dist.barrier()
            t0 = time.perf_counter()
            for _ in range(SHARD_FRAMES):
                render()
            torch.cuda.synchronize()
            dist.barrier()
            ms = (time.perf_counter() - t0) / SHARD_FRAMES * 1e3
            key = _run_key(shader, (n_rows, n_tris), debug)
            report[key] = {
                "launches": launches, "ms": ms,
                "row0": mesh.get_local_rank("rows") * (cfg.resolution[0]
                                                       // n_rows),
                "plain_differs": differ, **_merge_share(render)}
            if rank == 0:
                np.savez(os.path.join(tmp, key),
                         *[t.cpu().numpy() for t in out])
        with open(os.path.join(tmp, f"rank{rank}.json"), "w") as f:
            json.dump(report, f)
    finally:
        dist.destroy_process_group()


def _spawn_ranks(world, tmp, runs):
    """Phase 6's ranks, one ``python3`` process each running
    ``_sharded_rank`` (stdout to this script's stderr). A rank that exits
    non-zero fails the phase, and so do ranks still running after
    RANK_DEADLINE seconds. Before this returns or raises, every rank still
    running is killed and every rank waited for; a rank is also killed by
    the kernel if this script dies first (PR_SET_PDEATHSIG). So no process
    of the phase outlives it."""
    here = os.path.dirname(os.path.abspath(__file__))
    code = ("import ctypes, json, signal, sys; "
            "ctypes.CDLL(None).prctl(1, signal.SIGKILL); "
            "sys.path.insert(0, sys.argv[1]); import chip_smoke; "
            "chip_smoke._sharded_rank(int(sys.argv[2]), int(sys.argv[3]), "
            "sys.argv[4], json.loads(sys.argv[5]))")
    procs = []
    deadline = time.monotonic() + RANK_DEADLINE
    try:
        for rank in range(world):
            procs.append(subprocess.Popen(
                [sys.executable, "-c", code, here, str(rank), str(world), tmp,
                 json.dumps(runs)], stdout=sys.stderr))
        while any(p.poll() is None for p in procs):
            failed = [(r, p.returncode) for r, p in enumerate(procs)
                      if p.returncode not in (None, 0)]
            if failed:
                raise AssertionError(f"{world} ranks: (rank, exit code) "
                                     f"{failed}")
            if time.monotonic() > deadline:
                raise AssertionError(f"{world} ranks still running after "
                                     f"{RANK_DEADLINE} s")
            time.sleep(0.5)
        failed = [(r, p.returncode) for r, p in enumerate(procs)
                  if p.returncode != 0]
        if failed:
            raise AssertionError(f"{world} ranks: (rank, exit code) {failed}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()


def _sharded_phase(scene, start, records):
    """Phase 6: every SHARDED_RUNS render against the one-device frame of
    ``scene`` at the camera ``start`` (with the debug camera, where the run
    has it, and no overlay: the sharded path draws none) and against its
    plain-path render; puts the SHARD_RANK rank's launches into the sharded
    modes' records."""
    import torch

    import tpu_renderer_torch as tr

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ranks_")
    try:
        for world, runs in SHARDED_RUNS.items():
            sub = os.path.join(tmp, f"world{world}")
            os.makedirs(sub)
            _spawn_ranks(world, sub, runs)
            reports = []
            for r in range(world):
                with open(os.path.join(sub, f"rank{r}.json")) as f:
                    reports.append(json.load(f))
            for shader, shape, debug in runs:
                key = _run_key(shader, shape, debug)
                saved = np.load(os.path.join(sub, f"{key}.npz"))
                frame, zbuf, tid, stencil = (saved[f"arr_{i}"]
                                             for i in range(4))
                scene.shader = shader
                scene.camera.set_position(start)
                scene.debug_camera = (flagship_debug_camera(tr) if debug
                                      else None)
                scene.debug_overlay = False
                want = scene.render()
                torch.cuda.synchronize()
                scene.debug_camera, scene.debug_overlay = None, True
                cfg, _ = scene._prepare()
                ids = one_device_ids(cfg, shape[1])
                tid = np.where(tid >= 0, ids[np.maximum(tid, 0)], -1)
                tid_match = float((tid == scene.last_tid.cpu().numpy()).mean())
                frame_match = float((frame == want).all(-1).mean())
                st_equal = np.array_equal(stencil,
                                          scene.last_stencil.cpu().numpy())
                zb_close = np.allclose(zbuf, scene.last_zbuf.cpu().numpy(),
                                       rtol=1e-6, atol=0)
                if not (tid_match >= 0.999 and frame_match >= 0.999
                        and st_equal and zb_close):
                    raise AssertionError(
                        f"sharded {key} vs one device: tid {tid_match}, "
                        f"frame {frame_match}, stencil equal {st_equal}, "
                        f"zbuf close {zb_close}")
                path = PATH_KERNELS[("sharded" if shader == "general"
                                     else "sharded_slim")
                                    + ("_dbg" if debug else "")]
                for r, rep in enumerate(reports):
                    got = rep[key]
                    if (min(got["launches"][k] for k in path) < 1
                            or got["plain_differs"]):
                        raise AssertionError(f"sharded {key}, rank {r}: {got}")
                row0s = [rep[key]["row0"] for rep in reports]
                if shape[0] > 1 and max(row0s) == 0:
                    raise AssertionError(f"sharded {key}: no rank at row0 > 0")
                lead = reports[0][key]
                if shape == SHARD_RANK[0]:
                    row_idx, tris_idx = SHARD_RANK[1]
                    launched = reports[row_idx * shape[1]
                                       + tris_idx][key]["launches"]
                    if debug:
                        for case in ("visibility_z_dbg", "tidpass_dbg"):
                            records[case]["launches"] = launched[case]
                    elif shader == "general":
                        for case, k in (("visibility_z", "visibility_z"),
                                        ("tidpass", "tidpass"),
                                        ("gbuffer_owned", "gbuffer"),
                                        ("sample_textures_owned",
                                         "sample_textures")):
                            records[case]["launches"] = launched[k]
                    else:
                        records[f"gbuffer_slim_{shader}_owned"]["launches"] = \
                            launched["gbuffer_slim"]
                merge = {k: round(v, 3) for k, v in lead["merge_ms"].items()}
                counts = [{k: rep[key]["launches"][k] for k in path}
                          for rep in reports]
                print(f"[6 sharded {key}] {world} ranks on one card: vs one "
                      f"device tid {tid_match:.6f} (ids mapped), frame "
                      f"{frame_match:.6f}, stencil equal, zbuf rtol 1e-6; frame, "
                      f"zbuf, tid and stencil equal to the plain path on "
                      f"every rank; launches per rank {counts}; "
                      f"row0 per rank {row0s}; rank 0: {lead['ms']:.2f} "
                      f"ms/frame (host clock, {SHARD_FRAMES} frames after a "
                      f"barrier), traced {lead['traced_ms']:.2f} ms/frame of "
                      f"which merges {lead['merge_share']:.3f} {merge}, "
                      f"tidpass host {lead['tidpass_host_ms']:.3f}. The "
                      f"ranks share one card and gloo stages each collective "
                      f"through host memory: not a multi-card figure.",
                      flush=True)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


#: The kernels a frame with the debug camera's overlay launches once,
#: eagerly after its replay (K11, K12).
OVERLAY_KERNELS = ("overlay", "overlay_quantize")

#: Interleaved orbit pairs (flagship, debug-camera frame) of phase 7, and
#: frames per orbit.
DEBUG_PAIRS = 3
DEBUG_ORBIT = 10


def _debug_phase(tr, scene, start, records):
    """Phase 7 (module docstring): the flagship with the debug camera and
    both gizmos; ``scene`` is the flagship without them, which it is timed
    against. Puts its K1, K10, K11 and K12 launches into the
    ``visibility_dbg``, ``vertex_dbg``, ``overlay`` and
    ``overlay_quantize`` records."""
    import torch
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.utils import profiling

    dbg = build_flagship("cuda")
    dbg.light = flagship_light(show=True)
    dbg.debug_camera = flagship_debug_camera(tr, show=True)
    profiling.reset()
    rc.reset_launches()
    frame = dbg.render()
    torch.cuda.synchronize()
    launched = {k: rc.LAUNCHES[k] for k in PATH_KERNELS["overlay"]
                + OVERLAY_KERNELS}
    if min(launched.values()) < 1 or any(launched[k] != 1
                                         for k in OVERLAY_KERNELS):
        raise AssertionError(f"debug-camera path skipped a kernel: "
                             f"{launched}")
    for key in ("visibility_dbg", "vertex_dbg") + OVERLAY_KERNELS:
        records[key]["launches"] = launched[key]
    line_px = _check_overlay(dbg, frame,
                             profiling.snapshot()["overlay"]["pixels"])
    profiling.reset()
    tid_match, frame_match, fg = _check_render(dbg, frame, debug=False)
    red = int(((frame[..., 0] == 255) & (frame[..., 1] == 0)
               & (frame[..., 2] == 0)).sum())
    if red == 0:
        raise AssertionError("debug camera: the overlay drew no red pixel")
    # The same frame without the debug camera's clip space: the mesh's
    # pixels whose winner it changes.
    cfg, dyn = dbg._prepare()
    tid0 = pl.render_core(dataclasses.replace(cfg, has_debug_camera=False),
                          dyn)[2]
    tid = dbg.last_tid
    sizes = np.cumsum([m.num_faces for m in cfg.models])
    mesh = (tid0 >= 0) & (tid0 < int(sizes[0]))
    moved = int(((tid != tid0) & mesh).sum())
    share = moved / max(int(mesh.sum()), 1)
    if share <= 0.01:
        raise AssertionError(f"debug camera: tid changed on {moved} mesh "
                             f"pixels ({share:.4f}), not more than 1%")
    # The gizmos follow the flagship's two models: the light's sphere (the
    # light stands outside the main camera's view) and the debug camera's.
    gizmo_px = [int(((tid >= lo) & (tid < hi)).sum())
                for lo, hi in zip(sizes[1:-1], sizes[2:])]
    if len(gizmo_px) != 2 or gizmo_px[1] == 0:
        raise AssertionError(f"gizmos: models {len(cfg.models)}, pixels "
                             f"{gizmo_px}")
    scene.shader, scene.skybox = "general", None
    general_ms, debug_ms = [], []
    for _ in range(DEBUG_PAIRS):
        general_ms.append(_orbit_ms(scene, DEBUG_ORBIT))
        debug_ms.append(_orbit_ms(dbg, DEBUG_ORBIT))
    diff = [d - g for g, d in zip(general_ms, debug_ms)]
    spread = lambda xs: (f"median {statistics.median(xs):.3f} "
                         f"[{min(xs):.3f}, {max(xs):.3f}]")
    prof = _profile(dbg, n_frames=3)
    lead = sorted(prof["host"].items(), key=lambda kv: -kv[1])[:3]
    print(f"[7 debug camera] launches {launched}; vs plain path tid "
          f"{tid_match:.6f}, frame {frame_match:.6f}, stencil equal; "
          f"foreground {fg:.3f}; the overlay equals its numpy path on "
          f"the same float buffers in every bit (uint8 frame, last_zbuf, "
          f"{line_px} line px); overlay red px {red}; the debug camera "
          f"moves {moved} of {int(mesh.sum())} mesh px ({share:.4f}); gizmo "
          f"px (light, camera) {gizmo_px}; Scene.render ms/frame "
          f"(compiled, host clock, {DEBUG_PAIRS} interleaved "
          f"{DEBUG_ORBIT}-frame orbit pairs): debug {spread(debug_ms)}, "
          f"general {spread(general_ms)}, debug - general {spread(diff)}; "
          f"eager profile: traced wall {prof['wall']:.2f}, device "
          f"busy {prof['busy']:.3f} ms/frame; overlay host "
          f"{prof['host'].get('overlay', 0.0):.3f} ms/frame; leading host "
          f"stages {lead}; kernels {prof['kernels']}", flush=True)

    dbg.camera.set_position(start)
    dbg.shader = "wireframe"
    rc.reset_launches()
    frame = dbg.render()
    torch.cuda.synchronize()
    launched = {k: rc.LAUNCHES[k] for k in PATH_KERNELS["wireframe_dbg"]}
    if min(launched.values()) < 1:
        raise AssertionError(f"debug-camera wireframe skipped a kernel: "
                             f"{launched}")
    tid_match, frame_match, fg = _check_render(dbg, frame, debug=True)
    print(f"[7 debug camera, wireframe] launches {launched}; vs plain path "
          f"tid {tid_match:.6f}, frame {frame_match:.6f}, stencil equal; "
          f"foreground {fg:.3f}", flush=True)


#: Interleaved orbit pairs (ss = 1, ss = 2) of phase 8, and frames per
#: orbit.
SSAA_PAIRS = 3
SSAA_ORBIT = 10
#: K1-K5 and K8 as phase 8 times them at the supersampled sizes.
SSAA_CASES = ("visibility", "gbuffer", "sample_textures", "stencil",
              "gbuffer_slim_gouraud", "quad_prep", "shade", "vertex")


def _kernel_times(scene, ss=1, cases=SSAA_CASES, lists=(), detail=False):
    """``cases`` of K1-K5 and K8-K10 (K5 in the gouraud layout; K8 also as
    ``quad_prep_fill``, its count set to 0: the zero rows alone) at the
    scene's ss-scaled size, on inputs built through the kernels (K4 on
    K8's tables and count, K9 on the frame's): {case: (wrapper ms, graph
    ms, bound ms, bound by, MB)}, for K8 also "<case> bound without zero
    rows" (ms), with ``detail`` for each case "<case> alone, plain" (its
    kernels alone in a profile and its plain version, ms), and K1's
    and K4's coarse-list scratch bytes; K3 and K8-K10 must equal their
    plain versions;
    for each case of ``lists`` (K1, K4), its coarse lists
    checked against their plain version, as (scratch bytes, longest list,
    entries, longest 16x16 bbox list) under the key "<case> lists". The
    graph ms is the kernels' device time per call from a captured graph of
    wrapper calls (``_graph_ms``): late in the script, profiles of these
    wrappers at 2048² and 4096² on the H100 came back without some kernel
    events, which a graph timed with CUDA events does not depend on."""
    import torch
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    h, w = scene.resolution[0] * ss, scene.resolution[1] * ss
    cfg, dyn = scene._prepare(resolution=(h, w))
    cam_m = pl._cam_matrices(cfg, dyn["camera"], scene.device)
    faces, attrs, _ = vertex_stage(cfg, dyn, cam_m)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    zb_sign, tid = rc.visibility(fdata, flags, h, w, cfg.system)
    adata = rc.pack_face_attrs(attrs)
    gb = rc.gbuffer(fdata, adata, tid)
    prep_args = quad_prep_args(cfg, dyn, cam_m)
    qdata, qi = rc.quad_prep(*prep_args)
    zc = _stencil_constants(dyn, scene.device)
    inputs = {
        "visibility": (fdata, flags, h, w, cfg.system),
        "gbuffer": (fdata, adata, tid),
        "sample_textures": (tid, gb[rc.GB_IU].contiguous(),
                            gb[rc.GB_IV].contiguous(),
                            *pl.texture_tables(cfg, dyn, attrs)),
        "quad_prep": prep_args,
        "quad_prep_fill": (prep_args[0], prep_args[1],
                           torch.zeros_like(prep_args[2]), *prep_args[3:]),
        "stencil": (qdata, qi, zb_sign, cfg.system, zc),
        "gbuffer_slim_gouraud": (fdata, rc.pack_slim_attrs(attrs, "gouraud"),
                                 tid, "gouraud"),
    }
    if "shade" in cases:
        inputs["shade"] = shade_inputs(cfg, dyn, rc.KERNELS)[0]
    inputs["vertex"] = vertex_args(cfg, dyn, cam_m)
    kws = {"stencil": {"n_rows": prep_args[2]}}
    del gb
    out = {}
    for case in cases:
        args, kw = inputs[case], kws.get(case, {})
        kern = getattr(rc, wrapper_of(case))
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        if wrapper_of(case) in ("quad_prep", "sample_textures", "shade",
                                "vertex_faces"):
            _compare(wrapper_of(case), got, getattr(
                rc, f"{wrapper_of(case)}_plain")(*args, **kw))
        ms = _time_ms(lambda: kern(*args, **kw))
        graph_ms = _graph_ms(lambda: kern(*args, **kw))
        bound_ms, bound_by, nbytes, _ = bound(case, args, kw, got, zb_sign)
        out[case] = (round(ms, 4), round(graph_ms, 4), round(bound_ms, 4),
                     bound_by, round(nbytes / 1e6, 2))
        if wrapper_of(case) == "quad_prep":
            out[f"{case} bound without zero rows"] = round(
                (nbytes - zero_row_bytes(args)) / PEAK_BYTES * 1e3, 5)
        if detail:
            plain = getattr(rc, f"{wrapper_of(case)}_plain")
            out[f"{case} alone, plain"] = (
                round(_alone_ms(lambda: kern(*args, **kw), wrapper_of(case)),
                      4),
                round(_time_ms(lambda: plain(*args, **kw), runs=3), 3))
        del got
    for case in lists:
        out[f"{case} lists"] = _check_coarse_bins(case, inputs[case],
                                                  kws.get(case, {}))
    scratch = {"K1": rc.bin_scratch_bytes(fdata.shape[0], h, w),
               "K4": rc.bin_scratch_bytes(qdata.shape[0], h, w)}
    return out, scratch


def _stats_check(scene):
    """Phase 8's stats() checks on the scene's last (one-device, ss = 1)
    render. Returns (stats, ms of the stats() call)."""
    import torch
    from tpu_renderer_torch.ops import pipeline as pl

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    stats = scene.stats()
    ms = (time.perf_counter() - t0) * 1e3
    cfg, dyn = scene._prepare()
    tid = scene.last_tid
    cpu = pl.face_statistics(cfg, to_device(dyn, "cpu"), tid.cpu())
    ids = torch.unique(tid[tid >= 0])
    start = 0
    for i, (mc, model, s, c) in enumerate(zip(cfg.models, scene.models,
                                              stats, cpu)):
        rest = sum(s[k] for k in ("rendered", "backface_culled",
                                  "degenerate", "offscreen",
                                  "occluded_or_clipped"))
        owned = int(((ids >= start) & (ids < start + mc.num_faces)).sum())
        differ = {k: (s[k], int(v)) for k, v in c.items() if s[k] != int(v)}
        if (s["total"] != model.num_faces or rest < s["total"] - 1
                or s["rendered"] != owned or differ):
            raise AssertionError(f"stats() of model {i}: {s}; distinct ids "
                                 f"{owned}; differ from the CPU {differ}")
        start += mc.num_faces
    return stats, ms


def _host_api_check(tr, scene):
    """The flagship mesh through utils.objwrite.write_obj, then the native
    loader (built with g++) against the Python parser; then
    utils.profiling.trace around two frames, whose summarize_device_trace
    must name K1-K4. Returns a line of results."""
    import torch
    from tpu_renderer_torch.models import native
    from tpu_renderer_torch.utils import objwrite, profiling

    mesh = scene.models[0]
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    try:
        path = os.path.join(tmp, "flagship.obj")
        fa = mesh.face_array
        objwrite.write_obj(path, mesh.vertices[:, :3], mesh.uv[:, :2],
                           mesh.normals, [[tuple(int(i) for i in c[:3])
                                           for c in f] for f in fa])
        t0 = time.perf_counter()
        if not native.native_available():
            raise AssertionError(f"native loader: {native.build_error()}")
        t1 = time.perf_counter()
        nat = tr.Model.load_model(path, use_native=True)
        t2 = time.perf_counter()
        py = tr.Model.load_model(path, use_native=False)
        t3 = time.perf_counter()
        for attr in ("vertices", "uv", "normals", "face_array"):
            a, b = getattr(nat, attr), getattr(py, attr)
            if a.dtype != b.dtype or not np.array_equal(a, b):
                raise AssertionError(f"native loader: {attr} differs from "
                                     "the Python parser")
        if not np.array_equal(nat.face_array, fa):
            raise AssertionError("written mesh: faces differ from the mesh")
        named = {}
        for how, render in (("eager", render_eager),
                            ("compiled", lambda s: s.render())):
            with profiling.trace(os.path.join(tmp, how)) as log_dir:
                for _ in range(2):
                    render(scene)
                torch.cuda.synchronize()
            summary = profiling.summarize_device_trace(log_dir)
            named[how] = sorted({m.group(1) for _, name, _ in summary
                                 for m in [_OUR_KERNEL.search(name)] if m})
            if how == "eager":
                top = [(round(ms, 4), _OUR_KERNEL.search(name).group(1), src)
                       for ms, name, src in summary
                       if _OUR_KERNEL.search(name)]
        if not {"visibility", "gbuffer", "sample",
                "stencil"} <= set(named["eager"]):
            raise AssertionError(f"device trace names {named}")
        return (f"native loader {native.LIB_PATH.rsplit(os.sep, 1)[-1]} "
                f"(g++ build and load {(t1 - t0) * 1e3:.2f} ms) equal to the "
                f"Python parser ({mesh.num_faces} faces: "
                f"{(t2 - t1) * 1e3:.2f} against {(t3 - t2) * 1e3:.2f} ms); "
                f"trace of 2 eager frames: our kernels (ms, kernel, "
                f"launching range) {top[:8]}; our kernels a trace names, by "
                f"frame kind: {named}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def _ssaa_phase(tr, scene, start):
    """Phase 8 (module docstring) on the flagship ``scene`` (general, no
    skybox, no debug camera)."""
    import torch
    from tpu_renderer_torch.ops import raster_cuda as rc

    spread = lambda xs: (f"median {statistics.median(xs):.3f} "
                         f"[{min(xs):.3f}, {max(xs):.3f}]")
    scene.shader, scene.skybox, scene.supersample = "general", None, 1
    scene.camera.set_position(start)
    frame1 = scene.render()
    stats, stats_ms = _stats_check(scene)
    shown = [{k: v for k, v in s.items() if k != "by_error"} for s in stats]
    print(f"[8 stats] {shown}; equal to face_statistics on the CPU, "
          f"rendered = distinct ids in tid; stats() {stats_ms:.2f} ms",
          flush=True)

    scene.supersample = 2
    rc.reset_launches()
    frame = scene.render()
    torch.cuda.synchronize()
    launched = {k: rc.LAUNCHES[k] for k in PATH_KERNELS["general"]}
    if min(launched.values()) < 1:
        raise AssertionError(f"ss=2 path skipped a kernel: {launched}")
    t0 = time.perf_counter()
    tid_match, frame_match, _ = _check_render(scene, frame, debug=False)
    plain_ms = (time.perf_counter() - t0) * 1e3
    u1 = len(np.unique(frame1.reshape(-1, 3), axis=0))
    u2 = len(np.unique(frame.reshape(-1, 3), axis=0))
    if u2 <= u1:
        raise AssertionError(f"ss=2: {u2} colours, not more than {u1}")
    one_ms, ss_ms = [], []
    for _ in range(SSAA_PAIRS):
        scene.supersample = 1
        one_ms.append(_orbit_ms(scene, SSAA_ORBIT))
        scene.supersample = 2
        ss_ms.append(_orbit_ms(scene, SSAA_ORBIT))
    diff = [b - a for a, b in zip(one_ms, ss_ms)]
    prof = _profile(scene, n_frames=3)
    lead = sorted(prof["host"].items(), key=lambda kv: -kv[1])[:4]
    print(f"[8 ssaa 2] {2 * RES[0]}x{2 * RES[1]} inside: launches "
          f"{launched}; vs plain path tid {tid_match:.6f}, frame "
          f"{frame_match:.6f}, stencil equal (plain path and comparison "
          f"{plain_ms:.1f} ms); "
          f"colours {u2} against {u1} at ss=1; "
          f"Scene.render ms/frame (compiled, host clock, {SSAA_PAIRS} "
          f"interleaved {SSAA_ORBIT}-frame orbit pairs): ss=2 "
          f"{spread(ss_ms)}, ss=1 {spread(one_ms)}, ss=2 - ss=1 "
          f"{spread(diff)}; eager profile: traced wall {prof['wall']:.2f}, "
          f"device busy {prof['busy']:.3f} ms/frame; ssaa host "
          f"{prof['host'].get('ssaa', 0.0):.3f}, span "
          f"{prof['device_span'].get('ssaa', 0.0):.3f} ms/frame; leading "
          f"host stages {lead}; kernels {prof['kernels']}", flush=True)

    scene.camera.set_position(start)
    scene.shader = "gouraud"
    rc.reset_launches()
    frame = scene.render()
    torch.cuda.synchronize()
    launched = {k: rc.LAUNCHES[k] for k in PATH_KERNELS["slim"]}
    if min(launched.values()) < 1:
        raise AssertionError(f"ss=2 gouraud skipped a kernel: {launched}")
    tid_match, frame_match, _ = _check_render(scene, frame, debug=False)
    print(f"[8 ssaa 2 gouraud] launches {launched}; vs plain path tid "
          f"{tid_match:.6f}, frame {frame_match:.6f}, stencil equal",
          flush=True)
    scene.shader = "general"
    # The plain path's cached blocks go back to the card first, so the
    # profiles below run with the card's memory free.
    torch.cuda.empty_cache()
    times, scratch = _kernel_times(scene, 2)
    print(f"[8 kernels ss=2] (wrapper ms, graph ms (device ms per call, "
          f"20 calls captured and replayed, CUDA events), bound ms, by, MB) "
          f"{times}; coarse-list scratch B {scratch}", flush=True)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    scene.supersample = 4
    rc.reset_launches()
    frame = scene.render()
    torch.cuda.synchronize()
    launched = {k: rc.LAUNCHES[k] for k in PATH_KERNELS["general"]}
    if min(launched.values()) < 1:
        raise AssertionError(f"ss=4 path skipped a kernel: {launched}")
    t0 = time.perf_counter()
    for _ in range(3):
        scene.render()
    torch.cuda.synchronize()
    ss4_ms = (time.perf_counter() - t0) / 3 * 1e3
    peak = torch.cuda.max_memory_allocated()
    torch.cuda.empty_cache()
    times, scratch = _kernel_times(scene, 4)
    t0 = time.perf_counter()
    tid_match, frame_match, _ = _check_render(scene, frame, debug=False)
    plain_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.empty_cache()
    print(f"[8 ssaa 4] {4 * RES[0]}x{4 * RES[1]} inside: launches "
          f"{launched}; vs plain path tid {tid_match:.6f}, frame "
          f"{frame_match:.6f}, stencil equal; {ss4_ms:.2f} ms/frame "
          f"(Scene.render, compiled, host clock, 3 frames), plain path and "
          f"comparison {plain_ms:.1f} ms; coarse-list scratch B {scratch}; "
          f"peak device memory of the kernel renders (the graph's pool "
          f"included) {peak / 2**30:.2f} GiB", flush=True)
    print(f"[8 kernels ss=4] (wrapper ms, graph ms, bound ms, by, MB) "
          f"{times}", flush=True)
    scene.supersample = 1
    scene.camera.set_position(start)
    print(f"[8 host api] {_host_api_check(tr, scene)}", flush=True)


#: Phase 9's paths, each with the PATH_KERNELS entry its frame launches:
#: Scene.render's compiled entry points on the flagship (five shaders,
#: general over the cubemap, ss = 2, and the debug camera's render_core).
COMPILED_PATHS = {"general": "general", "flat": "slim", "gouraud": "slim",
                  "pbr": "slim", "wireframe": "wireframe", "points": "slim",
                  "cubemap": "general", "ssaa2": "general",
                  "debug_core": "overlay"}
#: Frames of phase 9's orbits.
COMPILED_ORBIT = 10


def light_position(t):
    """Phase 9's light path: the flagship light's position turned by ``t``
    about the y axis."""
    return np.array([5 * np.cos(t), 5.0, 5 * np.sin(t)], dtype=np.float32)


def compiled_entries(scene, path, sky, dbg_cam):
    """Set the flagship ``scene`` up for a phase-9 path. Returns (prepare,
    compiled, eager): ``prepare()`` packs the scene (at twice its
    resolution for ss = 2); both entry points take (cfg, dyn) and return
    the four outputs."""
    from tpu_renderer_torch.ops import pipeline as pl

    debug = path in pl.DEBUG_SHADERS
    scene.shader = path if debug or path in pl.SLIM_SHADERS else "general"
    scene.skybox = sky if path == "cubemap" else None
    scene.debug_camera = dbg_cam if path == "debug_core" else None
    ss = 2 if path == "ssaa2" else 1
    h, w = scene.resolution
    prepare = lambda: scene._prepare(resolution=(h * ss, w * ss))
    if ss > 1:
        return (prepare, lambda c, d: pl.render_ssaa_jit(c, d, ss),
                lambda c, d: pl.render_ssaa(c, d, ss))
    if debug:
        return (prepare, lambda c, d: pl.render_debug_frame_jit(c, d, path),
                lambda c, d: pl.render_debug_frame(c, d, path))
    if path == "debug_core":
        return prepare, pl.render_core_jit, pl.render_core
    return prepare, pl.render_frame_jit, pl.render_frame


def _compiled_phase(tr, scene, start, sky):
    """Phase 9 (module docstring) on the flagship ``scene``, which it
    leaves as it found it (general, no skybox, no debug camera, the
    camera at ``start``)."""
    import torch
    from tpu_renderer_torch.ops import compiled
    from tpu_renderer_torch.ops import raster_cuda as rc

    mesh = scene.models[0]
    mat = mesh.materials["default"]
    verts0, kd0 = mesh.vertices, mat.map_Kd
    light0 = scene.light.position.copy()
    rng = np.random.default_rng(SEED + 9)
    kd1 = (np.round(rng.random(kd0.shape) * 255) / 255).astype(np.float32)
    moved = (mesh @ tr.translation([0.05, 0.02, 0.0])).vertices
    dbg_cam = flagship_debug_camera(tr)

    def assets(vertices, kd):
        mesh.vertices, mat.map_Kd = vertices, kd
        mesh.bump_version()

    for path, kernels in COMPILED_PATHS.items():
        assets(verts0, kd0)
        prepare, jit, eager = compiled_entries(scene, path, sky, dbg_cam)
        compiled.clear_compiled()
        builds = compiled.CACHE.builds
        for i in range(COMPILED_ORBIT + 1):
            if i < COMPILED_ORBIT:
                t = 2 * np.pi * i / COMPILED_ORBIT
                scene.camera.set_position(orbit_position(t))
                scene.light.set_position(light_position(t))
            else:
                # New vertex positions and a new diffuse map of the same
                # shape: inputs of the program, not its key.
                assets(moved, kd1)
            cfg, dyn = prepare()
            got = jit(cfg, dyn)
            want = eager(cfg, dyn)
            differ = [name for name, a, b in zip(
                ("frame", "zbuf", "tid", "stencil"), got, want)
                if not _same(a, b)]
            if differ:
                raise AssertionError(f"[9 {path}] frame {i}: the replay "
                                     f"differs from the eager frame in "
                                     f"{differ}")
        prog = compiled.CACHE.last
        captures = compiled.CACHE.builds - builds
        if captures != 1 or prog.calls != COMPILED_ORBIT + 1:
            raise AssertionError(f"[9 {path}]: {captures} captures for "
                                 f"{prog.calls} frames")
        _assert_no_sync(lambda: jit(cfg, dyn))
        rc.reset_launches()
        jit(cfg, dyn)
        torch.cuda.synchronize()
        replayed = {k: n for k, n in rc.LAUNCHES.items() if n}
        if (replayed != prog.launches
                or not all(replayed.get(k) for k in PATH_KERNELS[kernels])
                or replayed.get("quad_prep") != 1):
            raise AssertionError(f"[9 {path}]: a replay launched {replayed}, "
                                 f"its capture recorded {prog.launches}")
        print(f"[9 {path}] {COMPILED_ORBIT}-frame camera and light orbit, "
              f"then new vertices and a new diffuse map: every replay equal "
              f"to the eager frame (frame, zbuf, tid, stencil); 1 capture "
              f"for all {prog.calls} compiled frames of the path, "
              f"{prog.capture_ms:.1f} ms (warm-up and capture); graph pool "
              f"{prog.pool_bytes / 2**20:.1f} MiB; no host sync in a "
              f"replay; launches per replay {prog.launches}", flush=True)
    assets(verts0, kd0)
    scene.shader, scene.skybox, scene.debug_camera = "general", None, None
    scene.camera.set_position(start)
    scene.light.set_position(light0)
    compiled.clear_compiled()


#: Phase 10's paths: bench_torch's configurations, each with the kernels
#: its replay must launch (cfg4's models carry no texture map, so no K3).
CONFIG_KERNELS = {
    "cfg1": ("vertex", "visibility", "gbuffer_slim"),
    "cfg2-persp": ("vertex", "visibility", "gbuffer", "sample_textures"),
    "cfg2-ortho": ("vertex", "visibility", "gbuffer", "sample_textures"),
    "cfg3": ("vertex", "visibility", "gbuffer", "sample_textures"),
    "cfg3-rh-shadows": ("vertex", "visibility", "gbuffer", "sample_textures",
                        "quad_prep", "stencil"),
    "cfg4": ("vertex", "visibility", "gbuffer"),
    "cfg5-merged": PATH_KERNELS["general"],
    "cfg5-instances": PATH_KERNELS["general"],
    "cfg6": PATH_KERNELS["general"],
}
#: Frames of each configuration's orbit; the crowd's (cfg5) are fewer.
CONFIG_ORBIT = 10
CROWD_ORBIT = 5
#: K1-K4 and K8 as phase 10 times them at the crowd's shapes; K8 also with a
#: count of 0 (``quad_prep_fill``: its zero rows alone).
CROWD_CASES = ("visibility", "gbuffer", "sample_textures", "quad_prep",
               "quad_prep_fill", "stencil", "shade", "vertex")


def config_position(position, center, t):
    """``position`` turned by ``t`` radians about the vertical axis through
    ``center``: phase 10's orbit of each configuration's own camera."""
    p = np.asarray(position, np.float64) - center
    c, s = np.cos(t), np.sin(t)
    return (np.asarray(center, np.float64)
            + [c * p[0] + s * p[2], p[1], c * p[2] - s * p[0]]
            ).astype(np.float32)


def texel_pool_bytes(cfg, dyn):
    """Bytes of the scene-wide texel pool K3 gathers from
    (``pipeline.texture_tables``); 0 without a texture map."""
    from tpu_renderer_torch.ops import pipeline as pl

    device = dyn["light"]["position"].device
    cam_m = pl._cam_matrices(cfg, dyn["camera"], device)
    _, attrs, _ = vertex_stage(cfg, dyn, cam_m)
    tables = pl.texture_tables(cfg, dyn, attrs)
    return 0 if tables is None else tables[2].numel() * 4


def shadow_counts(cfg, dyn):
    """(E, the edges of the shadowing models; n_sil, the silhouette rows K8
    prepares and K4 bins; the quads that reach K4, active after clipping
    and packing), all 0 without shadows."""
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops.shadow import quad_tables

    if not cfg.shadows:
        return 0, 0, 0
    device = dyn["light"]["position"].device
    cam_m = pl._cam_matrices(cfg, dyn["camera"], device)
    tables = quad_tables(cfg, dyn, cam_m, *cfg.resolution,
                         **vertex_stage(cfg, dyn, cam_m)[2])
    if tables is None:
        return 0, 0, 0
    _, qi, n_sil = tables
    return qi.shape[0], int(n_sil), int((qi[:, 5] > 0).sum())


def shared_stacks(models):
    """{texture kind: distinct ``<kind>_stack`` tensors} over packed
    ``models`` (``dyn["models"]``): one per map when instances share their
    packing."""
    return {kind: len({id(md[f"{kind}_stack"]) for md in models
                       if f"{kind}_stack" in md})
            for kind in ("kd", "ks", "norm")}


def _config_phase(start_time):
    """Phase 10 (module docstring): bench_torch's configurations through
    the compiled Scene.render()."""
    import torch
    from tpu_renderer_torch.ops import compiled
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc

    spread = lambda xs: (f"median {statistics.median(xs):.3f} "
                         f"[{min(xs):.3f}, {max(xs):.3f}]")
    crowd = {}
    for name, kernels in CONFIG_KERNELS.items():
        t_path = time.perf_counter()
        scene = build_config(name)
        compiled.clear_compiled()
        builds = compiled.CACHE.builds
        scene.render()
        prog = compiled.CACHE.last
        start = scene.camera.position.copy()
        n_orbit = CROWD_ORBIT if name.startswith("cfg5") else CONFIG_ORBIT
        frame_ms = []
        for i in range(n_orbit):
            scene.camera.set_position(config_position(
                start, scene.camera.center, 2 * np.pi * (i + 1) / n_orbit))
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            scene.render()
            frame_ms.append((time.perf_counter() - t0) * 1e3)
        scene.camera.set_position(start)
        cfg, dyn = scene._prepare()
        _assert_no_sync(lambda: pl.render_frame_jit(cfg, dyn))
        rc.reset_launches()
        frame = scene.render()
        torch.cuda.synchronize()
        replayed = {k: n for k, n in rc.LAUNCHES.items() if n}
        if (compiled.CACHE.builds - builds != 1
                or replayed != prog.launches
                or not all(replayed.get(k) for k in kernels)
                or replayed.get("quad_prep", 0) != int(cfg.shadows)):
            raise AssertionError(
                f"[10 {name}]: {compiled.CACHE.builds - builds} captures; a "
                f"replay launched {replayed}, its capture recorded "
                f"{prog.launches}; the path needs {kernels}")
        want = pl.render_frame(cfg, dyn)
        differ = [k for k, a, b in zip(("zbuf", "tid", "stencil"), want[1:],
                                       (scene.last_zbuf, scene.last_tid,
                                        scene.last_stencil))
                  if not _same(a, b)]
        if differ or not np.array_equal(frame, want[0].cpu().numpy()):
            raise AssertionError(f"[10 {name}]: the replay differs from the "
                                 f"eager frame in {differ or ['frame']}")
        t0 = time.perf_counter()
        tid_match, frame_match, fg = _check_render(scene, frame, debug=False)
        plain_s = time.perf_counter() - t0
        replay_ms = _time_ms(prog.graph.replay)
        prof = _profile(scene, n_frames=3)
        edges, n_sil, quads = shadow_counts(cfg, dyn)
        pool = texel_pool_bytes(cfg, dyn)
        stacks = shared_stacks(dyn["models"])
        faces = sum(m.num_faces for m in scene.models)
        if cfg.shadows and int((scene.last_stencil != 0).sum()) == 0:
            raise AssertionError(f"[10 {name}]: no shadowed pixel")
        if name.startswith("cfg5"):
            # The floor is the last model; the instances come before it.
            crowd[name] = (frame, scene.last_stencil, pool,
                           shared_stacks(dyn["models"][:-1]))
        print(f"[10 {name}] {faces} faces, {len(scene.models)} models, "
              f"{cfg.resolution[0]}x{cfg.resolution[1]}, sign {cfg.system:+d}"
              f" (SYSTEM.LH -1, RH +1), culling {cfg.backface_culling}, "
              f"projection {cfg.cam_projection_type}, "
              f"{cfg.light_type.name}, shadows {cfg.shadows}: edges E "
              f"{edges}, silhouette rows n_sil {n_sil} (K8 prepares and K4 "
              f"bins these), active shadow quads {quads}; shadow_quads "
              f"{prof['stage_busy'].get('shadow_quads', 0.0)} and stencil "
              f"{prof['stage_busy'].get('stencil', 0.0)} busy ms/frame; "
              f"1 capture, {prog.capture_ms:.1f} ms "
              f"(warm-up and capture), graph pool "
              f"{prog.pool_bytes / 2**20:.1f} MiB; texel pool {pool} B, "
              f"distinct stacks {stacks}; launches per replay "
              f"{prog.launches}; no host sync in a replay; the replay equal "
              f"to the eager frame (frame, zbuf, tid, stencil); vs plain "
              f"path tid {tid_match:.6f}, frame {frame_match:.6f}, stencil "
              f"equal ({plain_s:.1f} s); foreground {fg:.3f}; Scene.render "
              f"ms/frame over a {n_orbit}-frame orbit (host clock) "
              f"{spread(frame_ms)}; the replay alone {replay_ms:.4f} ms (CUDA"
              f" events); eager profile: traced wall {prof['wall']:.2f}, "
              f"device busy {prof['busy']:.3f} ms/frame, by stage "
              f"{prof['stage_busy']}, kernels {prof['kernels']}; path "
              f"{time.perf_counter() - t_path:.1f} s", flush=True)
        if name == "cfg5-instances":
            times, scratch = _kernel_times(scene, 1, CROWD_CASES,
                                           lists=("visibility", "stencil"))
            rows = "; ".join(
                f"{case} {ms} / {g} / {b} ms ({mb} MB, by {by}), share "
                f"{b / g:.2f}, {prog.launches.get(case, 0)} per replay"
                for case, (ms, g, b, by, mb) in
                ((c, times[c]) for c in CROWD_CASES))
            rows += "; K8 bound without the zero rows: " + ", ".join(
                f"{c} {times[f'{c} bound without zero rows']} ms"
                for c in ("quad_prep", "quad_prep_fill"))
            print(f"[10 kernels crowd] {faces} faces, {cfg.resolution[0]}x"
                  f"{cfg.resolution[1]}, wrapper / "
                  f"graph / bound: {rows}; coarse lists equal plain "
                  f"(scratch B, longest, entries, longest 16x16 bbox list): "
                  f"K1 {times['visibility lists']}, K4 "
                  f"{times['stencil lists']}; scratch {scratch}", flush=True)
        del scene, prog
        compiled.clear_compiled()
    (f_m, s_m, pool_m, _), (f_i, s_i, pool_i, stacks_i) = (
        crowd["cfg5-merged"], crowd["cfg5-instances"])
    if (not np.array_equal(f_m, f_i) or not torch.equal(s_m, s_i)
            or pool_m != pool_i or max(stacks_i.values()) != 1):
        raise AssertionError(
            f"[10 cfg5]: merged and instances: frame equal "
            f"{np.array_equal(f_m, f_i)}, stencil equal "
            f"{torch.equal(s_m, s_i)}, texel pools {pool_m} and {pool_i} B, "
            f"the instances' stacks {stacks_i}")
    print(f"[10 cfg5] merged and instances: frame and stencil equal, texel "
          f"pool {pool_i} B in both, the instances' packets hold one tensor "
          f"per map {stacks_i}; phase "
          f"{time.perf_counter() - start_time:.1f} s", flush=True)


def main():
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: CUDA is not available; this script "
                         "runs on a CUDA card only")
    import tpu_renderer_torch as tr
    from tpu_renderer_torch.ops import _build
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
    # K8 keeps its polygon in registers: no stack, no spills.
    k8 = ptxas_report(_build.last_build["log"], "quad_prep_kernel")
    if k8["stack"] or k8["spill_stores"] or k8["spill_loads"]:
        raise AssertionError(f"quad_prep_kernel uses local memory: {k8}")
    blocks, groups = rc.quad_prep_grid("cuda")
    print(f"[2 K8] quad_prep_kernel ptxas {k8}; persistent grid {blocks} "
          f"blocks of 256 threads, {groups} quads at once", flush=True)
    # K3's two instances (16-byte and 4-byte accesses) keep their pixels in
    # registers too.
    k3 = {vec: ptxas_report(_build.last_build["log"],
                            f"sample_kernelILb{int(vec)}E")
          for vec in (True, False)}
    if any(r["stack"] or r["spill_stores"] or r["spill_loads"]
           for r in k3.values()):
        raise AssertionError(f"sample_kernel uses local memory: {k3}")
    print(f"[2 K3] sample_kernel ptxas: vector {k3[True]}, scalar "
          f"{k3[False]}", flush=True)
    # K9's 24 instances (16-byte or scalar accesses; light type; shadows;
    # background plane or colour) keep their pixels in registers.
    k9 = {(vec, light, shadows, sky): ptxas_report(
        _build.last_build["log"],
        f"shade_kernelILb{vec}ELi{light}ELb{shadows}ELb{sky}E")
        for vec in (1, 0) for light in (0, 1, 2) for shadows in (1, 0)
        for sky in (1, 0)}
    if any(r["stack"] or r["spill_stores"] or r["spill_loads"]
           for r in k9.values()):
        raise AssertionError(f"shade_kernel uses local memory: {k9}")
    regs = sorted({r["registers"] for r in k9.values()})
    print(f"[2 K9] shade_kernel ptxas: 24 instances, no stack or spills, "
          f"registers {regs}; point light, shadows, colour: vector "
          f"{k9[(1, 1, 1, 0)]}, scalar {k9[(0, 1, 1, 0)]}", flush=True)

    # K10's 16 instances (layout, culling, debug camera) keep each face in
    # registers.
    k10 = {(layout, cull, dbg): ptxas_report(
        _build.last_build["log"],
        f"vertex_kernelILi{layout}ELb{cull}ELb{dbg}E")
        for layout in range(4) for cull in (1, 0) for dbg in (1, 0)}
    if any(r["stack"] or r["spill_stores"] or r["spill_loads"]
           for r in k10.values()):
        raise AssertionError(f"vertex_kernel uses local memory: {k10}")
    print(f"[2 K10] vertex_kernel ptxas: 16 instances, no stack or spills, "
          f"registers {sorted({r['registers'] for r in k10.values()})}; "
          f"general, no culling, no debug camera {k10[(0, 0, 0)]}",
          flush=True)

    # 3. per kernel, at the flagship frame's shapes
    scene = build_flagship("cuda")
    start = scene.camera.position.copy()
    inputs, zb_sign = kernel_inputs(scene)
    records = {}
    for name, (args, kw) in inputs.items():
        kern = getattr(rc, wrapper_of(name))
        plain = getattr(rc, f"{wrapper_of(name)}_plain")
        got = kern(*args, **kw)
        torch.cuda.synchronize()
        ref = plain(*args, **kw)
        err, verdict = _compare(name, got, ref)
        bins = ""
        if wrapper_of(name) in ("visibility", "stencil", "tidpass",
                                "lines", "quad_prep"):
            _assert_no_sync(lambda: kern(*args, **kw))
            bins = "; no host sync"
        if wrapper_of(name) in ("visibility", "stencil", "tidpass"):
            scratch, longest, entries, fine = _check_coarse_bins(name, args,
                                                                 kw)
            bins += (f"; coarse lists equal plain, scratch {scratch} B, "
                     f"longest {longest}, entries {entries}; longest 16x16 "
                     f"bbox list {fine}")
        ms = _time_ms(lambda: kern(*args, **kw))
        alone = _alone_ms(lambda: kern(*args, **kw), wrapper_of(name))
        if wrapper_of(name) in ("quad_prep", "sample_textures", "shade",
                                "vertex_faces"):
            bins += (f"; graph {_graph_ms(lambda: kern(*args, **kw)):.4f} ms"
                     f" (device ms per call of a captured graph of 20 calls)")
        plain_ms = _time_ms(lambda: plain(*args, **kw), runs=3)
        bound_ms, bound_by, nbytes, ops = bound(name, args, kw, got, zb_sign)
        source, replaces = SOURCES[wrapper_of(name)]
        records[name] = {"name": name, "route": "cuda", "source": source,
                         "replaces": REPLACES.get(name, replaces),
                         "launches": None, "max_abs_err": err, "ms": ms,
                         "plain_ms": plain_ms, "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": None}
        if name == "shade":
            shown = {"light": args[6]["light_type"].name,
                     "shadows": args[1] is not None,
                     "models": tuple(args[5].shape)[0]}
        shown = {k: (v if not isinstance(v, torch.Tensor) else int(v)
                     if v.dim() == 0 else
                     f"({v.shape[0]}, {v.shape[1]}) debug planes")
                 for k, v in kw.items()}
        if name == "quad_prep":
            shown = {"E": args[0].shape[0], "n_sil": int(args[2])}
            bins += (f"; bound without the zero rows "
                     f"{(nbytes - zero_row_bytes(args)) / PEAK_BYTES * 1e3:.5f}"
                     f" ms")
        mode = f" {shown}" if shown else ""
        print(f"[3 kernel] {name}{mode}: {verdict}; max_abs_err {err:.3g}; "
              f"kernel {ms:.4f} ms (its wrapper, binning included), alone "
              f"{alone:.4f} ms, plain {plain_ms:.2f} ms; bound "
              f"{bound_ms:.4f} ms by {bound_by} ({nbytes / 1e6:.2f} MB, "
              f"{ops / 1e6:.2f} Mop){bins}", flush=True)
    for vector in (False, True):
        args, kw = k3_adversarial_inputs(vector=vector, device="cuda")
        got = rc.sample_textures(*args, **kw)
        torch.cuda.synchronize()
        _compare("sample_textures", got, rc.sample_textures_plain(*args, **kw))
        print(f"[3 adversarial] sample_textures-adv{'-vec' if vector else ''}"
              f" {K3_ADV_RES}, {args[3].shape[1]} kinds, gid0 {kw['gid0']}: "
              f"exact; sampled px {int((got[1] != 0).sum())} of "
              f"{got[1].numel()}", flush=True)
    for case in K9_ADV:
        args, kw = k9_adversarial_inputs(case, device="cuda")
        got = rc.shade(*args, **kw)
        torch.cuda.synchronize()
        _compare("shade", got, rc.shade_plain(*args, **kw))
        print(f"[3 adversarial] {case} {K9_ADV[case]}: exact; foreground px "
              f"{int((args[0] >= 0).sum())} of {args[0].numel()}", flush=True)
    for layout in rc.VERTEX_LAYOUTS:
        for culling in (False, True):
            for debug in (False, True):
                args, kw = k10_adversarial_inputs(layout, culling, debug,
                                                  device="cuda")
                got = rc.vertex_faces(*args, **kw)
                torch.cuda.synchronize()
                _compare("vertex", got, rc.vertex_faces_plain(*args, **kw))
                valid = int((got[1] & 1).sum())
                print(f"[3 adversarial] vertex-adv {layout}, culling "
                      f"{culling}, debug camera {debug}: exact; valid faces "
                      f"{valid} of {got[1].numel()}, non-finite fdata "
                      f"values {int((~torch.isfinite(got[0])).sum())}",
                      flush=True)
    _overlay_kernels(tr, records)
    from tpu_renderer_torch.ops import raster_plain as rp
    ppc = {case: int(((inputs[case][0][1] & rp.FLAG_PPC) > 0).sum())
           for case in ("visibility", "visibility_dbg")}
    print(f"[3 debug planes] faces on the per-pixel clip test: "
          f"{ppc['visibility_dbg']} with the debug camera, "
          f"{ppc['visibility']} without, of "
          f"{inputs['visibility'][0][0].shape[0]}", flush=True)
    del inputs

    # 4. end to end through Scene.render(): the first frame captures the
    # general program, the second replays it
    scene.render()
    rc.reset_launches()
    frame = scene.render()
    torch.cuda.synchronize()
    launches = {k: rc.LAUNCHES[k] for k in PATH_KERNELS["general"]}
    if min(launches.values()) < 1:
        raise AssertionError(f"main path skipped a kernel: {launches}")
    for name, count in launches.items():
        records[name]["launches"] = count
    tid_match, frame_match, fg = _check_render(scene, frame, debug=False)
    shadowed = int((scene.last_stencil != 0).sum().item())
    if shadowed == 0:
        raise AssertionError("degenerate frame: no shadowed pixel")
    n_frames = 20
    dt = _orbit_ms(scene, n_frames) / 1e3
    print(f"[4 e2e] {RES[0]}x{RES[1]}, {sum(m.num_faces for m in scene.models)}"
          f" faces: launches of one replay {launches}; vs plain path tid "
          f"{tid_match:.6f}, frame {frame_match:.6f}, stencil equal; "
          f"foreground {fg:.3f}, shadowed px {shadowed}; orbit "
          f"{dt * 1e3:.2f} ms/frame = {1.0 / dt:.2f} fps (Scene.render, a "
          f"replayed graph per frame, host clock, {n_frames} frames)",
          flush=True)

    print(f"[4 profile, eager entry points] {json.dumps(_profile(scene))}",
          flush=True)

    # 5. the other shaders and the cubemap background through Scene.render()
    sky = procedural_cubemap()

    def use(variant):
        scene.shader = "general" if variant == "cubemap" else variant
        scene.skybox = sky if variant == "cubemap" else None

    for shader in ("flat", "gouraud", "pbr", "wireframe", "points",
                   "cubemap"):
        scene.camera.set_position(start)
        use(shader)
        path = {"cubemap": "general", "wireframe": "wireframe"}.get(
            shader, "slim")
        debug = shader in ("wireframe", "points")
        rc.reset_launches()
        frame = scene.render()
        torch.cuda.synchronize()
        launched = {k: rc.LAUNCHES[k] for k in PATH_KERNELS[path]}
        if min(launched.values()) < 1:
            raise AssertionError(f"{shader} path skipped a kernel: "
                                 f"{launched}")
        if shader in rc.SLIM_CHANNELS:
            records[f"gbuffer_slim_{shader}"]["launches"] = \
                launched["gbuffer_slim"]
        if shader == "wireframe":
            records["lines"]["launches"] = launched["lines"]
        tid_match, frame_match, fg = _check_render(scene, frame, debug)
        extra = ""
        if shader == "wireframe":
            line = (np.clip((np.array([64, 64, 128]) / 255.0) ** 0.8, 0, 1)
                    * 255).astype(np.uint8)
            lit = int((frame == line).all(-1).sum())
            if lit == 0:
                raise AssertionError("wireframe: no line pixel lit")
            extra = f", lit px {lit}"
        if shader == "cubemap":
            bg = frame[::-1][(scene.last_tid < 0).cpu().numpy()]
            n_colors = len(np.unique(bg, axis=0))
            if n_colors < 64:
                raise AssertionError(f"cubemap: {n_colors} background colors")
            extra = f", background colors {n_colors}"
        general_ms, variant_ms = [], []
        for _ in range(PAIRS):
            use("general")
            general_ms.append(_orbit_ms(scene, ORBIT))
            use(shader)
            variant_ms.append(_orbit_ms(scene, ORBIT))
        diff = [v - g for g, v in zip(general_ms, variant_ms)]
        spread = lambda xs: (f"median {statistics.median(xs):.3f} "
                             f"[{min(xs):.3f}, {max(xs):.3f}]")
        prof = _profile(scene, n_frames=3)
        lead = sorted(prof["host"].items(), key=lambda kv: -kv[1])[:3]
        own = (f"; lines host {prof['host']['lines']:.3f} ms/frame"
               if shader == "wireframe" else "")
        print(f"[5 {shader}] launches {launched}; vs plain path tid "
              f"{tid_match:.6f}, frame {frame_match:.6f}, stencil equal; "
              f"foreground {fg:.3f}{extra}; Scene.render ms/frame "
              f"(compiled, host clock, {PAIRS} interleaved {ORBIT}-frame "
              f"orbit pairs): {shader} {spread(variant_ms)}, general "
              f"{spread(general_ms)}, {shader} - general {spread(diff)}; "
              f"eager profile: traced wall {prof['wall']:.2f}, device busy "
              f"{prof['busy']:.3f} ms/frame; leading host stages {lead}; "
              f"kernels {prof['kernels']}{own}", flush=True)

    # 6. sharded frames on meshes of ranks that share the card
    scene.skybox = None
    _sharded_phase(scene, start, records)

    # 7. the debug camera: its clip space, its frustum overlay, the gizmos
    _debug_phase(tr, scene, start, records)

    # 8. supersampling, stats() and the host API
    _ssaa_phase(tr, scene, start)

    # 9. the compiled frame: each path's program replayed against eager
    _compiled_phase(tr, scene, start, sky)

    # 10. bench_torch's configurations through the compiled frame
    del scene
    _config_phase(time.perf_counter())

    unread = [n for n, r in records.items() if not r["launches"]]
    if unread:
        raise AssertionError(f"kernels not launched on their path: {unread}")
    print(smi)
    print(json.dumps({"kernels": list(records.values())}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    sys.exit(main())
