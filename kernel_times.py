"""Time chosen kernel cases of chip_smoke.py's phase 3 on one CUDA card, at
the flagship frame's shapes: each case's wrapper (CUDA events, median of 5
after a warm-up), its kernels alone (a profile) and its device ms per call
of a captured graph of 20 calls (``chip_smoke._graph_ms``), in
``--rounds`` rounds.

    python3 kernel_times.py lines tidpass [--root DIR] [--rounds 3]
    python3 kernel_times.py sample_textures --at flagship ss2 ss4 cfg5-merged
    python3 kernel_times.py shade --at flagship ss2 ss4 cfg5-instances --detail
    python3 kernel_times.py vertex --at flagship ss2 cfg5-instances --detail
    python3 kernel_times.py --shadow cfg5-merged [--root DIR] [--rounds 3]

Cases are the keys of ``chip_smoke.kernel_inputs`` (``visibility``,
``lines``, ``tidpass``, ``vertex`` (K10), ...). ``--at SHAPE ...`` times them instead
through ``chip_smoke._kernel_times`` (phases 8 and 10: inputs built
through the kernels; wrapper ms, graph ms, bound ms and MB) at each
SHAPE: ``flagship``, ``ss2`` and ``ss4`` (the flagship at 2048² and
4096²) or any ``bench_torch.CONFIGS`` name; cases it does not build
(the sharded and debug modes) are skipped there; ``--detail`` adds each
case's kernels alone (a profile) and its plain version's ms. ``--root``
imports chip_smoke.py and tpu_renderer_torch from another checkout, e.g. a
parent commit unpacked with ``git archive``, so that two trees are
compared inside one run on the same card: run parent, change, change,
parent. Prints the card's ``name, power.limit``, then one JSON line per
case (and shape) and round.

``--shadow CONFIG`` splits the shadow body (``pipeline.render_core``'s
``shadow_quads`` stage, then K4) of bench_torch's configuration CONFIG,
or of the flagship frame (``flagship``), into its steps on the checkout
at DIR, each step's device ms per call from a
captured CUDA graph of calls timed with CUDA events
(``chip_smoke._graph_ms``): ``silhouette`` (the light-facing test,
parity and last light-facing incidence, one pass over every shadowing
model's edge tables on the vertex stage's face positions), ``extrude``
(extrude_quads, once over every edge), and over all E edges ``clip``
(frustum.clip_polygon), ``project`` (MVP, divide by w, viewport) and
``pack`` (raster_cuda.pack_quads), as the stage ran them before
silhouette compaction; ``order`` (the silhouette-first order and count)
and ``quad_prep`` (K8 on the silhouette rows); ``shadow_quads`` the whole
stage as render_core runs it; ``stencil`` K4 on the stage's tables. One
JSON line per round, with E and n_sil.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("cases", nargs="*")
    ap.add_argument("--shadow", metavar="CONFIG")
    ap.add_argument("--at", nargs="+", metavar="SHAPE")
    ap.add_argument("--root", default=os.path.dirname(os.path.abspath(
        __file__)))
    ap.add_argument("--rounds", type=int, default=3)
    ap.add_argument("--detail", action="store_true",
                    help="with --at: also each case's kernels alone (a "
                         "profile) and its plain version, ms")
    opts = ap.parse_args()
    root = os.path.abspath(opts.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("kernel_times: CUDA is not available")
    import chip_smoke as cs
    from tpu_renderer_torch.ops import raster_cuda as rc

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    if opts.shadow:
        for rnd in range(opts.rounds):
            print(json.dumps({"root": root, "config": opts.shadow,
                              "round": rnd,
                              **shadow_split(cs, opts.shadow)}), flush=True)
        return
    if opts.at:
        scenes = {at: scene_at(cs, at) for at in opts.at}
        cases = [c for c in opts.cases if c in cs.SSAA_CASES]
        for rnd in range(opts.rounds):
            for at, (scene, ss) in scenes.items():
                times, _ = cs._kernel_times(scene, ss, cases,
                                            detail=opts.detail)
                for case in cases:
                    ms, graph_ms, bound_ms, _, mb = times[case]
                    more = {}
                    if opts.detail:
                        more = dict(zip(("alone_ms", "plain_ms"),
                                        times[f"{case} alone, plain"]))
                    print(json.dumps({"root": root, "case": case, "at": at,
                                      "round": rnd, "ms": ms,
                                      "graph_ms": graph_ms,
                                      "bound_ms": bound_ms, "MB": mb,
                                      **more}), flush=True)
        return
    inputs, _ = cs.kernel_inputs(cs.build_flagship("cuda"))
    for rnd in range(opts.rounds):
        for case in opts.cases:
            args, kw = inputs[case]
            wrapper = cs.wrapper_of(case)
            call = lambda: getattr(rc, wrapper)(*args, **kw)
            print(json.dumps({"root": root, "case": case, "round": rnd,
                              "ms": cs._time_ms(call),
                              "alone_ms": cs._alone_ms(call, wrapper),
                              "graph_ms": cs._graph_ms(call)}),
                  flush=True)


def scene_at(cs, at):
    """(scene, ss) of an ``--at`` SHAPE."""
    if at in ("ss2", "ss4"):
        return cs.build_flagship("cuda"), int(at[2:])
    return (cs.build_flagship("cuda") if at == "flagship"
            else cs.build_config(at)), 1


def shadow_split(cs, config):
    """{step: device ms per call} of the shadow body of ``config`` (see the
    module docstring), with "E" and "n_sil"."""
    import torch
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import raster_cuda as rc
    from tpu_renderer_torch.ops import shadow as sh
    from tpu_renderer_torch.ops.frustum import clip_polygon
    from tpu_renderer_torch.ops.vertex import _rowvec

    scene = (cs.build_flagship("cuda") if config == "flagship"
             else cs.build_config(config))
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    light = dyn["light"]
    dev = light["position"].device
    cam_m = pl._cam_matrices(cfg, dyn["camera"], dev)
    # The one pass, on the vertex stage's stacked vertices and face
    # positions, as render_core runs it.
    faces, _, stage = cs.vertex_stage(cfg, dyn, cam_m)
    et = dyn["faces"]["edges"]

    def silhouette():
        inc_lf = (sh.light_facing(stage["world"], light["position"])
                  [et["inc_face"]] & et["inc_valid"])
        return sh._silhouette(inc_lf, et["inc_edge"], et["inc_dir"],
                              et["edge_first"], None, 0)

    sil, a_vid, b_vid = silhouette()
    extrude = lambda: sh.extrude_quads(stage["verts"], a_vid, b_vid, light,
                                       cfg.light_type)
    quad = extrude()
    e = quad.shape[0]
    padded = torch.zeros((e, sh.QUAD_PMAX, 4), device=dev)
    padded[:, :4] = quad
    fours = torch.full((e,), 4, dtype=torch.int32, device=dev)
    clipped, counts = clip_polygon(padded, fours, cam_m["frustum_planes"])

    def project():
        ndc = _rowvec(clipped, cam_m["MVP"])
        return _rowvec(ndc / ndc[..., 3:4], cam_m["viewport"])

    screen = project()
    steps = {"silhouette": silhouette, "extrude": extrude,
             "clip": lambda: clip_polygon(padded, fours,
                                          cam_m["frustum_planes"]),
             "project": project,
             "pack": lambda: rc.pack_quads(screen, counts, sil & (counts >= 3),
                                           h, w),
             "order": lambda: sh.silhouette_order(sil)}
    prep = (*sh.prepare_quads(cfg, dyn, **stage), cam_m["frustum_planes"],
            cam_m["MVP"], cam_m["viewport"], h, w)
    steps["quad_prep"] = lambda: rc.quad_prep(*prep)
    whole = lambda: sh.quad_tables(cfg, dyn, cam_m, h, w, **stage)
    qdata, qi, n = whole()
    zb, _ = rc.visibility(rc.pack_faces(faces), rc.face_flags(faces), h, w,
                          cfg.system)
    zc = torch.tensor(rc.stencil_scalars(dyn["camera"]["near"],
                                         dyn["camera"]["far"]), device=dev)
    steps["shadow_quads"] = whole
    steps["stencil"] = lambda: rc.stencil(qdata, qi, zb, cfg.system, zc,
                                          n_rows=n)
    out = {"E": e, "n_sil": int(sil.sum())}
    for name, fn in steps.items():
        out[name] = cs._graph_ms(fn, calls=10)
    return out


if __name__ == "__main__":
    main()
