"""The port's kernel wrappers (ops/raster_cuda.py), without JAX.

This file imports no JAX, so it also runs on the card's host:

    python -m pytest tests/test_torch_kernels.py -q

- on the CPU each wrapper runs its plain version (launch count stays 0) and
  a tensor on any other device than the CPU or CUDA raises;
- tile_bins lists every bbox overlap in primitive order;
- on a CUDA card (marker ``cuda``, skipped elsewhere) each kernel (K5 in
  its three layouts) is bit-identical to its plain version on the same
  tensors, and a Scene rendered on the card matches the CPU render under
  every shader;
- the same holds for the sharded modes, on the inputs of rank (1, 1) of a
  2x2 (rows, tris) mesh (``chip_smoke.shard_inputs``, at a row0 > 0): K1 z
  only, K7, the owned ranges of K2, K5 and K3, and K4;
- the same for K1 (both modes) and K7 with a debug camera's planes
  (``fdbg``): on the scene with a debug camera that cuts the mesh, on the
  sharded inputs of that scene, and on adversarial tables whose debug
  planes hold negative, NaN and infinite values (``long_debug_list``);
- and for inputs built to break K1's, K4's and K7's staged, binned design
  (``long_face_list``, ``long_quad_list``, ``long_claim_inputs``): tile
  lists longer than two staging chunks, exact z ties, faces that do not
  write z, NaN and inf depths, an all-background tile beside geometry, quad
  edges through a tile's corner pixel centre, non-finite edge
  coefficients, row0 > 0, gid0 > 0; and K6's exact scatter
  (``long_edge_list``: degenerate, axis-aligned, 45°, clipped and
  non-finite edges, endpoints one ulp from integers, depths equal to the
  z-buffer, many edges through one tile), and K3's
  (``chip_smoke.k3_adversarial_inputs``: H*W not a multiple of 4, iu off
  its 16-byte boundary, NaN, inf and out-of-range uv, 1x1 and
  non-power-of-two textures, slots past the table, indices outside the
  pool, runs of one face and a new face at every pixel, gid0 > 0) through
  both its instances; on the CPU the plain K3 samples nothing past its
  tables; on the card, the coarse lists of
  K1, K4 and K7 (csrc/bins.cu) equal ``coarse_bins_plain``, and the
  wrappers of K1, K4, K6, K7 and K8 never synchronise with the host;
- the compiled frame on the card (``PATHS``, ``path_scene``; the CPU side
  is test_torch_compiled.py): over an orbit every replay equals the eager
  frame in all four outputs, with one capture, each replay adding the
  launches its capture recorded; a replay never synchronises; K4 reads its
  depth constants through its pointer at every replay of a captured graph;
- instances of one mesh (bench_torch's crowd, small) on the card share
  their texture stacks, match the CPU and render as their merged model;
- K8 (``quad_prep``) on the card equals its plain version over all its
  table rows on the flagship, the crowd, cfg3-rh-shadows, a count of 0
  and every row prepared; K4's quad binning stops at the count even where
  active rows lie past it; a captured K8 replays with a shrinking, then
  growing count, up to a capacity past its persistent grid's group count,
  and a captured Scene.render() with a shrinking silhouette count, and
  each replay equals the plain version and the eager frame;
- K10 (``vertex_faces``) on the card equals its plain version on the
  scene's face tables, with its debug camera, and on the adversarial
  tables of ``chip_smoke.k10_adversarial_inputs`` (tests/
  test_torch_vertex_kernel.py holds it in every instance and at the
  flagship's and the crowd's sizes);
- K11 (``overlay``, in place: each call gets fresh copies of the case's
  tensors, ``IN_PLACE``) and K12 (``overlay_quantize``) on the card equal
  their plain versions on the debug-camera scene's frame (tests/
  test_torch_overlay_kernel.py holds them at 1500² and on crafted
  tables).

``build_scene`` is the shared procedural test scene: test_torch_slice.py
and test_torch_modules.py build the same scene in the JAX package.
"""
import numpy as np
import pytest
import torch

import tpu_renderer_torch as tt
from tpu_renderer_torch.models import gizmos as gz_torch
from tpu_renderer_torch.ops import raster_cuda as rc

import chip_smoke
from chip_smoke import shard_inputs

RES = (64, 128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op torch thread for the module's tests, restored after.
    The suite runs in several pytest-xdist workers at once, and a default
    of one thread per core in each oversubscribes the host: the many small
    ops of these tests then wait on spinning threads (measured on 8 cores
    and six workers: the port's heaviest test files ran up to 70 times
    slower than alone). The other port test modules import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def textures(seed=0):
    """Seeded in-memory maps: cube diffuse, cube tangent normal map, floor
    diffuse — 8-bit-quantized like images loaded from disk."""
    rng = np.random.default_rng(seed)
    q = lambda a: (np.round(a * 255) / 255).astype(np.float32)
    nm = q(rng.random((16, 16, 3))) * 2 - 1
    nm = np.asarray(nm, dtype=np.dtype(np.float32, metadata={"tangent": True}))
    return q(rng.random((16, 16, 3))), nm, q(rng.random((32, 48, 3)))


def build_scene(pkg, gizmos, resolution=RES, **scene_kw):
    """The cube-over-floor scene in either package (``pkg`` is
    tpu_renderer or tpu_renderer_torch)."""
    cube_kd, cube_nm, floor_kd = textures()
    cube = gizmos.make_cube(1.0)
    cube.shadowing = True
    cube.materials["default"].map_Kd = cube_kd
    cube.materials["default"].norm = cube_nm
    cube.normal_map_is_tangent = True
    floor = gizmos.make_floor(2.0, y=-0.6)
    floor.materials["default"].map_Kd = floor_kd
    scene = pkg.Scene(
        pkg.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60, near=0.01, far=50,
                   backface_culling=True),
        pkg.Light((3, 4, 2), light_type=pkg.Lightning.POINT_LIGHTNING,
                  ambient_strength=0.1),
        shadows=True, resolution=resolution, system=pkg.SYSTEM.LH,
        subsystem=pkg.SUBSYSTEM.OPENGL, **scene_kw)
    scene.add_model(cube)
    scene.add_model(floor)
    return scene


def small_crowd(n, device="cuda", **kw):
    """bench_torch's crowd of ``n`` instances as separate models over its
    floor, small: 96x96, 32x32 maps, 10 x 14 meshes."""
    import bench_torch

    return bench_torch.build_highpoly_scene(
        n, merged=False, resolution=(96, 96), tex=32, mesh=(10, 14),
        device=device, **kw)


#: The compiled frame's paths (pipeline.*_jit): five shaders, general over
#: a cubemap, ss = 2, and the debug camera's render_core.
PATHS = tuple(chip_smoke.COMPILED_PATHS)
SIDES = ("left", "right", "top", "bottom", "front", "back")


def sky_faces(seed=0, t=16):
    """Seeded 8-bit-quantized (t, t, 3) cubemap faces."""
    rng = np.random.default_rng(seed)
    return {s: (np.round(rng.random((t, t, 3)) * 255) / 255).astype(np.float32)
            for s in SIDES}


def path_scene(pkg, gizmos, path, skymap=None, **kw):
    """build_scene set up for one compiled path in either package: its
    shader, the cubemap ``skymap`` (the port's CubeMap of sky_faces() by
    default) for "cubemap", a debug camera (DEBUG_CAM) for "debug_core"."""
    if path in ("flat", "gouraud", "pbr", "wireframe", "points"):
        kw["shader"] = path
    if path == "cubemap":
        kw["skymap"] = skymap or tt.CubeMap(**sky_faces())
    if path == "debug_core":
        kw["debug_camera"] = pkg.Camera(**DEBUG_CAM)
    return build_scene(pkg, gizmos, **kw)


def prepared(scene, path):
    """(cfg, dyn) of ``scene`` for ``path``: ss = 2 packs at twice the
    scene's resolution."""
    if path == "ssaa2":
        h, w = scene.resolution
        return scene._prepare(resolution=(2 * h, 2 * w))
    return scene._prepare()


def eager_outputs(cfg, dyn, path):
    """A path's four outputs through the eager entry points."""
    from tpu_renderer_torch.ops import pipeline as pl

    if path == "ssaa2":
        return pl.render_ssaa(cfg, dyn, 2)
    if path in ("wireframe", "points"):
        return pl.render_debug_frame(cfg, dyn, path)
    if path == "debug_core":
        return pl.render_core(cfg, dyn)
    return pl.render_frame(cfg, dyn)


def jit_outputs(cfg, dyn, path):
    """A path's four outputs through the compiled entry points."""
    from tpu_renderer_torch.ops import pipeline as pl

    if path == "ssaa2":
        return pl.render_ssaa_jit(cfg, dyn, 2)
    if path in ("wireframe", "points"):
        return pl.render_debug_frame_jit(cfg, dyn, path)
    if path == "debug_core":
        return pl.render_core_jit(cfg, dyn)
    return pl.render_frame_jit(cfg, dyn)


# ------------------------------------------------------------- adversarial
#: Rows staged per chunk by K1 and K4 (csrc/common.cuh BLOCK).
CHUNK = rc.TILE * rc.TILE
#: The frame of the adversarial cases, and the fine tile their long lists
#: crowd (pixels [16, 32) in x and y, from row0).
ADV_RES = (48, 96)
CROWDED = (16, 32)


def _triangle_rows(p):
    """(g, 3, 2) float64 screen triangles -> their affine barycentric
    coefficients (g, 6) [av bv cv aw bw cw], v and w of pixel (c, r)."""
    x, y = p[..., 0], p[..., 1]
    d = (x[:, 1] - x[:, 0]) * (y[:, 2] - y[:, 0]) \
        - (x[:, 2] - x[:, 0]) * (y[:, 1] - y[:, 0])
    d = np.where(np.abs(d) < 1e-3, 1e-3, d)
    av, bv = (y[:, 2] - y[:, 0]) / d, -(x[:, 2] - x[:, 0]) / d
    aw, bw = -(y[:, 1] - y[:, 0]) / d, (x[:, 1] - x[:, 0]) / d
    cv = -(av * x[:, 0] + bv * y[:, 0])
    cw = -(aw * x[:, 0] + bw * y[:, 0])
    return np.stack([av, bv, cv, aw, bw, cw], 1)


def random_faces(rng, g, box, frame):
    """Seeded packed faces (pack_faces layout) for K1: g triangles around
    ``box`` = (x0, x1, y0, y1) in frame coordinates, a third with integer
    vertices (edges through pixel centres) and a quarter covering their
    whole bbox. Depths: constants from nine values (exact ties), or
    gradients, or, on 6% with a small bbox, NaN / +inf / -inf; about 30%
    do not write z, 10% are invalid, 15% take the per-pixel clip test with
    some negative planes.
    ``frame`` = (x_max, y_max) clamps the bboxes. Returns (fdata (g, 34)
    float32, flags (g,) int32) as torch tensors."""
    from tpu_renderer_torch.ops import raster_plain as rp

    x0, x1, y0, y1 = box
    p = rng.uniform([x0 - 6, y0 - 6], [x1 + 6, y1 + 6], size=(g, 3, 2))
    p = np.where(rng.random((g, 1, 1)) < 0.35, np.round(p), p)
    aff = _triangle_rows(p)
    full = rng.random(g) < 0.25
    aff[full] = [0, 0, 0.25, 0, 0, 0.25]
    z = np.zeros((g, 3))
    kind = rng.integers(0, 50, g)
    z[:, 2] = rng.choice(np.linspace(0.1, 0.9, 9), g)
    grad = kind < 20
    z[grad] = rng.uniform(-0.01, 0.01, (grad.sum(), 3))
    z[grad, 2] += 0.5
    odd_z = kind == 48
    z[odd_z, 2] = rng.choice([np.nan, np.inf, -np.inf], odd_z.sum())
    z[kind == 49, 0] = np.inf            # NaN at column 0, inf elsewhere
    lo = np.ceil(p.min(1))
    hi = np.ceil(p.max(1))
    bbox = np.stack([np.clip(lo[:, 0], 0, frame[0]),
                     np.clip(hi[:, 0], 0, frame[0]),
                     np.clip(lo[:, 1], 0, frame[1]),
                     np.clip(hi[:, 1], 0, frame[1])], 1)
    bbox[full] = [x0, x1, y0, y1]
    odd = kind >= 47
    bbox[odd, 1] = np.minimum(bbox[odd, 0] + 4, frame[0])
    bbox[odd, 3] = np.minimum(bbox[odd, 2] + 4, frame[1])
    clip = rng.uniform(0.2, 1.0, (g, 18))
    clip[rng.random((g, 18)) < 0.05] *= -1
    fdata = np.concatenate([aff, z, rng.uniform(0.5, 2.0, (g, 3)), bbox,
                            clip], 1).astype(np.float32)
    assert fdata.shape[1] == rp.F_COLS
    ppc = rng.random(g) < 0.15
    flags = ((rng.random(g) < 0.9) * rp.FLAG_VALID
             | ppc * (rp.FLAG_CLIP | rp.FLAG_PPC)
             | (rng.random(g) < 0.7) * rp.FLAG_ZWRITE)
    return torch.from_numpy(fdata), torch.from_numpy(flags.astype(np.int32))


def random_debug_planes(rng, g):
    """Seeded (g, 18) debug planes (pack_debug_planes layout) for
    ``random_faces``' tables: uniform in [0.2, 1.0], 10% negated, 1% NaN
    and 1% ±inf. Returns a float32 tensor."""
    e = rng.uniform(0.2, 1.0, (g, 18))
    e[rng.random((g, 18)) < 0.1] *= -1
    u = rng.random((g, 18))
    e[u < 0.01] = np.nan
    e[(u >= 0.01) & (u < 0.02)] = rng.choice([np.inf, -np.inf],
                                               ((u >= 0.01) & (u < 0.02)).sum())
    return torch.from_numpy(e.astype(np.float32))


def with_debug_planes(fdata, flags, seed):
    """A table's flags with 30% more faces on the per-pixel clip test, and
    seeded debug planes for it (``random_debug_planes``; a generator of its
    own, so the table itself is unchanged). Returns (flags, fdbg)."""
    from tpu_renderer_torch.ops import raster_plain as rp

    rng = np.random.default_rng(seed + 5000)
    g = fdata.shape[0]
    more = torch.from_numpy(rng.random(g) < 0.3)
    flags = torch.where(more, flags | rp.FLAG_CLIP | rp.FLAG_PPC, flags)
    return flags.contiguous(), random_debug_planes(rng, g)


def long_debug_list(seed=0, row0=0):
    """K1's adversarial table (``long_face_list``) with debug planes
    (``with_debug_planes``). Returns (fdata, flags, h, w, fdbg)."""
    fdata, flags, h, w = long_face_list(seed, row0)
    flags, fdbg = with_debug_planes(fdata, flags, seed)
    return fdata, flags, h, w, fdbg


def long_face_list(seed=0, row0=0):
    """K1's adversarial table on ADV_RES rows from ``row0``: 700 faces
    crowd one tile (a list longer than two staging chunks), 150 more spread
    over the frame. Returns (fdata, flags, h, w)."""
    rng = np.random.default_rng(seed)
    h, w = ADV_RES
    lo, hi = CROWDED
    crowd = random_faces(rng, 700, (lo, hi, row0 + lo, row0 + hi),
                         (w, row0 + h))
    spread = random_faces(rng, 150, (0, w, row0, row0 + h), (w, row0 + h))
    order = torch.from_numpy(rng.permutation(850))
    fdata = torch.cat([crowd[0], spread[0]])[order].contiguous()
    flags = torch.cat([crowd[1], spread[1]])[order].contiguous()
    return fdata, flags, h, w


def _corner_quads(corners, rng):
    """Triangles with an edge through the given pixel centres, at random
    orientations, integer vertices: the edge value there is exactly 0."""
    out = []
    for cx, cy in corners:
        for dx, dy in ((1, 1), (1, -1), (-1, 1), (-1, -1), (1, 0), (0, 1)):
            k = int(rng.integers(3, 9))
            a = (cx - k * dx, cy - k * dy)
            b = (cx + k * dx, cy + k * dy)
            side = 1 if rng.random() < 0.5 else -1
            c = (cx - side * k * dy + k * dx, cy + side * k * dx + k * dy)
            out.append([a, b, c])
    return np.asarray(out, np.float64).reshape(-1, 3, 2)


def random_quads(rng, e, box, frame_h, frame_w, corners=()):
    """Seeded clipped shadow polygons around ``box`` packed by pack_quads:
    3-8 vertices on an ellipse, a third snapped to integer and a sixth to
    half-integer positions, z in [-1, 1] on a plane; triangles with an edge
    through each of ``corners``' pixel centres; ok on 90%. Then a few
    quads' active edge coefficients are made huge, ±inf or NaN, and their
    bbox the whole frame (the bbox no longer bounds what such edges
    accept). Returns (qdata, qi) for a frame of ``frame_h`` x ``frame_w``
    pixels."""
    from tpu_renderer_torch.ops.shadow import QUAD_PMAX

    x0, x1, y0, y1 = box
    n = rng.integers(3, 9, e)
    ctr = rng.uniform([x0, y0], [x1, y1], size=(e, 2))
    rad = rng.uniform(2, 30, (e, 2))
    ang = np.sort(rng.uniform(0, 2 * np.pi, (e, QUAD_PMAX)), 1)
    xy = ctr[:, None] + rad[:, None] * np.stack([np.cos(ang), np.sin(ang)], -1)
    snap = rng.random(e)
    xy = np.where((snap < 0.33)[:, None, None], np.round(xy), xy)
    xy = np.where(((snap >= 0.33) & (snap < 0.5))[:, None, None],
                  np.round(xy * 2) / 2, xy)
    tri = _corner_quads(corners, rng)
    xy = np.concatenate([xy, np.zeros((len(tri), QUAD_PMAX, 2))])
    xy[e:, :3] = tri
    n = np.concatenate([n, np.full(len(tri), 3)])
    m = len(n)
    plane = rng.uniform(-0.01, 0.01, (m, 2))
    z = (plane[:, None, 0] * xy[..., 0] + plane[:, None, 1] * xy[..., 1]
         + rng.uniform(-0.9, 0.9, (m, 1)))
    screen = np.concatenate([xy, z[..., None], np.ones((m, QUAD_PMAX, 1))], -1)
    ok = rng.random(m) < 0.9
    from tpu_renderer_torch.ops import raster_cuda
    qdata, qi = raster_cuda.pack_quads(
        torch.from_numpy(screen.astype(np.float32)),
        torch.from_numpy(n.astype(np.int32)), torch.from_numpy(ok),
        frame_h, frame_w)
    bad = rng.choice(e, 12, replace=False)
    vals = [np.inf, -np.inf, np.nan, 3e38, -3e38]
    for i, q in enumerate(bad):
        slot = int(rng.integers(0, int(n[q])))
        col = [0, 12, 24][i % 3] + slot
        qdata[q, col] = float(vals[i % len(vals)])
        qi[q, 0:4] = torch.tensor([0, frame_w, 0, frame_h])
        qdata[q, 40:44] = qi[q, 0:4].to(torch.float32)
    return qdata, qi


def long_quad_list(seed=0, row0=0):
    """K4's adversarial inputs on ADV_RES rows from ``row0``: 800 quads
    crowd one tile (a list longer than two staging chunks), 100 more spread
    over the frame, edges through the crowded tile's and its neighbours'
    corner pixel centres; the tile left of the crowded one is all
    background, every other tile holds geometry at seeded depths and some
    background pixels. Returns (qdata, qi, zb_sign, sign, zc), zc the
    (3,) float32 depth constants (nf2, fpn, fmn)."""
    rng = np.random.default_rng(seed)
    h, w = ADV_RES
    lo, hi = CROWDED
    corners = [(x, row0 + y) for x in (lo - 1, lo, hi - 1, hi)
               for y in (lo - 1, lo, hi - 1, hi)]
    crowd = random_quads(rng, 800, (lo, hi, row0 + lo, row0 + hi),
                         row0 + h, w, corners)
    spread = random_quads(rng, 100, (0, w, row0, row0 + h), row0 + h, w)
    qdata = torch.cat([crowd[0], spread[0]]).contiguous()
    qi = torch.cat([crowd[1], spread[1]]).contiguous()
    zb = rng.uniform(0.1, 50.0, (h, w))
    zb[rng.random((h, w)) < 0.1] = np.inf
    zb[lo:hi, 0:lo] = np.inf
    return (qdata, qi, torch.from_numpy(zb.astype(np.float32)), 1,
            torch.tensor(rc.stencil_scalars(0.1, 50.0)))


#: The depth of the adversarial z-buffer's band where some edges lie at
#: exactly the buffer's depth (zbuf - z == 0: not lit).
TIE_Z = 5.0


def _near(rng, n, ints):
    """n float32 values one ulp either side of, or on, integers from
    ``ints``."""
    k = rng.choice(np.asarray(ints, np.float32), n)
    side = rng.choice([-np.inf, np.inf, 0.0], n).astype(np.float32)
    return np.where(side == 0, k, np.nextafter(k, side))


def adversarial_edges(rng, h, w, crowd=0, box=None):
    """Seeded edges (p0, p1 (E, 3) float32, x y z) that break K6's DDA
    inversion if it is not exact: zero-length; sub-pixel (0 < steps < 1);
    horizontal, vertical and 45° (|dx| == |dy|, integer and fractional
    starts); general ones with sy > 0 and sy < 0; integer endpoints and
    endpoints one ulp from integers (e.g. w - 1 + 0.99994); edges clipped at
    0 and at w, h; edges along the frame's first and last two rows and
    columns; NaN and ±inf endpoint coordinates; edges at depth TIE_Z; and
    ``crowd`` general edges through ``box`` = (x0, x1, y0, y1)."""
    def pts(n, lo=(-8, -8), hi=(w + 8, h + 8)):
        return rng.uniform(lo, hi, (n, 2))

    def run(start, d):
        return start, start + d

    groups = []
    a = pts(40)
    groups.append((a, a.copy()))                                 # zero-length
    a = pts(40, (0, 0), (w, h))
    groups.append(run(a, rng.uniform(-0.9, 0.9, (40, 2))))        # sub-pixel
    a = pts(40)
    groups.append(run(a, np.stack([rng.uniform(-60, 60, 40),
                                   np.zeros(40)], 1)))            # horizontal
    groups.append(run(pts(40), np.stack([np.zeros(40),
                                         rng.uniform(-40, 40, 40)], 1)))
    d = rng.choice([-1, 1], (40, 2)) * rng.choice([3.0, 7.25, 20.0, 31.5],
                                                  (40, 1))
    a = pts(40)
    a[:20] = np.round(a[:20])
    groups.append(run(a, d))                                      # 45°
    groups.append((pts(60), pts(60)))                             # general
    groups.append((np.round(pts(40)), np.round(pts(40))))         # integer
    near = lambda n: np.stack([_near(rng, n, range(w + 1)),
                               _near(rng, n, range(h + 1))], 1)
    groups.append((near(60), near(60)))                           # one ulp
    groups.append((pts(30, (-40, -40), (0, h + 40)),
                   pts(30, (w, -40), (w + 40, h + 40))))          # clipped
    for v, axis in ((0, 1), (1, 1), (h - 2, 1), (h - 1, 1), (0, 0), (1, 0),
                    (w - 2, 0), (w - 1, 0)):                      # frame edges
        a, b = pts(6), pts(6)
        a[:, axis] = v + rng.choice([0.0, 0.25, 0.75], 6)
        b[:, axis] = a[:, axis] + rng.choice([0.0, 0.5, -0.5], 6)
        groups.append((a, b))
    a, b = pts(30), pts(30)
    bad = np.array([np.nan, np.inf, -np.inf])
    a[np.arange(30), rng.integers(0, 2, 30)] = rng.choice(bad, 30)
    b[:10, rng.integers(0, 2)] = rng.choice(bad, 10)
    groups.append((a, b))                                         # NaN, ±inf
    n = sum(len(g[0]) for g in groups)
    if crowd:
        x0, x1, y0, y1 = box
        a = rng.uniform([x0, y0], [x1, y1], (crowd, 2))
        ang = rng.uniform(0, 2 * np.pi, crowd)
        r = rng.uniform(0, 40, (crowd, 1))
        groups.append(run(a, r * np.stack([np.cos(ang), np.sin(ang)], 1)))
    xy0 = np.concatenate([g[0] for g in groups])
    xy1 = np.concatenate([g[1] for g in groups])
    z = rng.uniform(0.0, 25.0, (len(xy0), 2))
    tie = rng.random(len(xy0)) < 0.2
    z[tie] = TIE_Z
    z[:n][rng.random(n) < 0.03] = np.nan
    p0 = np.concatenate([xy0, z[:, :1]], 1).astype(np.float32)
    p1 = np.concatenate([xy1, z[:, 1:]], 1).astype(np.float32)
    return torch.from_numpy(p0), torch.from_numpy(p1)


def edge_zbuf(rng, h, w):
    """The adversarial edges' real z-buffer: seeded depths in [1, 20], 10%
    -inf (LH background: never lit), 5% +inf, and the rows [h/2, 3h/4)
    at TIE_Z."""
    zb = rng.uniform(1.0, 20.0, (h, w))
    u = rng.random((h, w))
    zb[u < 0.1] = -np.inf
    zb[u > 0.95] = np.inf
    zb[h // 2:3 * h // 4] = TIE_Z
    return torch.from_numpy(zb.astype(np.float32))


def long_edge_list(seed=0):
    """K6's adversarial inputs on ADV_RES: ``adversarial_edges`` with 300
    more edges through the crowded tile, 10% inactive, a fifth of the
    bboxes shrunk by 0-2 px per side (the bbox test then cuts lines), and
    ``edge_zbuf``. Returns the arguments of raster_cuda.lines."""
    rng = np.random.default_rng(seed)
    h, w = ADV_RES
    lo, hi = CROWDED
    p0, p1 = adversarial_edges(rng, h, w, crowd=300, box=(lo, hi, lo, hi))
    ldata, bbox = rc.pack_lines(p0, p1, h, w)
    shrink = rng.integers(0, 3, bbox.shape) * np.array([1, -1, 1, -1])
    shrink[rng.random(len(bbox)) > 0.2] = 0
    bbox = (bbox + torch.from_numpy(shrink.astype(np.int32))).contiguous()
    active = torch.from_numpy(rng.random(len(ldata)) > 0.1)
    return ldata, bbox, active, edge_zbuf(rng, h, w), h, w


#: gid0 of the adversarial K7 case: the table is shard 1 of two of 850
#: faces.
ADV_GID0 = 850


#: A debug camera for build_scene's scene: above the cube looking down,
#: near and far tight around it, so its frustum cuts the cube's top and the
#: floor while the main camera sees the whole scene (about half of the
#: foreground pixels change hands; 19 faces need the per-pixel clip test
#: for the debug space alone).
DEBUG_CAM = dict(position=(1.0, 3.0, 1.5), center=(0, 0, 0), fovy=50,
                 near=2.4, far=3.8)


def long_claim_inputs(seed=0, row0=0):
    """K7's adversarial inputs on ADV_RES rows from ``row0``: K1's
    ``long_face_list`` claims against the MIN of its own z-buffer and
    another seeded table's, which covers the 8x8 blocks of a checkerboard
    (the merged buffer of two shards), so some pixels go to the other
    shard. Returns (fdata, flags, zb_sign, sign)."""
    fdata, flags, h, w = long_face_list(seed, row0)
    zb, _ = rc.visibility_plain(fdata, flags, h, w, -1, row0, want_tid=False)
    other = long_face_list(seed + 1000, row0)
    zo, _ = rc.visibility_plain(*other, -1, row0, want_tid=False)
    r, c = torch.meshgrid(torch.arange(h), torch.arange(w), indexing="ij")
    zo[(r // 8 + c // 8) % 2 == 0] = float("inf")
    return fdata, flags, torch.minimum(zb, zo).contiguous(), -1


#: Kernel cases: case id -> (wrapper name in raster_cuda, the LAUNCHES key
#: its launch counts under); K5 once per layout, the sharded modes, and the
#: adversarial inputs of K1 (claim, and z only at row0 > 0), K4, K6 and K7
#: (at row0 > 0, gid0 > 0) and K3 (gid0 > 0, H*W not a multiple of 4).
CASES = {"visibility": ("visibility", "visibility"),
         "gbuffer": ("gbuffer", "gbuffer"),
         "sample_textures": ("sample_textures", "sample_textures"),
         "stencil": ("stencil", "stencil"),
         "gbuffer_slim-flat": ("gbuffer_slim", "gbuffer_slim"),
         "gbuffer_slim-gouraud": ("gbuffer_slim", "gbuffer_slim"),
         "gbuffer_slim-pbr": ("gbuffer_slim", "gbuffer_slim"),
         "lines": ("lines", "lines"),
         "visibility_z-shard": ("visibility", "visibility_z"),
         "tidpass-shard": ("tidpass", "tidpass"),
         "gbuffer-owned": ("gbuffer", "gbuffer"),
         "gbuffer_slim-gouraud-owned": ("gbuffer_slim", "gbuffer_slim"),
         "gbuffer_slim-pbr-owned": ("gbuffer_slim", "gbuffer_slim"),
         "sample_textures-owned": ("sample_textures", "sample_textures"),
         "stencil-row0": ("stencil", "stencil"),
         "visibility-long": ("visibility", "visibility"),
         "visibility_z-long-row0": ("visibility", "visibility_z"),
         "stencil-long": ("stencil", "stencil"),
         "stencil-long-row0": ("stencil", "stencil"),
         "lines-long": ("lines", "lines"),
         "tidpass-long-row0": ("tidpass", "tidpass"),
         "visibility-dbg": ("visibility", "visibility_dbg"),
         "visibility_z-dbg-shard": ("visibility", "visibility_z_dbg"),
         "tidpass-dbg-shard": ("tidpass", "tidpass_dbg"),
         "visibility-dbg-long": ("visibility", "visibility_dbg"),
         "visibility_z-dbg-long-row0": ("visibility", "visibility_z_dbg"),
         "tidpass-dbg-long-row0": ("tidpass", "tidpass_dbg"),
         "quad_prep": ("quad_prep", "quad_prep"),
         "sample_textures-adv": ("sample_textures", "sample_textures"),
         "sample_textures-adv-vec": ("sample_textures", "sample_textures"),
         "shade": ("shade", "shade"),
         "shade-row0-sky": ("shade", "shade"),
         "shade-instances": ("shade", "shade"),
         **{name: ("shade", "shade") for name in chip_smoke.K9_ADV},
         "vertex": ("vertex_faces", "vertex"),
         "vertex-dbg": ("vertex_faces", "vertex_dbg"),
         "vertex-adv-pbr-cull-dbg": ("vertex_faces", "vertex_dbg"),
         "overlay": ("overlay", "overlay"),
         "overlay_quantize": ("overlay_quantize", "overlay_quantize")}

#: Cases whose wrapper writes into its arguments: each call of the case
#: takes fresh copies of its tensors.
IN_PLACE = {"overlay"}

#: K3's adversarial cases (chip_smoke.k3_adversarial_inputs): case id ->
#: ``vector`` (its scalar instance, then its vector one with a tail).
K3_ADV = {"sample_textures-adv": False, "sample_textures-adv-vec": True}

#: row0 of the adversarial ``-row0`` cases.
ADV_ROW0 = 40

#: row0 of K9's case over a cubemap: its 32 rows from there hold the
#: skybox and the floor.
K9_ROW0 = 24

#: K9's instanced case: distinct texture (scale, offset) rows planted in
#: the small crowd's models (model -> kind -> row); instances 0 and 2 keep
#: their shared rows.
K9_ROWS = {1: {"kd": (0.5, 0.25)}, 3: {"kd": (0.75, 0.125)}}


#: chip_smoke.shard_inputs' case names -> the sharded cases' ids here.
SHARD_CASES = {"visibility_z": "visibility_z-shard",
               "tidpass": "tidpass-shard",
               "gbuffer_owned": "gbuffer-owned",
               "gbuffer_slim_gouraud_owned": "gbuffer_slim-gouraud-owned",
               "gbuffer_slim_pbr_owned": "gbuffer_slim-pbr-owned",
               "sample_textures_owned": "sample_textures-owned"}


@pytest.fixture(scope="module")
def stage_inputs():
    """The kernels' inputs for the test_torch_slice scene (CPU), keyed by
    case id, as (args, kwargs)."""
    from tpu_renderer_torch.ops import pipeline as pl

    scene = build_scene(tt, gz_torch, device="cpu")
    cfg, dyn = scene._prepare()
    scene_inputs = (cfg, dyn)
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    faces, attrs, _ = chip_smoke.vertex_stage(cfg, dyn, cam_m)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    zb, tid = rc.visibility_plain(fdata, flags, h, w, cfg.system)
    adata = rc.pack_face_attrs(attrs)
    gb = rc.gbuffer_plain(fdata, adata, tid)
    prep_args = chip_smoke.quad_prep_args(cfg, dyn, cam_m)
    qdata, qi = rc.quad_prep_plain(*prep_args)
    n_sil = {"n_rows": prep_args[2]}
    zc = torch.tensor(rc.stencil_scalars(dyn["camera"]["near"],
                                         dyn["camera"]["far"]))
    inputs = {
        "visibility": (fdata, flags, h, w, cfg.system),
        "gbuffer": (fdata, adata, tid),
        "sample_textures": (tid, gb[rc.GB_IU].contiguous(),
                            gb[rc.GB_IV].contiguous(),
                            *pl.texture_tables(cfg, dyn, attrs)),
        "stencil": (qdata, qi, zb, cfg.system, zc),
        "lines": pl._wireframe_lines(
            *pl._debug_vertices(cfg, dyn, cam_m)[:3],
            torch.cat([md["pad_valid"] for md in dyn["models"]]),
            zb * cfg.system, h, w),
        "quad_prep": prep_args,
        "vertex": chip_smoke.vertex_args(cfg, dyn, cam_m),
    }
    for layout in rc.SLIM_CHANNELS:
        inputs[f"gbuffer_slim-{layout}"] = (
            fdata, rc.pack_slim_attrs(attrs, layout), tid, layout)
    inputs = {case: (args, {}) for case, args in inputs.items()}
    inputs["stencil"] = (inputs["stencil"][0], n_sil)
    shard = shard_inputs(cfg, dyn, zb, mesh=(2, 2), at=(1, 1))
    for case, args_kw in shard.items():
        inputs[SHARD_CASES[case]] = args_kw
    (_, _, zb_rows, _), kw = shard["tidpass"]
    inputs["stencil-row0"] = ((qdata, qi, zb_rows, cfg.system, zc),
                              {"row0": kw["row0"], **n_sil})
    inputs["visibility-long"] = ((*long_face_list(1), -1), {})
    inputs["visibility_z-long-row0"] = (
        (*long_face_list(2, ADV_ROW0), 1),
        {"row0": ADV_ROW0, "want_tid": False})
    inputs["stencil-long"] = (long_quad_list(3), {})
    inputs["stencil-long-row0"] = (long_quad_list(4, ADV_ROW0),
                                   {"row0": ADV_ROW0})
    inputs["lines-long"] = (long_edge_list(5), {})
    inputs["tidpass-long-row0"] = (long_claim_inputs(6, ADV_ROW0),
                                   {"row0": ADV_ROW0, "gid0": ADV_GID0})
    # With a debug camera: the scene's K1, and the sharded K1 z only and K7
    # of its 2x2 rank (1, 0), rows from 32, where the debug planes change
    # both (shard_inputs passes fdbg where the scene has a debug camera).
    scene = build_scene(tt, gz_torch, device="cpu",
                        debug_camera=tt.Camera(**DEBUG_CAM))
    cfg, dyn = scene._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    faces, _, _ = chip_smoke.vertex_stage(cfg, dyn, cam_m,
                                          pl._debug_mvp(cfg, dyn, "cpu"))
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    fdbg = rc.pack_debug_planes(faces)
    inputs["visibility-dbg"] = ((fdata, flags, h, w, cfg.system),
                                {"fdbg": fdbg})
    inputs["vertex-dbg"] = (chip_smoke.vertex_args(
        cfg, dyn, cam_m, pl._debug_mvp(cfg, dyn, "cpu")), {})
    inputs["vertex-adv-pbr-cull-dbg"] = chip_smoke.k10_adversarial_inputs(
        "pbr", culling=True, debug=True)
    zb, _ = rc.visibility_plain(fdata, flags, h, w, cfg.system, fdbg=fdbg)
    shard = shard_inputs(cfg, dyn, zb, mesh=(2, 2), at=(1, 0))
    inputs["visibility_z-dbg-shard"] = shard["visibility_z"]
    inputs["tidpass-dbg-shard"] = shard["tidpass"]
    fdata, flags, h, w, fdbg = long_debug_list(10)
    inputs["visibility-dbg-long"] = ((fdata, flags, h, w, -1),
                                     {"fdbg": fdbg})
    fdata, flags, h, w, fdbg = long_debug_list(11, ADV_ROW0)
    inputs["visibility_z-dbg-long-row0"] = (
        (fdata, flags, h, w, 1),
        {"row0": ADV_ROW0, "want_tid": False, "fdbg": fdbg})
    fdata, flags, zb, sign = long_claim_inputs(12, ADV_ROW0)
    flags, fdbg = with_debug_planes(fdata, flags, 12)
    inputs["tidpass-dbg-long-row0"] = (
        (fdata, flags, zb, sign),
        {"row0": ADV_ROW0, "gid0": ADV_GID0, "fdbg": fdbg})
    for name, vector in K3_ADV.items():
        inputs[name] = chip_smoke.k3_adversarial_inputs(vector=vector)
    # K9: the scene's frame; 32 rows from K9_ROW0 of the scene over a
    # cubemap (its skybox plane at row0 > 0); three instances and the floor
    # with distinct (scale, offset) rows; the adversarial frames.
    inputs["shade"] = chip_smoke.shade_inputs(*scene_inputs)
    sky = path_scene(tt, gz_torch, "cubemap", device="cpu")
    inputs["shade-row0-sky"] = chip_smoke.shade_inputs(
        *sky._prepare(), local_height=32, row0=K9_ROW0)
    cfg, dyn = small_crowd(3, device="cpu")._prepare()
    for m, rows in K9_ROWS.items():
        for kind, row in rows.items():
            dyn["models"][m][f"{kind}_scale_off"] = torch.tensor(row)
    inputs["shade-instances"] = chip_smoke.shade_inputs(cfg, dyn)
    for name in chip_smoke.K9_ADV:
        inputs[name] = chip_smoke.k9_adversarial_inputs(name)
    inputs.update(overlay_inputs())
    return inputs


def overlay_inputs():
    """K11's and K12's cases on the debug-camera scene: its float frame and
    z-buffer in float64, its frustum's segment table (on the host, where
    the wrapper takes it), a pixel counter."""
    from tpu_renderer_torch.ops import overlay as ov
    from tpu_renderer_torch.ops import pipeline as pl

    scene = build_scene(tt, gz_torch, device="cpu",
                        debug_camera=tt.Camera(**DEBUG_CAM))
    cfg, dyn = scene._prepare()
    frame, zbuf = (t.double() for t in pl.render_core(cfg, dyn)[:2])
    table = torch.from_numpy(ov.frustum_segments(
        scene.camera._matrices(torch.float64),
        scene.debug_camera._matrices(torch.float64), scene.camera.position,
        scene.camera.near, scene.camera.far, scene.resolution))
    counter = torch.zeros(1, dtype=torch.int64)
    return {"overlay": ((table, frame, zbuf, cfg.system, counter), {}),
            "overlay_quantize": ((frame,), {})}


def _fresh(name, args, kw):
    """The case's arguments for one call: copies of its tensors where the
    wrapper writes into them (IN_PLACE)."""
    if name not in IN_PLACE:
        return args, kw
    return tuple(a.clone() if isinstance(a, torch.Tensor) else a
                 for a in args), kw


def _moved(args, kw, device):
    """A case's tensors, positional and keyword (and those of a dict
    argument, as K9's light), on ``device``."""
    def to(a):
        if isinstance(a, dict):
            return {k: to(v) for k, v in a.items()}
        return a.to(device) if isinstance(a, torch.Tensor) else a
    return tuple(to(a) for a in args), {k: to(v) for k, v in kw.items()}


def _equal(a, b):
    """Equal values, NaN where the other is NaN (K8's tables hold NaN
    depth planes for quads that clipping emptied, as pack_quads' do)."""
    return chip_smoke._same(a, b)


def test_cases_cover_every_wrapper():
    assert {key for _, key in CASES.values()} == set(rc.LAUNCHES)


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_on_cpu_runs_plain_version(stage_inputs, name):
    rc.reset_launches()
    fn, key = CASES[name]
    got = getattr(rc, fn)(*_fresh(name, *stage_inputs[name])[0],
                          **stage_inputs[name][1])
    args, kw = _fresh(name, *stage_inputs[name])
    want = getattr(rc, f"{fn}_plain")(*args, **kw)
    assert _equal(got, want)
    assert rc.LAUNCHES[key] == 0


@pytest.mark.parametrize("name", list(CASES))
def test_wrapper_refuses_other_devices(stage_inputs, name):
    """No silent path: tensors on a device that is neither the CPU nor CUDA
    (here PyTorch's shape-only 'meta' device) raise."""
    args, kw = _moved(*stage_inputs[name], "meta")
    with pytest.raises(RuntimeError):
        getattr(rc, CASES[name][0])(*args, **kw)


def test_stage_inputs_are_not_degenerate(stage_inputs):
    """The slim G-buffers carry foreground, the wireframe lights pixels
    of the scene (edges of faces behind the visible surface pass the LH
    z test), and the overlay's case draws line pixels."""
    for layout in rc.SLIM_CHANNELS:
        gb = rc.gbuffer_slim(*stage_inputs[f"gbuffer_slim-{layout}"][0])
        assert gb.shape == (rc.SLIM_CHANNELS[layout], *RES)
        assert (gb != 0).any()
    assert rc.lines(*stage_inputs["lines"][0]).sum() > 0
    # The debug camera's frustum crosses the frame: K11's case draws.
    args, _ = _fresh("overlay", *stage_inputs["overlay"])
    assert len(args[0]) > 10 and int(rc.overlay(*args)[2]) > 100


def test_shard_inputs_are_not_degenerate(stage_inputs):
    """The sharded cases' shard owns some foreground of its block of rows,
    the other shard owns some too, its owned planes are zero elsewhere, and
    its quads shadow some of its rows."""
    call = lambda name, fn: fn(*stage_inputs[name][0], **stage_inputs[name][1])
    (fdata, _, tid), kw = stage_inputs["gbuffer-owned"]
    own = (tid >= kw["gid0"]) & (tid < kw["gid0"] + fdata.shape[0])
    assert kw["row0"] > 0 and kw["gid0"] > 0
    assert own.any() and ((tid >= 0) & ~own).any()
    gb = call("gbuffer-owned", rc.gbuffer)
    assert (gb[:, own] != 0).any() and (gb[:, ~own] == 0).all()
    samp, mask = call("sample_textures-owned", rc.sample_textures)
    assert (mask[own] != 0).any() and (mask[~own] == 0).all()
    assert (call("stencil-row0", rc.stencil) != 0).any()


def test_adversarial_inputs_are_not_degenerate(stage_inputs):
    """The crowded tile's lists are longer than two staging chunks, its
    faces tie in z and claim pixels, and the quads shadow some pixels of
    it while the all-background tile stays 0; more than a chunk's worth of
    edges cross it and light some of its pixels; K7's table claims many
    ids there, all from gid0 on, and leaves pixels with geometry to the
    other table."""
    from tpu_renderer_torch.ops import raster_plain as rp

    lo, hi = CROWDED
    t = (lo // rc.TILE) * (ADV_RES[1] // rc.TILE) + lo // rc.TILE
    for name in ("visibility-long", "visibility_z-long-row0"):
        (fdata, flags, h, w, _), kw = stage_inputs[name]
        off, _ = rc.tile_bins(fdata[:, rp.F_BBOX:rp.F_BBOX + 4].int(),
                              (flags & rp.FLAG_VALID) > 0, h, w,
                              row0=kw.get("row0", 0))
        assert off[t + 1] - off[t] > 2 * CHUNK
    zb, tid = rc.visibility(*stage_inputs["visibility-long"][0])
    assert len(torch.unique(tid[lo:hi, lo:hi])) > 8
    assert (tid >= 0).float().mean() > 0.5
    for name in ("stencil-long", "stencil-long-row0"):
        (qdata, qi, zb, *_), kw = stage_inputs[name]
        off, _ = rc.tile_bins(qi[:, 0:4], qi[:, 5] > 0, *ADV_RES,
                              row0=kw.get("row0", 0))
        assert off[t + 1] - off[t] > 2 * CHUNK
        st = rc.stencil(*stage_inputs[name][0], **kw)
        assert (st[lo:hi, lo:hi] != 0).any()
        assert (zb[lo:hi, :lo] >= 3e38).all() and (st[lo:hi, :lo] == 0).all()
    (ldata, bbox, active, zbuf, h, w), _ = stage_inputs["lines-long"]
    off, _ = rc.tile_bins(bbox, active, h, w)
    assert off[t + 1] - off[t] > CHUNK
    mask = rc.lines(ldata, bbox, active, zbuf, h, w)
    assert mask[lo:hi, lo:hi].any() and not mask[lo:hi, lo:hi].all()
    (fdata, flags, zb, sign), kw = stage_inputs["tidpass-long-row0"]
    off, _ = rc.tile_bins(fdata[:, rp.F_BBOX:rp.F_BBOX + 4].int(),
                          (flags & rp.FLAG_VALID) > 0, *ADV_RES,
                          row0=kw["row0"])
    assert off[t + 1] - off[t] > 2 * CHUNK
    tid = rc.tidpass(fdata, flags, zb, sign, **kw)
    won = tid[lo:hi, lo:hi]
    assert len(torch.unique(won[won >= 0])) > 8
    assert (tid[tid >= 0] >= kw["gid0"]).all()
    assert ((tid < 0) & (zb < 3e38)).any()       # the other table's pixels


def test_k3_adversarial_inputs_are_not_degenerate(stage_inputs):
    """K3's adversarial cases reach every branch: H*W three past a multiple
    of 4, the tail owned and sampled; iu off its 16-byte boundary (the
    scalar instance) or every plane on it (the vector one); samples at NaN,
    ±inf, negative and above-1 uv; the 1x1 texture and one of no power-of-
    two size sampled; owned pixels whose slot is -1 or past the table, or
    whose index falls past the pool or below 0; groups of 4 won by one
    face and groups of 4 faces; other shards' winners and background."""
    n_tex = len(chip_smoke.K3_ADV_TEXTURES)
    for name, vector in K3_ADV.items():
        args, kw = stage_inputs[name]
        tid, iu, iv, ftex, slots, pool = args
        gid0 = kw["gid0"]
        assert tid.numel() % 4 == 3
        if vector:
            assert ftex.shape[1] == 1
            assert all(t.data_ptr() % 16 == 0 for t in (tid, iu, iv))
        else:
            assert iu.data_ptr() % 16 != 0
        samp, mask = rc.sample_textures(*args, **kw)
        own = (tid >= gid0) & (tid < gid0 + ftex.shape[0])
        assert ((tid >= 0) & ~own).any() and (tid < 0).any()
        assert (mask.reshape(-1)[-3:] & 1).all()
        sampled = mask != 0
        for plane in (iu, iv):
            for at in (plane.isnan(), plane == float("inf"),
                       plane == float("-inf"), plane < 0, plane > 1):
                assert (sampled & at).any()
        face = torch.where(own, tid - gid0, 0).long()
        slot = ftex[face, :, 0].permute(2, 0, 1)           # (kinds, H, W)
        hit = ((mask[None] >> torch.arange(ftex.shape[1])[:, None, None])
               & 1) > 0
        for s in (0, 5):                    # 1x1 and 37x100
            assert (hit & (slot == s)).any()
        for at in (slot == -1, slot >= slots.shape[0], slot == n_tex,
                   slot == n_tex + 1):
            assert (own & at & ~hit).any()
        groups = torch.where(own, tid, -1).reshape(-1)[:tid.numel() // 4
                                                        * 4].reshape(-1, 4)
        whole = (groups >= 0).all(1)
        assert (whole & (groups == groups[:, :1]).all(1)).any()
        distinct = (groups.sort(1).values.diff(dim=1) != 0).all(1)
        assert (whole & distinct).any()


def test_k3_plain_skips_slots_and_indices_out_of_range():
    """K3's plain version samples nothing where a slot lies past the slot
    table or an index past or before the pool, as the kernel does (it
    used to index past both and raise)."""
    tid = torch.tensor([[0, 1, 2, -1]], dtype=torch.int32)
    uv = torch.full((1, 4), 0.5)
    pool = torch.arange(100, 112, dtype=torch.int32)       # one 3x4 texture
    slots = torch.tensor([[0, 4], [10, 4], [-20, 4]], dtype=torch.int32)
    # Per face and kind (slot, TH, TW): slot 3 is past the table; slot 1's
    # index (10 + 1*4 + 1) past the pool, slot 2's (-20 + 5) before it.
    ftex = torch.tensor([[[0, 3, 4], [3, 3, 4], [1, 3, 4]],
                         [[2, 3, 4], [-1, 3, 4], [0, 3, 4]],
                         [[0, 3, 4], [0, 3, 4], [0, 3, 4]]],
                        dtype=torch.int32)
    samp, mask = rc.sample_textures(tid, uv, uv, ftex, slots, pool)
    assert mask.tolist() == [[1, 4, 7, 0]]
    assert samp[:, 0].tolist() == [[105, 0, 105, 0], [0, 0, 105, 0],
                                   [0, 105, 105, 0]]


def test_shade_inputs_are_not_degenerate(stage_inputs):
    """K9's cases reach every branch: each light type, shadows on (some
    pixels shadowed) and off, a colour and a skybox plane, background
    and foreground pixels; every kind's sample taken, normal maps in
    tangent and object space, models without maps, three or more distinct
    (scale, offset) rows with instances sharing theirs, model ids that
    name no row, frames whose H*W is not a multiple of 4, and a frame
    without maps."""
    from tpu_renderer_torch.ops.lightning import Lightning

    names = [n for n, (fn, _) in CASES.items() if fn == "shade"]
    seen = {"lights": set(), "shadows": set(), "sky": set(), "odd": False,
            "nomaps": False, "tangent": set(), "unknown": False,
            "kinds": set()}
    for name in names:
        (tid, stencil, gb, samp, mask, so, light, _, bg), _ = \
            stage_inputs[name]
        fg = tid >= 0
        assert fg.any() and (~fg).any(), name
        seen["lights"].add(light["light_type"])
        seen["shadows"].add(stencil is not None)
        if stencil is not None:
            assert (fg & (stencil != 0)).any(), name
        seen["sky"].add(bg.dim() == 3)
        seen["odd"] |= tid.numel() % 4 != 0
        if samp is None:
            seen["nomaps"] = True
            continue
        model = gb[rc.GB_MODEL]
        known = (model == model.round()) & (model >= 0) & (
            model < so.shape[0])
        seen["unknown"] |= bool((fg & ~known).any())
        for k in range(rc.N_KINDS):
            if (fg & known & ((mask >> k) & 1 > 0)).any():
                seen["kinds"].add(k)
        normal_map = fg & known & ((mask >> 1) & 1 > 0)
        for flag in (True, False):
            if (normal_map & ((gb[rc.GB_NORM_SLOT + 3] > 0.5) == flag)).any():
                seen["tangent"].add(flag)
        rows = {tuple(r.tolist()) for r in so.reshape(so.shape[0], -1)}
        if name in ("shade-instances", "shade-adv-directional"):
            assert len(rows) >= 3 and len(rows) < so.shape[0], name
        assert (so == 0).all(2).any() or name == "shade-instances", name
    assert seen["lights"] == set(Lightning)
    assert seen["shadows"] == {True, False} and seen["sky"] == {True, False}
    assert seen["odd"] and seen["nomaps"] and seen["unknown"]
    assert seen["tangent"] == {True, False}
    assert seen["kinds"] == set(range(rc.N_KINDS))


def _frozen_shade_loops(cfg, dyn, tid, stencil, gb, samp, samp_mask,
                        camera_position, background):
    """The port's deferred shade before K9, frozen: pipeline._shade_gbuffer
    with its three loops over the models (one pass per model and map
    kind), then shading.shade_general."""
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops import shading as sh
    from tpu_renderer_torch.ops.transforms import normalize

    def unpack(packed, scale_off):
        r = (packed & 0xFF).to(torch.float32)
        g = ((packed >> 8) & 0xFF).to(torch.float32)
        b = ((packed >> 16) & 0xFF).to(torch.float32)
        rgb = torch.stack([r, g, b], dim=-1) / 255.0
        return rgb * scale_off[0] + scale_off[1]

    bg = tid < 0
    vec = lambda c: torch.movedim(gb[c:c + 3], 0, -1)
    frag_world = vec(rc.GB_WORLD)
    model_id = gb[rc.GB_MODEL]

    def sampled(m, md, kind):
        k = rc.KINDS.index(kind)
        rgb = unpack(samp[k], md[f"{kind}_scale_off"])
        return rgb, (model_id == m) & (((samp_mask >> k) & 1) > 0)

    color = vec(rc.GB_KD)
    for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        if mc.has_map_kd:
            rgb, mask = sampled(m, md, "kd")
            color = torch.where(mask[..., None], rgb, color)

    n_base = normalize(vec(rc.GB_N))
    normal = n_base
    for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        if not mc.has_norm:
            continue
        s, mask = sampled(m, md, "norm")
        tangent_n = (normalize(vec(rc.GB_TAN)) * s[..., 0:1] +
                     normalize(vec(rc.GB_BIT)) * s[..., 1:2] +
                     n_base * s[..., 2:3])
        is_tangent = gb[rc.GB_NORM_SLOT + 3] > 0.5
        mapped = torch.where(is_tangent[..., None], tangent_n, s)
        normal = torch.where(mask[..., None], normalize(mapped), normal)

    specular_light = vec(rc.GB_KS) * 255.0
    for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        if mc.has_map_ks:
            rgb, mask = sampled(m, md, "ks")
            specular_light = torch.where(mask[..., None],
                                         rgb[..., 0:1] * 255.0,
                                         specular_light)

    pix = {"color": color, "normal": normal, "frag_world": frag_world,
           "specular_light": specular_light, "ns": gb[rc.GB_NS][..., None]}
    rgb = sh.shade_general(pix, pl._light(cfg, dyn), camera_position,
                           shadows_mask=(stencil != 0) if cfg.shadows
                           else None)
    return torch.where(bg[..., None], background, rgb)


@pytest.mark.parametrize("seed", [1, 2])
def test_shade_plain_equals_the_per_model_loops(seed):
    """shade_plain, the table form, gives the frozen per-model loops'
    frame bit for bit on a 21-model stand-in of the crowd (20 instances of
    one mesh over the floor, small) and on the same frame with each
    instance's diffuse (scale, offset) its own."""
    cfg, dyn = small_crowd(20, device="cpu", seed=seed)._prepare()
    assert len(cfg.models) == 21
    for distinct in (False, True):
        if distinct:
            for m in range(20):
                dyn["models"][m]["kd_scale_off"] = torch.tensor(
                    [1.0 - m / 64, m / 128])
        (tid, stencil, gb, samp, mask, so, light, position, bg), _ = \
            chip_smoke.shade_inputs(cfg, dyn)
        assert samp is not None and (tid >= 0).float().mean() > 0.1
        for k in range(rc.N_KINDS - 1):         # the crowd has no ks map
            assert ((mask >> k) & 1).sum() > 100
        got = rc.shade_plain(tid, stencil, gb, samp, mask, so, light,
                             position, bg)
        want = _frozen_shade_loops(cfg, dyn, tid, stencil, gb, samp, mask,
                                   position,
                                   bg.expand(*tid.shape, 3))
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


def test_debug_inputs_are_not_degenerate(stage_inputs):
    """The debug planes change what K1 and K7 see: on the scene, the
    sharded rank and the adversarial tables, some pixel's z or winner
    differs from the same call without them; on the scene the debug space
    alone puts some faces on the per-pixel clip test."""
    from tpu_renderer_torch.ops import raster_plain as rp

    for name in ("visibility-dbg", "visibility_z-dbg-shard",
                 "tidpass-dbg-shard", "visibility-dbg-long",
                 "visibility_z-dbg-long-row0", "tidpass-dbg-long-row0"):
        args, kw = stage_inputs[name]
        fn = getattr(rc, CASES[name][0])
        plain = dict(kw)
        plain.pop("fdbg")
        got, without = fn(*args, **kw), fn(*args, **plain)
        if isinstance(got, tuple):
            got, without = got[1] if got[1] is not None else got[0], \
                without[1] if without[1] is not None else without[0]
        assert not torch.equal(got, without), name
    (fdata, flags, *_), _ = stage_inputs["visibility-dbg"]
    assert (flags & rp.FLAG_PPC).any()
    assert (stage_inputs["visibility-dbg"][1]["fdbg"] <= 0).any()


def test_tile_bins_list_every_overlap_in_order():
    rng = np.random.default_rng(3)
    x0 = rng.integers(0, 60, 200)
    y0 = rng.integers(0, 40, 200)
    bbox = np.stack([x0, x0 + rng.integers(0, 20, 200),
                     y0, y0 + rng.integers(0, 20, 200)], 1)
    active = rng.random(200) > 0.2
    off, items = rc.tile_bins(torch.from_numpy(bbox), torch.from_numpy(active),
                              40, 60, tile=16)
    off, items = off.numpy(), items.numpy()
    n_tx = 4
    for t in range(len(off) - 1):
        ty, tx = divmod(t, n_tx)
        want = [i for i in range(200) if active[i]
                and bbox[i, 0] < (tx + 1) * 16 and bbox[i, 1] > tx * 16
                and bbox[i, 2] < (ty + 1) * 16 and bbox[i, 3] > ty * 16]
        assert items[off[t]:off[t + 1]].tolist() == want


# ------------------------------------------------------------- on the card

@pytest.fixture
def cuda_inputs(stage_inputs):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    moved = {name: _moved(args, kw, "cuda")
             for name, (args, kw) in stage_inputs.items()}
    # Moving a view copies it: K3's adversarial planes are built on the
    # card, so that iu stays off its 16-byte boundary there too.
    for name, vector in K3_ADV.items():
        moved[name] = chip_smoke.k3_adversarial_inputs(vector=vector,
                                                       device="cuda")
    # K11 takes its segment table on the host.
    (table, *rest), kw = moved["overlay"]
    moved["overlay"] = ((table.cpu(), *rest), kw)
    return moved


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(CASES))
def test_kernel_matches_plain_on_card(cuda_inputs, name):
    """The hand-written kernel against its plain version on the same CUDA
    tensors: bit-identical (both round op by op)."""
    rc.reset_launches()
    fn, key = CASES[name]
    args, kw = _fresh(name, *cuda_inputs[name])
    got = getattr(rc, fn)(*args, **kw)
    torch.cuda.synchronize()
    assert rc.LAUNCHES[key] == 1
    args, kw = _fresh(name, *cuda_inputs[name])
    want = getattr(rc, f"{fn}_plain")(*args, **kw)
    assert _equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["visibility-long", "visibility_z-long-row0",
                                  "stencil-long", "stencil-long-row0",
                                  "visibility", "stencil", "tidpass-shard",
                                  "tidpass-long-row0", "visibility-dbg",
                                  "tidpass-dbg-long-row0"])
def test_coarse_bins_match_plain_on_card(cuda_inputs, name):
    """csrc/bins.cu's coarse lists (K1's and K7's faces, K4's quads) list
    exactly coarse_bins_plain's primitives, in table order."""
    args, kw = cuda_inputs[name]
    chip_smoke._check_coarse_bins(CASES[name][0], args, kw)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["visibility", "visibility-long",
                                  "visibility_z-shard", "stencil",
                                  "stencil-row0", "stencil-long", "lines",
                                  "lines-long", "tidpass-shard",
                                  "tidpass-long-row0", "visibility-dbg",
                                  "visibility_z-dbg-shard",
                                  "tidpass-dbg-shard",
                                  "visibility-dbg-long",
                                  "visibility_z-dbg-long-row0",
                                  "tidpass-dbg-long-row0", "quad_prep"])
def test_binned_wrappers_do_not_sync_on_card(cuda_inputs, name):
    """The wrappers of K1, K4, K6, K7 and K8 never wait for the device:
    they run under torch's sync debug mode "error", which raises on
    tile_bins' nonzero (K4 and K8 read the silhouette count on the
    card)."""
    args, kw = cuda_inputs[name]
    fn = getattr(rc, CASES[name][0])
    chip_smoke._assert_no_sync(lambda: fn(*args, **kw))


@pytest.mark.cuda
def test_render_on_card_matches_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    frame_gpu = build_scene(tt, gz_torch, device="cuda").render()
    frame_cpu = build_scene(tt, gz_torch, device="cpu").render()
    assert frame_gpu.shape == (*RES, 3)
    assert (frame_gpu == frame_cpu).all(-1).mean() >= 0.999


@pytest.mark.cuda
@pytest.mark.parametrize("shader", ["flat", "gouraud", "pbr", "wireframe",
                                    "points"])
def test_shader_render_on_card_matches_cpu(shader):
    """Every shader on the card (Scene's default device) against the CPU.
    A first frame of its key launches each kernel twice: once in the
    program's warm-up, once in its first replay."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    from tpu_renderer_torch.ops import compiled

    compiled.clear_compiled()
    rc.reset_launches()
    scene = build_scene(tt, gz_torch, shader=shader)
    assert scene.device.type == "cuda"
    frame_gpu = scene.render()
    assert rc.LAUNCHES["gbuffer_slim"] == 2
    assert rc.LAUNCHES["lines"] == (2 if shader == "wireframe" else 0)
    frame_cpu = build_scene(tt, gz_torch, shader=shader, device="cpu").render()
    assert (frame_gpu == frame_cpu).all(-1).mean() >= 0.999


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")


@pytest.mark.cuda
@pytest.mark.parametrize("shader", ["general", "gouraud"])
def test_ssaa_render_on_card_matches_cpu(card, shader):
    """Scene(supersample=2) on the card through K1-K4 (K5 for gouraud) at
    twice the resolution, against the CPU: tid >= 99.9%, stencil equal,
    frame >= 99.9% (tests/test_torch_ssaa_stats.py holds the CPU frame to
    the JAX package). The first frame of its key launches each kernel in
    the warm-up and in the first replay."""
    from tpu_renderer_torch.ops import compiled

    compiled.clear_compiled()
    rc.reset_launches()
    scene = build_scene(tt, gz_torch, shader=shader, supersample=2)
    frame = scene.render()
    torch.cuda.synchronize()
    path = chip_smoke.PATH_KERNELS["general" if shader == "general"
                                   else "slim"]
    assert min(rc.LAUNCHES[k] for k in path) == 2
    cpu = build_scene(tt, gz_torch, shader=shader, supersample=2,
                      device="cpu")
    want = cpu.render()
    assert frame.shape == want.shape == (*RES, 3)
    assert tuple(scene.last_tid.shape) == (2 * RES[0], 2 * RES[1])
    assert (scene.last_tid.cpu() == cpu.last_tid).float().mean() >= 0.999
    assert torch.equal(scene.last_stencil.cpu(), cpu.last_stencil)
    assert (frame == want).all(-1).mean() >= 0.999


@pytest.mark.cuda
def test_stats_on_card_match_cpu(card):
    """Scene.stats() on the card against face_statistics on CPU copies of
    the same packed scene and tid."""
    from tpu_renderer_torch.ops import pipeline as pl

    scene = build_scene(tt, gz_torch)
    scene.render()
    cfg, dyn = scene._prepare()
    want = pl.face_statistics(cfg, chip_smoke.to_device(dyn, "cpu"),
                              scene.last_tid.cpu())
    got = scene.stats()
    assert [{k: int(v) for k, v in s.items()} for s in want] == \
        [{k: v for k, v in s.items() if k != "by_error"} for s in got]
    assert [s["total"] for s in got] == [12, 2]


@pytest.mark.cuda
def test_instances_on_card_match_cpu(card):
    """Three instances of one textured mesh as separate models, on the card:
    one stack tensor per map in their packets; against the same scene on
    the CPU tid >= 99.9%, stencil equal, frame >= 99.9%; the merged model's
    frame and stencil on the card equal (test_torch_instancing.py holds the
    CPU to the JAX package)."""
    import bench_torch

    small = dict(resolution=(96, 96), tex=32, mesh=(10, 14))
    scene = bench_torch.build_highpoly_scene(3, merged=False, **small)
    frame = scene.render()
    _, dyn = scene._prepare()
    assert len({id(md["kd_stack"]) for md in dyn["models"][:-1]}) == 1
    cpu = bench_torch.build_highpoly_scene(3, merged=False, device="cpu",
                                           **small)
    assert (frame == cpu.render()).all(-1).mean() >= 0.999
    assert (scene.last_tid.cpu() == cpu.last_tid).float().mean() >= 0.999
    assert torch.equal(scene.last_stencil.cpu(), cpu.last_stencil)
    merged = bench_torch.build_highpoly_scene(3, merged=True, **small)
    np.testing.assert_array_equal(frame, merged.render())
    assert torch.equal(scene.last_stencil, merged.last_stencil)


@pytest.mark.cuda
@pytest.mark.parametrize("path", PATHS)
def test_replay_equals_eager_on_card(card, path):
    """A compiled path on the card over 3 frames of a camera and light
    orbit: one capture; each frame equals the eager frame of the same
    inputs in all four outputs (equal values, NaN where NaN); the capture
    recorded one launch of each kernel of the path, and every replay adds
    exactly those to LAUNCHES."""
    from tpu_renderer_torch.ops import compiled

    compiled.clear_compiled()
    builds = compiled.CACHE.builds
    scene = path_scene(tt, gz_torch, path)
    kernels = chip_smoke.PATH_KERNELS[chip_smoke.COMPILED_PATHS[path]]
    want_launches = {k: 1 for k in kernels}
    for i in range(3):
        t = 2 * np.pi * i / 3
        scene.camera.set_position((4 * np.cos(t), 2.5, 4 * np.sin(t)))
        scene.light.set_position((3 * np.cos(-t), 4, 3 * np.sin(-t)))
        cfg, dyn = prepared(scene, path)
        rc.reset_launches()
        got = jit_outputs(cfg, dyn, path)
        torch.cuda.synchronize()
        prog = compiled.CACHE.last
        assert prog.launches == want_launches
        if i:
            assert {k: n for k, n in rc.LAUNCHES.items() if n} == \
                want_launches
        want = eager_outputs(cfg, dyn, path)
        assert chip_smoke._same(tuple(got), tuple(want))
        assert (got[2] >= 0).any()
    assert compiled.CACHE.builds == builds + 1 and prog.calls == 3


@pytest.mark.cuda
def test_crowd_replay_shades_in_one_launch_on_card(card):
    """A compiled frame of the small crowd (20 instances and the floor: 21
    models, 41 model and map pairs) launches K9 once per replay, whatever
    its number of models, and its frame equals the eager frame."""
    from tpu_renderer_torch.ops import compiled
    from tpu_renderer_torch.ops import pipeline as pl

    compiled.clear_compiled()
    scene = small_crowd(20)
    scene.render()
    rc.reset_launches()
    frame = scene.render()
    torch.cuda.synchronize()
    assert rc.LAUNCHES["shade"] == 1
    cfg, dyn = scene._prepare()
    assert len(cfg.models) == 21
    np.testing.assert_array_equal(frame, pl.render_frame(cfg, dyn)[0].cpu())


@pytest.mark.cuda
def test_replay_does_not_sync_on_card(card):
    """A replay (staging, copies, the graph, the output clones) never waits
    for the device."""
    from tpu_renderer_torch.ops import pipeline as pl

    cfg, dyn = build_scene(tt, gz_torch)._prepare()
    pl.render_frame_jit(cfg, dyn)
    chip_smoke._assert_no_sync(lambda: pl.render_frame_jit(cfg, dyn))


@pytest.mark.cuda
def test_stencil_reads_its_constants_at_replay_on_card(cuda_inputs):
    """K4 reads (nf2, fpn, fmn) through its pointer: one launch captured
    into a graph, replayed after other cameras' constants are copied into
    its buffer, equals stencil_plain with those constants as Python floats
    each time."""
    (qdata, qi, zb, sign, zc), _ = cuda_inputs["stencil"]
    consts = zc.clone()
    rc.stencil(qdata, qi, zb, sign, consts)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with rc.counting_into({}), torch.cuda.graph(graph):
        out = rc.stencil(qdata, qi, zb, sign, consts)
    shadowed = []
    for near, far in ((0.01, 50.0), (0.5, 20.0), (1.0, 8.0)):
        scalars = rc.stencil_scalars(near, far)
        consts.copy_(torch.tensor(scalars))
        graph.replay()
        torch.cuda.synchronize()
        want = rc.stencil_plain(qdata.cpu(), qi.cpu(), zb.cpu(), sign,
                                scalars)
        assert torch.equal(out.cpu(), want)
        shadowed.append(int((want != 0).sum()))
    assert shadowed[0] > 0 and len(set(shadowed)) > 1


# ------------------------------------------------------------- K8 on the card

#: K8's frames on the card: bench_torch's flagship, the crowd (99,842
#: faces), cfg3-rh-shadows (sign +1, the spot light's w = 2 extrusion), the
#: flagship with a count of 0, and the flagship with every edge's row
#: prepared (order = every edge, count = E).
QUAD_PREP_FRAMES = ("flagship", "cfg5-merged", "cfg3-rh-shadows",
                    "no-silhouette", "every-row")
#: Light positions whose silhouettes on the flagship shrink in this order.
SHRINKING_LIGHTS = ((10, 10, 10), (5, 5, 0), (0, 3, 0))


def _card_frame(name):
    """(cfg, dyn, cam_m, K8's arguments) of a bench_torch frame on the
    card: the flagship or a configuration."""
    import bench_torch
    from tpu_renderer_torch.ops import pipeline as pl

    scene = (bench_torch.build_scene("cuda") if name == "flagship"
             else bench_torch.build_config(name))
    cfg, dyn = scene._prepare()
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cuda")
    return cfg, dyn, cam_m, chip_smoke.quad_prep_args(cfg, dyn, cam_m)


@pytest.mark.cuda
@pytest.mark.parametrize("frame", QUAD_PREP_FRAMES)
def test_quad_prep_matches_plain_on_card(card, frame):
    """K8 equals quad_prep_plain bit for bit (NaN where NaN) over all its
    table rows, in one launch; the rows past the count are zero."""
    base = frame if frame in ("cfg5-merged", "cfg3-rh-shadows") \
        else "flagship"
    args = list(_card_frame(base)[3])
    e = args[0].shape[0]
    if frame == "no-silhouette":
        args[2] = torch.zeros((), dtype=torch.int32, device="cuda")
    elif frame == "every-row":
        args[1] = torch.arange(e, dtype=torch.int32, device="cuda")
        args[2] = torch.full((), e, dtype=torch.int32, device="cuda")
    rc.reset_launches()
    got = rc.quad_prep(*args)
    torch.cuda.synchronize()
    assert rc.LAUNCHES["quad_prep"] == 1
    assert _equal(got, rc.quad_prep_plain(*args))
    n = int(args[2])
    assert n == 0 or (got[1][:n, 5] > 0).any()
    assert (got[0][n:] == 0).all() and (got[1][n:] == 0).all()


@pytest.mark.cuda
def test_quad_bins_follow_the_count_on_card(card):
    """On the crowd's tables with active rows copied past the count, K4's
    coarse lists (csrc/bins.cu) hold only rows below it, as
    coarse_bins_plain with the count, and K4 equals the stencil of the
    tables without those rows."""
    cfg, dyn, cam_m, args = _card_frame("cfg5-merged")
    h, w = cfg.resolution
    qdata, qi = rc.quad_prep(*args)
    n = int(args[2])
    assert 0 < n and 2 * n <= qi.shape[0]
    stale_d, stale_i = qdata.clone(), qi.clone()
    stale_d[n:2 * n], stale_i[n:2 * n] = qdata[:n], qi[:n]
    from tpu_renderer_torch.ops import pipeline as pl

    faces, _, _ = chip_smoke.vertex_stage(cfg, dyn, cam_m)
    zb, _ = rc.visibility(rc.pack_faces(faces), rc.face_flags(faces), h, w,
                          cfg.system)
    zc = chip_smoke._stencil_constants(dyn, "cuda")
    stale = (stale_d, stale_i, zb, cfg.system, zc)
    chip_smoke._check_coarse_bins("stencil", stale, {"n_rows": args[2]})
    got = rc.stencil(*stale, n_rows=args[2])
    want = rc.stencil_plain(qdata, qi, zb, cfg.system, zc)
    assert torch.equal(got, want) and (want != 0).any()


@pytest.mark.cuda
def test_quad_prep_graph_replays_with_a_shrinking_count_on_card(card):
    """K8 captured once into a CUDA graph over a capacity C past the
    persistent grid's group count (the flagship's order, repeated), then
    replayed after counts are copied into its count: shrinking (C, E,
    n_sil, 0), then growing (n_sil, E, C). Each replay's tables equal the
    plain version's with that count, so no row of an earlier replay
    survives, and the groups' loop and the zero fill read the count at
    every replay, not at capture."""
    args = list(_card_frame("flagship")[3])
    e = args[0].shape[0]
    _, groups = rc.quad_prep_grid("cuda")
    cap = groups + 37
    order = args[1]
    args[1] = order.repeat(-(-cap // order.shape[0]))[:cap].contiguous()
    count = torch.full((), cap, dtype=torch.int32, device="cuda")
    n_sil = int(args[2])
    assert 0 < n_sil < e
    args[2] = count
    rc.quad_prep(*args)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with rc.counting_into({}), torch.cuda.graph(graph):
        out = rc.quad_prep(*args)
    for n in (cap, e, n_sil, 0, n_sil, e, cap):
        count.fill_(n)
        graph.replay()
        torch.cuda.synchronize()
        assert _equal(out, rc.quad_prep_plain(*args))
        assert (out[1][n:] == 0).all()
        assert n == 0 or (out[1][:n, 4] > 0).any()


@pytest.mark.cuda
def test_replay_with_a_shrinking_silhouette_on_card(card):
    """The flagship through Scene.render() (one captured program) as the
    light moves so that n_sil shrinks: each replay equals the eager frame
    in all four outputs and the plain path's stencil, and launches K8 and
    K4 once."""
    import bench_torch
    from tpu_renderer_torch.ops import compiled
    from tpu_renderer_torch.ops import pipeline as pl

    compiled.clear_compiled()
    builds = compiled.CACHE.builds
    scene = bench_torch.build_scene("cuda", resolution=(256, 256), tex=64)
    counts = []
    for pos in SHRINKING_LIGHTS:
        scene.light.set_position(pos)
        rc.reset_launches()
        frame = scene.render()
        torch.cuda.synchronize()
        assert rc.LAUNCHES["quad_prep"] >= 1 and rc.LAUNCHES["stencil"] >= 1
        cfg, dyn = scene._prepare()
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cuda")
        counts.append(int(chip_smoke.quad_prep_args(cfg, dyn, cam_m)[2]))
        want = pl.render_frame(cfg, dyn)
        got = (torch.from_numpy(frame).cuda(), scene.last_zbuf,
               scene.last_tid, scene.last_stencil)
        assert chip_smoke._same(got, tuple(want))
        plain = pl.render_frame(cfg, dyn, ops=rc.PLAIN)
        assert torch.equal(scene.last_stencil, plain[3])
    assert compiled.CACHE.builds == builds + 1
    assert counts[0] > counts[1] > counts[2] > 0
