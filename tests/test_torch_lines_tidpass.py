"""K6's exact scatter and K7's staged claim, held on the CPU to the plain
versions they must reproduce bit for bit.

The CUDA kernels run on the card only (tests/test_torch_kernels.py holds
them to their plain versions there); these tests check, in plain PyTorch
and without JAX, each step the kernels take:

- K6 (csrc/lines.cu): for each active edge, the integers of its bbox along
  its major axis, cut to the frame's interior, each with its one candidate
  pixel F = floor(minor coordinate at step kk) tested by the whole gather
  predicate, light exactly the pixels ``lines_plain`` lights: on the
  kernel-test scene's edges, on seeded adversarial edges (zero-length,
  sub-pixel, horizontal, vertical, 45°, sy of both signs, clipped, along
  the frame's first and last rows and columns, NaN and ±inf endpoints,
  endpoints on and one ulp from integers, depths equal to the z-buffer),
  and on a 1024-wide frame with endpoints such as 1023.99994;
- K7's claim (csrc/tidpass.cu, face_walk.cuh WALK_CLAIM): the walk with m
  fixed at the given z equals ``tidpass_plain`` on the scene and on seeded
  tables with exact ties, faces that do not write z, NaN and ±inf depths
  and z-buffer values, row0 > 0 and gid0 > 0, and with debug planes (the
  debug camera's clip space, on the scene with a debug camera and on
  tables whose planes hold negative, NaN and ±inf values);
- and K7's whole design tile by tile (coarse list, refinement to the 16x16
  tile by bbox, the claim walk) equals ``tidpass_plain``.
"""
import numpy as np
import pytest
import torch

from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import raster_plain as rp

from test_torch_binning import _fine_tiles, _random_table
from test_torch_kernels import (ADV_GID0, ADV_RES, ADV_ROW0, CROWDED,
                                DEBUG_CAM, TIE_Z, adversarial_edges,
                                build_scene, edge_zbuf, long_claim_inputs,
                                long_edge_list, one_torch_thread,  # noqa: F401
                                with_debug_planes)

T = rc.TILE


# ------------------------------------------------------------- K6

def scatter_lines(ldata, bbox, active, zbuf, height, width):
    """csrc/lines.cu in plain PyTorch: per active edge, the major axis's
    integers i in its bbox and in [1, extent - 1), kk and F with the
    kernel's float ops, the candidate (F, as a float, in the bbox and the
    interior; 0 <= kk < nsteps) and the z test at it. Returns (mask (H, W)
    int32, ties (H, W) bool: candidates that fail only because z equals
    zbuf)."""
    keep = active.to(torch.bool)
    ld, bb = ldata[keep], bbox[keep].long()
    x0, y0, z0, sx, sy, sz, nsteps = (ld[:, c, None] for c in range(7))
    majx = ld[:, 7, None] > 0
    pick = lambda a, b: torch.where(majx, a, b)
    lo = torch.clamp(pick(bb[:, 0:1], bb[:, 2:3]), min=1)
    hi = torch.minimum(pick(bb[:, 1:2], bb[:, 3:4]),
                       pick(torch.tensor(width), torch.tensor(height)) - 1)
    i = lo + torch.arange(max(height, width))[None]
    a = i.to(torch.float32)
    kk = pick(torch.floor(x0 - a),
              torch.where(sy > 0, torch.ceil(a - y0), torch.floor(y0 - a)))
    f = pick(torch.floor(y0 + kk * sy), torch.floor(x0 + kk * sx))
    f_lo = pick(bb[:, 2:3], bb[:, 0:1]).to(torch.float32)
    f_hi = pick(bb[:, 3:4], bb[:, 1:2]).to(torch.float32)
    f_max = pick(torch.tensor(height), torch.tensor(width)).to(
        torch.float32) - 1.0
    cand = ((i < hi) & (f >= f_lo) & (f < f_hi) & (f > 0) & (f < f_max)
            & (kk >= 0) & (kk < nsteps))
    j = torch.where(cand, f, torch.zeros_like(f)).long()
    i = torch.where(cand, i, torch.zeros_like(i))
    row, col = pick(j, i)[cand], pick(i, j)[cand]
    z = (z0 + kk * sz)[cand]
    zb = zbuf[row, col]
    lit = zb - z > 0
    mask = torch.zeros((height, width), dtype=torch.int32)
    mask[row[lit], col[lit]] = 1
    ties = torch.zeros((height, width), dtype=torch.bool)
    ties[row[zb == z], col[zb == z]] = True
    return mask, ties & (mask == 0)


def _scene_lines():
    import tpu_renderer_torch as tt
    from tpu_renderer_torch.models import gizmos as gz
    from tpu_renderer_torch.ops import pipeline as pl

    scene = build_scene(tt, gz, device="cpu", shader="wireframe")
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    faces, _ = pl._build_face_batch(cfg, dyn, cam_m,
                                    verts=pl.stacked_vertices(dyn))
    zb, _ = rc.visibility_plain(rc.pack_faces(faces), rc.face_flags(faces),
                                h, w, cfg.system)
    sx, sy, sz, _, valid = pl._debug_vertices(cfg, dyn, cam_m)
    return pl._wireframe_lines(sx, sy, sz, valid, zb * cfg.system, h, w)


def _wide_lines(seed):
    """A 24 x 1024 frame: adversarial edges, and edges with endpoints on
    and one ulp from 0, 1, 511, 512, 1022, 1023 and 1024 along the first
    and last rows and columns."""
    rng = np.random.default_rng(seed)
    h, w = 24, 1024
    p0, p1 = adversarial_edges(rng, h, w)
    k = np.float32([0, 1, 511, 512, 1022, 1023, 1024])
    xs = np.concatenate([k, np.nextafter(k, np.float32(-np.inf)),
                         np.nextafter(k, np.float32(np.inf))])
    ys = np.float32([0, 1, 1.5, h - 2, h - 1, h])
    x0, y0 = [a.ravel() for a in np.meshgrid(xs, ys)]
    x1 = rng.permutation(x0)
    y1 = y0 + rng.choice(np.float32([0, 0.5, -1, 3]), len(y0))
    z = rng.uniform(0, 25, (len(x0), 2)).astype(np.float32)
    q0 = torch.from_numpy(np.stack([x0, y0, z[:, 0]], 1))
    q1 = torch.from_numpy(np.stack([x1, y1, z[:, 1]], 1))
    ldata, bbox = rc.pack_lines(torch.cat([p0, q0]), torch.cat([p1, q1]),
                                h, w)
    active = torch.from_numpy(rng.random(len(ldata)) > 0.1)
    return ldata, bbox, active, edge_zbuf(rng, h, w), h, w


def _lines_case(case):
    if case == "scene":
        return _scene_lines()
    if case == "long":
        return long_edge_list(5)
    if case.startswith("wide"):
        return _wide_lines(int(case[-1]))
    rng = np.random.default_rng(int(case[-1]))
    h, w = ADV_RES
    ldata, bbox = rc.pack_lines(*adversarial_edges(rng, h, w), h, w)
    active = torch.from_numpy(rng.random(len(ldata)) > 0.1)
    return ldata, bbox, active, edge_zbuf(rng, h, w), h, w


@pytest.mark.parametrize("case", ["scene", "long", "adversarial-1",
                                  "adversarial-2", "wide-3", "wide-4"])
def test_scatter_equals_lines_plain(case):
    args = _lines_case(case)
    mask, _ = scatter_lines(*args)
    want = rc.lines_plain(*args)
    assert torch.equal(mask, want)
    assert want.sum() > 0


@pytest.mark.parametrize("case", ["long", "adversarial-1", "wide-3"])
def test_adversarial_edges_are_not_degenerate(case):
    """The edges light pixels on the interior's first and last rows and
    columns and in the crowded tile, leave reached pixels dark where the
    edge's depth equals the buffer's (TIE_Z), and carry every kind: NaN and
    inf coordinates, zero-length, sub-pixel, axis-aligned and 45° edges of
    both slopes, and edges clipped at the frame."""
    ldata, bbox, active, zbuf, h, w = _lines_case(case)
    mask, ties = scatter_lines(ldata, bbox, active, zbuf, h, w)
    assert mask[1].any() and mask[h - 2].any()
    assert mask[:, 1].any() and mask[:, w - 2].any()
    assert ties.any() and (zbuf[ties] == TIE_Z).all()
    if case == "long":
        lo, hi = CROWDED
        assert mask[lo:hi, lo:hi].sum() > 20
    x0, y0, sx, sy, nsteps = (ldata[:, c] for c in (0, 1, 3, 4, 6))
    assert (~torch.isfinite(ldata[:, :2])).any()
    assert ((sx == 0) & (sy == 0)).any()                     # zero-length
    assert ((nsteps == 0) & active).any()                    # sub-pixel
    assert ((sy == 0) & (sx == -1)).any()                    # horizontal
    assert ((sx == 0) & (sy.abs() == 1)).any()               # vertical
    assert ((sx.abs() == 1) & (sy == 1)).any()               # 45°, sy > 0
    assert ((sx.abs() == 1) & (sy == -1)).any()              # 45°, sy < 0
    assert ((x0 == torch.floor(x0)) & (y0 == torch.floor(y0))).any()
    clipped = ((bbox[:, 0] == 0) | (bbox[:, 1] == w) | (bbox[:, 2] == 0)
               | (bbox[:, 3] == h))
    assert (clipped & (ldata[:, 6] > 1)).any()


# ------------------------------------------------------------- K7

def claim_walk(fdata, flags, zb, rows, cols, sign, fdbg=None):
    """K7's per-pixel walk over the faces in table order with m fixed at
    the given z: a covering face (in the debug camera's clip space too,
    with ``fdbg``) with zs = z * sign <= zb becomes the candidate. Returns
    cand (-1 where none)."""
    cov, z = rp.face_fragments(fdata, flags, rows, cols, fdbg)
    zs = z * sign
    c = torch.full(cov.shape[1:], -1, dtype=torch.int32)
    for f in range(fdata.shape[0]):
        c = torch.where(cov[f] & (zs[f] <= zb),
                        torch.tensor(f, dtype=torch.int32), c)
    return c


def staged_tidpass(fdata, flags, zb, sign, row0=0, gid0=0, fdbg=None):
    """csrc/tidpass.cu tile by tile in plain PyTorch: the coarse list of
    valid faces, refined to the fine tile by bbox alone, walked once in
    list order against the given z (with the staged faces' debug planes,
    if any)."""
    h, w = zb.shape
    bbox = fdata[:, rp.F_BBOX:rp.F_BBOX + 4]
    counts, items = rc.coarse_bins_plain(bbox, (flags & rp.FLAG_VALID) > 0,
                                         h, w, row0)
    cx = -(-w // rc.COARSE)
    tid = torch.empty((h, w), dtype=torch.int32)
    for ty, tx in _fine_tiles(h, w):
        ct = (ty * T // rc.COARSE) * cx + tx * T // rc.COARSE
        lst = items[ct, :counts[ct]].long()
        x0, y0 = tx * T, row0 + ty * T
        b = bbox[lst]
        lst = lst[(b[:, 0] < x0 + T) & (b[:, 1] > x0) & (b[:, 2] < y0 + T)
                  & (b[:, 3] > y0)]
        r1, c1 = min(h, (ty + 1) * T), min(w, (tx + 1) * T)
        rows = torch.arange(y0, row0 + r1, dtype=torch.float32)[:, None]
        cols = torch.arange(x0, c1, dtype=torch.float32)[None]
        c = claim_walk(fdata[lst], flags[lst], zb[ty * T:r1, x0:c1], rows,
                       cols, sign, None if fdbg is None else fdbg[lst])
        ids = torch.cat([lst + gid0, torch.tensor([-1])]).to(torch.int32)
        tid[ty * T:r1, x0:c1] = ids[c.long()]            # -1 stays -1
    return tid


def _claim_case(case):
    """(fdata, flags, zb_sign, sign, row0, gid0, fdbg) of a claim case;
    fdbg is None unless the case's name ends in ``-dbg``."""
    if case.endswith("-dbg") and not case.startswith("scene"):
        fdata, flags, zb, sign, row0, gid0, _ = _claim_case(case[:-4])
        flags, fdbg = with_debug_planes(fdata, flags, row0 + gid0)
        return fdata, flags, zb, sign, row0, gid0, fdbg
    if case.startswith("scene"):
        import tpu_renderer_torch as tt
        from tpu_renderer_torch.models import gizmos as gz
        from tpu_renderer_torch.ops import pipeline as pl

        kw = ({"debug_camera": tt.Camera(**DEBUG_CAM)}
              if case.endswith("-dbg") else {})
        scene = build_scene(tt, gz, device="cpu", **kw)
        cfg, dyn = scene._prepare()
        h, w = cfg.resolution
        cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
        faces, _ = pl._build_face_batch(cfg, dyn, cam_m,
                                        pl._debug_mvp(cfg, dyn, "cpu"),
                                        verts=pl.stacked_vertices(dyn))
        fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
        fdbg = rc.pack_debug_planes(faces)
        zb, _ = rc.visibility_plain(fdata, flags, h, w, cfg.system,
                                    fdbg=fdbg)
        return fdata, flags, zb, cfg.system, 0, 0, fdbg
    if case == "long-row0":
        return (*long_claim_inputs(6, ADV_ROW0), ADV_ROW0, ADV_GID0, None)
    seed, row0, sign, gid0 = {"random-0": (0, 0, 1, 0),
                              "random-1": (1, 37, -1, 160),
                              "random-2": (2, 200, 1, 3000)}[case]
    fdata, flags, h, w = _random_table(seed, row0)
    zb, _ = rc.visibility_plain(fdata, flags, h, w, sign, row0, False)
    other = _random_table(seed + 10, row0)
    zo, _ = rc.visibility_plain(*other, sign, row0, False)
    zb = torch.minimum(zb, zo)
    # The given buffer may hold any value: NaN claims nothing, -inf only
    # for -inf depths, +inf for every covering face.
    rng = np.random.default_rng(seed)
    u = torch.from_numpy(rng.random((h, w)))
    zb[u < 0.03] = float("nan")
    zb[(u >= 0.03) & (u < 0.06)] = -float("inf")
    zb[(u >= 0.06) & (u < 0.09)] = float("inf")
    return fdata, flags, zb.contiguous(), sign, row0, gid0, None


CLAIM_CASES = ["scene", "long-row0", "random-0", "random-1", "random-2",
               "scene-dbg", "long-row0-dbg", "random-1-dbg"]


@pytest.mark.parametrize("case", CLAIM_CASES)
def test_claim_walk_equals_tidpass_plain(case):
    fdata, flags, zb, sign, row0, gid0, fdbg = _claim_case(case)
    h, w = zb.shape
    rows, cols = rp._grid(h, w, "cpu", row0)
    c = claim_walk(fdata, flags, zb, rows, cols, sign, fdbg)
    want = rc.tidpass_plain(fdata, flags, zb, sign, row0, gid0, fdbg)
    assert torch.equal(torch.where(c >= 0, c + gid0, c), want)
    assert (want >= 0).any() and (want < 0).any()


@pytest.mark.parametrize("case", CLAIM_CASES)
def test_staged_design_equals_tidpass_plain(case):
    fdata, flags, zb, sign, row0, gid0, fdbg = _claim_case(case)
    got = staged_tidpass(fdata, flags, zb, sign, row0, gid0, fdbg)
    want = rc.tidpass_plain(fdata, flags, zb, sign, row0, gid0, fdbg)
    assert torch.equal(got, want)


@pytest.mark.parametrize("case", ["long-row0", "random-1", "random-2",
                                  "long-row0-dbg"])
def test_claim_inputs_are_not_degenerate(case):
    """Exact ties decided (several faces claim a pixel), faces that do not
    write z claim some pixels, NaN and ±inf depths in the table, and, where
    the buffer is merged from two tables, pixels that no face of this one
    claims although it covers them; with debug planes, they change the
    claim."""
    fdata, flags, zb, sign, row0, gid0, fdbg = _claim_case(case)
    h, w = zb.shape
    rows, cols = rp._grid(h, w, "cpu", row0)
    cov, z = rp.face_fragments(fdata, flags, rows, cols, fdbg)
    claim = cov & (zb >= z * sign)
    assert (claim.sum(0) > 1).any()
    assert claim[(flags & rp.FLAG_ZWRITE) == 0].any()
    z = fdata[:, 6:9]
    assert torch.isnan(z).any() and torch.isinf(z).any()
    assert (cov.any(0) & ~claim.any(0)).any()
    assert row0 > 0 and gid0 > 0
    if fdbg is not None:
        assert not torch.equal(
            rc.tidpass_plain(fdata, flags, zb, sign, row0, gid0, fdbg),
            rc.tidpass_plain(fdata, flags, zb, sign, row0, gid0))
