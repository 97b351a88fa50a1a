"""K1's and K4's sync-free, staged design, held on the CPU to the plain
versions it must reproduce bit for bit.

The CUDA kernels run on the card only (tests/test_torch_kernels.py holds
them to their plain versions there); these tests check, in plain PyTorch,
each step the kernels take:

- K1's one-walk claim (csrc/visibility.cu): the per-pixel recurrence
  ``if zs <= m: c = face; if z-writing: m = zs`` over
  ``raster_plain.face_fragments`` in face order equals ``visibility_plain``
  (two passes) in zb and tid, on the kernel-test scene and on seeded face
  tables with exact z ties, faces that do not write z, NaN and ±inf depths
  and row0 > 0; and the whole design (coarse lists, refinement to the
  16x16 tile, the walk) equals ``visibility_plain``, tile by tile; both
  also with a debug camera's planes (``fdbg``: the second clip space);
- K4's exact edge cull (csrc/stencil.cu): a plain model of the corner test
  keeps every (tile, quad) pair where some pixel is inside the quad's
  edges, so every pair where ``quad_fragments`` is nonzero, on the scene's
  quads, seeded quads with edges through pixel centres, and quads with
  huge or non-finite coefficients; the whole design sums to
  ``stencil_plain``;
- the coarse lists (csrc/bins.cu, ``raster_cuda.coarse_bins_plain``) list
  every overlapping active primitive in table order, at row0 = 0 and
  row0 > 0, and contain each fine tile's ``tile_bins`` list.
"""
import numpy as np
import pytest
import torch

from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import raster_plain as rp
from tpu_renderer_torch.ops.shadow import quad_fragments

from test_torch_kernels import (  # noqa: F401
    ADV_RES, long_debug_list, long_face_list, long_quad_list,
    one_torch_thread, random_faces, random_quads, with_debug_planes)

T = rc.TILE


@pytest.fixture(scope="module")
def scene_inputs():
    """K1's and K4's inputs for the kernel-test scene (CPU)."""
    import tpu_renderer_torch as tt
    from tpu_renderer_torch.models import gizmos as gz
    from tpu_renderer_torch.ops import pipeline as pl
    from tpu_renderer_torch.ops.shadow import quad_tables

    from test_torch_kernels import build_scene

    scene = build_scene(tt, gz, device="cpu")
    cfg, dyn = scene._prepare()
    h, w = cfg.resolution
    cam_m = pl._cam_matrices(cfg, dyn["camera"], "cpu")
    verts = pl.stacked_vertices(dyn)
    faces, attrs = pl._build_face_batch(cfg, dyn, cam_m, verts=verts)
    fdata, flags = rc.pack_faces(faces), rc.face_flags(faces)
    zb, _ = rc.visibility_plain(fdata, flags, h, w, cfg.system)
    qdata, qi, _ = quad_tables(cfg, dyn, cam_m, h, w, verts=verts,
                               world=attrs["world"])
    zc = torch.tensor(rc.stencil_scalars(dyn["camera"]["near"],
                                         dyn["camera"]["far"]))
    return {"faces": (fdata, flags, h, w, cfg.system),
            "quads": (qdata, qi, zb, cfg.system, zc)}


# ------------------------------------------------------------- K1

def one_walk(fdata, flags, rows, cols, sign, want_tid=True, fdbg=None):
    """The kernel's per-pixel recurrence over the faces in table order:
    running minimum m (+inf) and candidate c (-1); a covering face with
    zs = z * sign <= m becomes c, and lowers m if it writes z. Returns
    (m, c) over the (rows, cols) grid; ``want_tid=False`` walks only the
    z-writing faces (K1's z-only staging); ``fdbg`` adds the debug
    camera's clip space to coverage."""
    cov, z = rp.face_fragments(fdata, flags, rows, cols, fdbg)
    zs = z * sign
    m = torch.full(cov.shape[1:], float("inf"))
    c = torch.full(cov.shape[1:], -1, dtype=torch.int32)
    for f in range(fdata.shape[0]):
        writes = bool(flags[f] & rp.FLAG_ZWRITE)
        if not (want_tid or writes):
            continue
        hit = cov[f] & (zs[f] <= m)
        c = torch.where(hit, torch.tensor(f, dtype=torch.int32), c)
        if writes:
            m = torch.where(hit, zs[f], m)
    return m, c


def _random_table(seed, row0, g=160):
    rng = np.random.default_rng(seed)
    h, w = 40, 72
    fdata, flags = random_faces(rng, g, (0, w, row0, row0 + h),
                                (w, row0 + h))
    return fdata, flags, h, w


def test_one_walk_equals_two_passes_on_scene(scene_inputs):
    fdata, flags, h, w, sign = scene_inputs["faces"]
    rows, cols = rp._grid(h, w, "cpu")
    m, c = one_walk(fdata, flags, rows, cols, sign)
    zb, tid = rc.visibility_plain(fdata, flags, h, w, sign)
    assert torch.equal(m, zb) and torch.equal(c, tid)
    assert (tid >= 0).any() and (tid < 0).any()


@pytest.mark.parametrize("seed,row0,sign", [(0, 0, 1), (1, 0, -1),
                                            (2, 37, 1), (3, 200, -1)])
def test_one_walk_equals_two_passes_on_random_tables(seed, row0, sign):
    """Exact ties (nine constant depths), faces that do not write z, NaN and
    ±inf depths, NaN at column 0, invalid faces, clip tests, row0 > 0."""
    fdata, flags, h, w = _random_table(seed, row0)
    z = fdata[:, 6:9]
    assert torch.isnan(z).any() and torch.isinf(z).any()
    assert ((flags & rp.FLAG_ZWRITE) == 0).any()
    rows, cols = rp._grid(h, w, "cpu", row0)
    m, c = one_walk(fdata, flags, rows, cols, sign)
    zb, tid = rc.visibility_plain(fdata, flags, h, w, sign, row0=row0)
    assert torch.equal(m, zb) and torch.equal(c, tid)
    mz, _ = one_walk(fdata, flags, rows, cols, sign, want_tid=False)
    assert torch.equal(mz, zb)
    # Ties decided: some pixel's winner is a later face of equal depth.
    cov, zf = rp.face_fragments(fdata, flags, rows, cols)
    claim = cov & (zb >= zf * sign)
    assert (claim.sum(0) > 1).any()


@pytest.mark.parametrize("seed,row0,sign", [(20, 0, 1), (21, 37, -1)])
def test_one_walk_equals_two_passes_with_debug_planes(seed, row0, sign):
    """The same with debug planes holding negative, NaN and ±inf values:
    the walk over the second clip space still equals the two passes, and
    the planes only take coverage away, somewhere."""
    fdata, flags, h, w = _random_table(seed, row0)
    flags, fdbg = with_debug_planes(fdata, flags, seed)
    assert torch.isnan(fdbg).any() and torch.isinf(fdbg).any()
    rows, cols = rp._grid(h, w, "cpu", row0)
    m, c = one_walk(fdata, flags, rows, cols, sign, fdbg=fdbg)
    zb, tid = rc.visibility_plain(fdata, flags, h, w, sign, row0=row0,
                                  fdbg=fdbg)
    assert torch.equal(m, zb) and torch.equal(c, tid)
    mz, _ = one_walk(fdata, flags, rows, cols, sign, want_tid=False,
                     fdbg=fdbg)
    assert torch.equal(mz, zb)
    cov, _ = rp.face_fragments(fdata, flags, rows, cols, fdbg)
    cov0, _ = rp.face_fragments(fdata, flags, rows, cols)
    assert (cov0 & ~cov).any() and not (cov & ~cov0).any()


def _corners(h, w, row0):
    """Each fine tile's first and last pixel column (1, tx, 1) and row
    (ty, 1, 1), float32."""
    x0 = (torch.arange(-(-w // T)) * T).to(torch.float32)[None, :, None]
    y0 = (torch.arange(-(-h // T)) * T + row0).to(torch.float32)[:, None,
                                                                  None]
    return x0, x0 + (T - 1), y0, y0 + (T - 1)


def _at_max_corner(a, b, k, c_lo, c_hi, r_lo, r_hi):
    """((a*c) + (b*r)) + k at the tile corner that maximizes it, picked by
    the signs of a and b."""
    c = torch.where(a >= 0, c_hi, c_lo)
    r = torch.where(b >= 0, r_hi, r_lo)
    return a * c + b * r + k


def _tile_grid(h, w, row0):
    """Pixel rows (Ht, 1) and columns (1, Wt) of whole tiles, past the
    frame's edge too."""
    return rp._grid(-(-h // T) * T, -(-w // T) * T, "cpu", row0)


def _tile_any(mask, h, w):
    """(E, H', W') bool over whole tiles -> (tiles_y, tiles_x, E): any
    pixel in the tile."""
    n_ty, n_tx = -(-h // T), -(-w // T)
    pad = torch.zeros((mask.shape[0], n_ty * T, n_tx * T), dtype=torch.bool)
    pad[:, :mask.shape[1], :mask.shape[2]] = mask
    return pad.reshape(-1, n_ty, T, n_tx, T).any(4).any(2).permute(1, 2, 0)


def _fine_tiles(h, w):
    return [(ty, tx) for ty in range(-(-h // T)) for tx in range(-(-w // T))]


def staged_visibility(fdata, flags, h, w, sign, row0=0, want_tid=True,
                      fdbg=None):
    """csrc/visibility.cu tile by tile in plain PyTorch: the coarse list,
    refined to the fine tile by bbox (and z-writing in z-only mode), walked
    once in list order (with the staged faces' debug planes, if any)."""
    bbox = fdata[:, rp.F_BBOX:rp.F_BBOX + 4]
    counts, items = rc.coarse_bins_plain(bbox, (flags & rp.FLAG_VALID) > 0,
                                         h, w, row0)
    cx = -(-w // rc.COARSE)
    zb = torch.empty((h, w))
    tid = torch.empty((h, w), dtype=torch.int32)
    for ty, tx in _fine_tiles(h, w):
        ct = (ty * T // rc.COARSE) * cx + tx * T // rc.COARSE
        lst = items[ct, :counts[ct]].long()
        x0, y0 = tx * T, row0 + ty * T
        b = bbox[lst]
        keep = ((b[:, 0] < x0 + T) & (b[:, 1] > x0) & (b[:, 2] < y0 + T)
                & (b[:, 3] > y0))
        if not want_tid:
            keep &= (flags[lst] & rp.FLAG_ZWRITE) > 0
        lst = lst[keep]
        rows = torch.arange(y0, y0 + T, dtype=torch.float32)[:, None]
        cols = torch.arange(x0, x0 + T, dtype=torch.float32)[None]
        m, c = one_walk(fdata[lst], flags[lst], rows, cols, sign, want_tid,
                        None if fdbg is None else fdbg[lst])
        ids = torch.cat([lst, torch.tensor([-1])]).to(torch.int32)
        c = ids[c.long()]                      # -1 stays -1
        r1, c1 = min(h, (ty + 1) * T), min(w, (tx + 1) * T)
        zb[ty * T:r1, x0:c1] = m[:r1 - ty * T, :c1 - x0]
        tid[ty * T:r1, x0:c1] = c[:r1 - ty * T, :c1 - x0]
    return zb, tid


@pytest.mark.parametrize("case", ["scene", "long", "long-z-row0", "random",
                                  "long-dbg", "long-z-row0-dbg",
                                  "random-dbg"])
def test_staged_design_equals_visibility_plain(scene_inputs, case):
    fdbg = None
    if case == "scene":
        fdata, flags, h, w, sign = scene_inputs["faces"]
        row0, want_tid = 0, True
    elif case.startswith("random"):
        fdata, flags, h, w = _random_table(5, 23)
        sign, row0, want_tid = -1, 23, True
        if case.endswith("dbg"):
            flags, fdbg = with_debug_planes(fdata, flags, 5)
    else:
        row0 = 40 if case.startswith("long-z-row0") else 0
        if case.endswith("dbg"):
            fdata, flags, h, w, fdbg = long_debug_list(7, row0)
        else:
            fdata, flags, h, w = long_face_list(7, row0)
        sign, want_tid = 1, case.startswith("long") and "-z-" not in case
    zb, tid = staged_visibility(fdata, flags, h, w, sign, row0, want_tid,
                                fdbg)
    zp, tp = rc.visibility_plain(fdata, flags, h, w, sign, row0, want_tid,
                                 fdbg)
    assert torch.equal(zb, zp)
    if want_tid:
        assert torch.equal(tid, tp)


# ------------------------------------------------------------- K4

def tile_cull_plain(qdata, qi, height, width, row0=0):
    """csrc/stencil.cu's per-tile quad test in plain PyTorch: ok, the int
    bbox against the 16x16 tile, and the exact edge cull (each active
    edge's value at the tile's maximizing corner pixel, A*c + B*r + K in
    the kernel's order, must be > 0). Returns keep (tiles_y, tiles_x, E)
    bool."""
    c_lo, c_hi, r_lo, r_hi = (x[..., None] for x in _corners(height, width,
                                                            row0))
    a, b, k = qdata[:, 0:12], qdata[:, 12:24], qdata[:, 24:36]
    e_hi = _at_max_corner(a, b, k, c_lo, c_hi, r_lo, r_hi)
    n = qi[:, 4].clamp(0, 12)
    idle = torch.arange(12)[None] >= n[:, None]
    bx = qi[:, 0:4].long()
    x0, y0 = c_lo[..., 0].long(), r_lo[..., 0].long()
    ov = ((bx[:, 0] < x0 + T) & (bx[:, 1] > x0) & (bx[:, 2] < y0 + T)
          & (bx[:, 3] > y0) & (qi[:, 5] > 0))
    return ((e_hi > 0) | idle).all(-1) & ov


def _inside(qdata, rows, cols):
    """(E, H, W) bool: every edge value > 0, as quad_fragments takes it
    (the minimum over all 12 slots)."""
    co = lambda col: qdata[:, col, None, None]
    m = None
    for i in range(12):
        e = co(i) * cols + co(12 + i) * rows + co(24 + i)
        m = e if m is None else torch.minimum(m, e)
    return m > 0


def _quad_cases(scene_inputs, case):
    if case == "scene":
        qdata, qi, zb, sign, zc = scene_inputs["quads"]
        return qdata, qi, zb, sign, zc, 0
    if case == "random":
        rng = np.random.default_rng(11)
        qdata, qi = random_quads(rng, 300, (0, 96, 0, 48), 48, 96,
                                 corners=[(15, 15), (16, 16), (47, 31)])
        zb = torch.from_numpy(rng.uniform(0.1, 50, (48, 96)).astype(
            np.float32))
        zc = torch.tensor(rc.stencil_scalars(0.1, 50.0))
        return qdata, qi, zb, 1, zc, 0
    row0 = 40 if case == "long-row0" else 0
    qdata, qi, zb, sign, zc = long_quad_list(13, row0)
    return qdata, qi, zb, sign, zc, row0


@pytest.mark.parametrize("case", ["scene", "random", "long", "long-row0"])
def test_edge_cull_keeps_every_covering_quad(scene_inputs, case):
    """Every (tile, quad) pair where some pixel is inside all of the quad's
    edges, and so every pair where quad_fragments is nonzero, is kept."""
    qdata, qi, zb, sign, zc, row0 = _quad_cases(scene_inputs, case)
    h, w = zb.shape
    keep = tile_cull_plain(qdata, qi, h, w, row0)
    rows, cols = _tile_grid(h, w, row0)
    inside = _inside(qdata, rows, cols) & (qi[:, 5] > 0)[:, None, None]
    need = _tile_any(inside, h, w)
    assert need.any()
    assert not (need & ~keep).any()
    rows, cols = rp._grid(h, w, "cpu", row0)
    qrows = torch.cat([qdata, qi[:, 5:7].to(torch.float32)], 1)
    frag = torch.stack([quad_fragments(qrows[q:q + 1], zb, rows, cols, sign,
                                       *zc) != 0
                        for q in range(qdata.shape[0])])
    assert frag.any()
    assert not (_tile_any(frag, h, w) & ~keep).any()
    # The cull drops something the bbox alone keeps.
    bbox_only = tile_cull_plain(
        torch.cat([torch.zeros_like(qdata[:, :24]),
                   torch.ones_like(qdata[:, 24:36]), qdata[:, 36:]], 1),
        qi, h, w, row0)
    if case != "scene":
        assert (bbox_only & ~keep).any()


def test_edge_cull_on_non_finite_and_huge_coefficients():
    """Edge coefficients ±inf, NaN, ±3e38 (products overflow), in every
    combination on one edge, over tiles at column and row 0 and beyond:
    the corner test never drops a tile where some pixel is inside."""
    vals = torch.tensor([float("inf"), -float("inf"), float("nan"), 3e38,
                         -3e38, 0.0, -0.0, 1.0, -1.0, 0.5, -7.25, 40.0])
    a, b, k = torch.meshgrid(vals, vals, vals, indexing="ij")
    e_n = a.numel()
    qdata = torch.zeros((e_n, rc.Q_COLS))
    qdata[:, 24:36] = 1.0
    qdata[:, 0], qdata[:, 12], qdata[:, 24] = a.reshape(-1), b.reshape(-1), \
        k.reshape(-1)
    qi = torch.zeros((e_n, rc.QI_COLS), dtype=torch.int32)
    qi[:, 0:4] = torch.tensor([0, 48, 0, 48], dtype=torch.int32)
    qi[:, 4], qi[:, 5] = 1, 1
    for row0 in (0, 16):
        rows, cols = _tile_grid(48, 48, row0)
        qi[:, 2:4] = torch.tensor([row0, row0 + 48], dtype=torch.int32)
        keep = tile_cull_plain(qdata, qi, 48, 48, row0)
        need = _tile_any(_inside(qdata, rows, cols), 48, 48)
        assert need.any() and (~keep).any()
        assert not (need & ~keep).any()


def staged_stencil(qdata, qi, zb, sign, nf2, fpn, fmn, row0=0):
    """csrc/stencil.cu tile by tile in plain PyTorch: all-background tiles
    are 0; otherwise the coarse list, refined by bbox and the edge cull,
    summed with quad_fragments."""
    h, w = zb.shape
    counts, items = rc.coarse_bins_plain(qi[:, 0:4], qi[:, 5] > 0, h, w, row0)
    keep = tile_cull_plain(qdata, qi, h, w, row0)
    cx = -(-w // rc.COARSE)
    st = torch.zeros((h, w), dtype=torch.int32)
    qrows = torch.cat([qdata, qi[:, 5:7].to(torch.float32)], 1)
    for ty, tx in _fine_tiles(h, w):
        r1, c1 = min(h, (ty + 1) * T), min(w, (tx + 1) * T)
        z = zb[ty * T:r1, tx * T:c1]
        if not (z < 3e38).any():
            continue
        ct = (ty * T // rc.COARSE) * cx + tx * T // rc.COARSE
        lst = items[ct, :counts[ct]].long()
        lst = lst[keep[ty, tx, lst]]
        rows = torch.arange(row0 + ty * T, row0 + r1,
                            dtype=torch.float32)[:, None]
        cols = torch.arange(tx * T, c1, dtype=torch.float32)[None]
        if len(lst):
            st[ty * T:r1, tx * T:c1] = quad_fragments(
                qrows[lst], z, rows, cols, sign, nf2, fpn, fmn)
    return st


@pytest.mark.parametrize("case", ["scene", "random", "long", "long-row0"])
def test_staged_design_equals_stencil_plain(scene_inputs, case):
    qdata, qi, zb, sign, zc, row0 = _quad_cases(scene_inputs, case)
    got = staged_stencil(qdata, qi, zb, sign, *zc, row0=row0)
    want = rc.stencil_plain(qdata, qi, zb, sign, zc, row0=row0)
    assert torch.equal(got, want)
    assert (want != 0).any()


# ------------------------------------------------------------- coarse lists

@pytest.mark.parametrize("row0", [0, 100])
@pytest.mark.parametrize("dtype", [torch.int32, torch.float32])
def test_coarse_bins_list_every_overlap_in_order(row0, dtype):
    rng = np.random.default_rng(5 + row0)
    n, h, w = 300, 300, 420
    x0 = rng.integers(-20, w, n)
    y0 = rng.integers(row0 - 20, row0 + h, n)
    bbox = np.stack([x0, x0 + rng.integers(0, 200, n),
                     y0, y0 + rng.integers(0, 200, n)], 1)
    active = rng.random(n) > 0.2
    counts, items = rc.coarse_bins_plain(
        torch.from_numpy(bbox).to(dtype), torch.from_numpy(active), h, w,
        row0)
    n_tx = -(-w // rc.COARSE)
    assert counts.shape == (-(-h // rc.COARSE) * n_tx,)
    for t in range(counts.shape[0]):
        ty, tx = divmod(t, n_tx)
        cx, cy = tx * rc.COARSE, row0 + ty * rc.COARSE
        want = [i for i in range(n) if active[i]
                and bbox[i, 0] < cx + rc.COARSE and bbox[i, 1] > cx
                and bbox[i, 2] < cy + rc.COARSE and bbox[i, 3] > cy]
        assert int(counts[t]) == len(want)
        assert items[t, :len(want)].tolist() == want
        assert (items[t, len(want):] == -1).all()


@pytest.mark.parametrize("row0", [0, 40])
def test_coarse_lists_hold_every_fine_list(row0):
    """Refining a coarse list to a fine tile loses nothing: each fine
    tile's tile_bins list is the coarse tile's list filtered by bbox."""
    fdata, flags, h, w = long_face_list(9, row0)
    bbox = fdata[:, rp.F_BBOX:rp.F_BBOX + 4]
    active = (flags & rp.FLAG_VALID) > 0
    counts, items = rc.coarse_bins_plain(bbox, active, h, w, row0)
    off, fine = rc.tile_bins(bbox.int(), active, h, w, row0=row0)
    n_tx = -(-w // T)
    cx = -(-w // rc.COARSE)
    for t in range(off.shape[0] - 1):
        ty, tx = divmod(t, n_tx)
        ct = (ty * T // rc.COARSE) * cx + tx * T // rc.COARSE
        lst = items[ct, :counts[ct]].long()
        x0, y0 = tx * T, row0 + ty * T
        b = bbox[lst]
        keep = ((b[:, 0] < x0 + T) & (b[:, 1] > x0) & (b[:, 2] < y0 + T)
                & (b[:, 3] > y0))
        assert lst[keep].tolist() == fine[off[t]:off[t + 1]].tolist()


def test_bin_scratch_bytes():
    """A count and room for every row per coarse tile: 64 tiles at 1024²,
    1024 at 4096²."""
    assert rc.bin_scratch_bytes(9986, 1024, 1024) == 64 * 9987 * 4
    assert rc.bin_scratch_bytes(9986, 4096, 4096) == 1024 * 9987 * 4
    assert rc.bin_scratch_bytes(0, *ADV_RES) == 1 * 2 * 4


def test_coarse_edge_mirrors_the_kernels():
    """raster_cuda.COARSE and TILE, which size the scratch and the plain
    lists, equal the constants csrc/common.cuh compiles in."""
    import os
    import re

    path = os.path.join(os.path.dirname(rc.__file__), os.pardir, "csrc",
                        "common.cuh")
    with open(path) as f:
        src = f.read()
    for name in ("COARSE", "TILE"):
        m = re.search(rf"constexpr int {name} = (\d+);", src)
        assert m and int(m.group(1)) == getattr(rc, name)


def test_bin_scratch_limit():
    """The wrappers' scratch is refused with a ValueError above
    MAX_BIN_SCRATCH, before anything is allocated: at 4096², 524,287 rows
    fit and 524,288 do not."""
    rows = rc.MAX_BIN_SCRATCH // (1024 * 4) - 1
    counts, items = rc._bin_scratch(rows // 4096, 4096, 4096, "cpu")
    assert counts.shape == (1024,) and items.shape == (1024 * (rows // 4096),)
    assert rc.bin_scratch_bytes(rows, 4096, 4096) == rc.MAX_BIN_SCRATCH
    with pytest.raises(ValueError, match="MAX_BIN_SCRATCH"):
        rc._bin_scratch(rows + 1, 4096, 4096, "cpu")
