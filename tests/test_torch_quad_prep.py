"""K8 (``raster_cuda.quad_prep``, csrc/quad_prep.cu) on adversarial quads.

``adversarial_cases`` builds, from a numpy seed, shadow quads with the
camera inputs K8 takes, which together reach every branch of the clip
(``test_adversarial_set_reaches_every_branch`` checks that pass by pass):

- quads crossing 0 to 6 planes, corners included: clip counts 0 and 3-10;
- vertices exactly on a plane (``dist == 0``), an edge lying in a plane;
- edges that change visibility with ``|denom| < 1e-10`` (no intersection);
- point-light (w = 1) and directional/spot (w = 2) extrusions
  (``shadow.extrude_quads``);
- a NaN vertex and an inf vertex;
- quads wholly outside the frustum;
- an ``order`` with repeats, its count below its capacity.

The "box" cases clip against the clip-space cube (planes x + w >= 0 and
so on, MVP the identity), where a plane's distance is exact, so vertices
lie exactly on planes; the "camera" cases against a perspective camera's
frustum planes, with its MVP and viewport.

Checks:

- on the CPU, ``quad_prep_plain`` (the oracle of the card tests) against
  the JAX package's ``clip_polygon`` (tpu_renderer/ops/frustum.py:153),
  its projection (shadow.py:262-271) and ``pack_quads``
  (raster_pallas.py:903): clip counts and ``ok`` equal, ``ok`` with the
  bbox test equal, the active screen vertices of the camera cases at rtol
  1e-5 plus ``SCREEN_ATOL`` (test_torch_shadow_compaction.py: XLA
  contracts multiply-adds, so clipped vertices are not bit-equal), the
  box cases' clipped vertices at rtol 1e-5 plus ``CLIP_ATOL``;
- on the card (marker ``cuda``), K8 against ``quad_prep_plain`` bit for
  bit (NaN where NaN) over all the table's rows, zeros past the count, at
  counts 0, 1, 15, 16, 17, C - 1 and C (group and warp boundaries: a
  half-warp per quad, two per warp), and at capacities around the
  persistent grid's group count (``raster_cuda.quad_prep_grid``), where
  groups take a second row.

The module imports JAX only inside the CPU test, so it runs on the card's
host too:

    python -m pytest --noconftest tests/test_torch_quad_prep.py -q
"""
import numpy as np
import pytest
import torch

from tpu_renderer_torch.models.camera import camera_matrices
from tpu_renderer_torch.constants import (PROJECTION_TYPE, SUBSYSTEM,
                                          SYSTEM)
from tpu_renderer_torch.ops import frustum
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import shadow as sh
from tpu_renderer_torch.ops import transforms as T
from tpu_renderer_torch.ops.lightning import Lightning

import chip_smoke
from test_torch_kernels import one_torch_thread  # noqa: F401
from test_torch_shadow_compaction import SCREEN_ATOL

#: Frame size and depth range of every case.
RES = (64, 96)
NEAR, FAR = 0.1, 100.0
#: Absolute tolerance of the box cases' clipped vertices against JAX's,
#: beside rtol 1e-5, in clip units (their world is their clip space).
#: XLA's fused multiply-adds move a vertex that the clip cuts out of a
#: 1000-unit extruded edge: measured up to 4.0e-5 past rtol here. Their
#: screen rows are not held at SCREEN_ATOL, which is in the flagship
#: camera's units: this viewport stretches a clip unit to 48 px and 50
#: depth units, and the same vertices move z by up to 2.95e-4 past rtol.
#: The camera cases hold their screen rows at SCREEN_ATOL.
CLIP_ATOL = 1e-4
#: The clip-space cube: x + w, w - x, y + w, w - y, z + w, w - z >= 0.
BOX_PLANES = np.array([[1, 0, 0, 1], [-1, 0, 0, 1], [0, 1, 0, 1],
                       [0, -1, 0, 1], [0, 0, 1, 1], [0, 0, -1, 1]],
                      np.float32)
CASES = ("box", "box-repeats", "camera-point", "camera-spot")
#: Counts of the card sweep, with C - 1 and C added per case.
SWEEP = (0, 1, 15, 16, 17)


def _planar_quads(rng, n, spread, r0, r1, normal=None):
    """``n`` squares (w = 1) in random planes, centred within ``spread`` of
    the origin, circumradius in [r0, r1); ``normal`` fixes their plane's
    normal ((1, 1, 1) cuts the cube in a hexagon: counts up to 10)."""
    quads = np.empty((n, 4, 4), np.float32)
    for k in range(n):
        c = rng.uniform(-spread, spread, 3)
        nrm = rng.normal(size=3) if normal is None else np.asarray(normal,
                                                                   float)
        nrm /= np.linalg.norm(nrm)
        u = np.cross(nrm, rng.normal(size=3))
        u /= np.linalg.norm(u)
        v = np.cross(nrm, u)
        r, a0 = rng.uniform(r0, r1), rng.uniform(0, 2 * np.pi)
        for i in range(4):
            a = a0 + i * np.pi / 2
            quads[k, i, :3] = c + r * (np.cos(a) * u + np.sin(a) * v)
        quads[k, :, 3] = 1.0
    return quads


def _extrusions(rng, n, centre, spread, light_pos, light_type):
    """``n`` quads extruded from random edges near ``centre`` by
    ``shadow.extrude_quads``: w = 1 for a point light, w = 2 on the far
    side for a directional or spot light."""
    verts = np.ones((2 * n, 4), np.float32)
    verts[:, :3] = centre + rng.uniform(-spread, spread, (2 * n, 3))
    light = {"position": torch.tensor(light_pos, dtype=torch.float32),
             "center": torch.zeros(3)}
    ids = torch.arange(2 * n)
    return sh.extrude_quads(torch.from_numpy(verts), ids[0::2], ids[1::2],
                            light, light_type).numpy()


#: Hand-made box quads: on planes, in a plane, parallel crossings, NaN,
#: inf, wholly outside.
_NAN, _INF = float("nan"), float("inf")
SPECIAL_QUADS = np.array([
    # Vertices exactly on the planes x = w, y = w, a corner x = y = -w and
    # z = w with y = -w.
    [[1, 0.5, 0, 1], [0.5, 1, 0, 1], [-1, -1, 0, 1], [0.2, -1, 1, 1]],
    # An edge lying in the plane x = w, the rest outside it.
    [[1, -0.5, 0, 1], [1, 0.5, 0, 1], [2, 0.5, 0, 1], [2, -0.5, 0, 1]],
    # Visibility changes across x + w = 0 with |denom| = 2e-12 < 1e-10:
    # two crossing edges that add no intersection.
    [[0, 0, 0, 1e-12], [-2e-12, 0, 0, 1e-12], [-2e-12, 5e-13, 0, 1e-12],
     [0, 5e-13, 0, 1e-12]],
    # A NaN and an inf vertex.
    [[0, 0, 0, 1], [_NAN, 0, 0, 1], [0.5, 0.5, 0, 1], [0, 0.5, 0, 1]],
    [[0, 0, 0, 1], [_INF, 0, 0, 1], [0.5, 0.5, 0, 1], [0, 0.5, 0, 1]],
    [[-0.5, -0.5, 0.2, 1], [0.5, -0.5, 0.2, 1], [0.5, 0.5, -_INF, 1],
     [-0.5, 0.5, 0.2, 1]],
    # Wholly outside.
    [[3, 3, 0, 1], [4, 3, 0, 1], [4, 4, 0, 1], [3, 4, 0, 1]],
    # One corner inside, the rest past one plane: a triangle.
    [[0.5, 0, 0, 1], [1.5, -0.3, 0, 1], [2, 0, 0, 1], [1.5, 0.3, 0, 1]],
], np.float32)


def _box_quads(rng):
    return np.concatenate([
        SPECIAL_QUADS,
        _planar_quads(rng, 48, 0.6, 0.3, 2.5),
        _planar_quads(rng, 48, 2.0, 0.2, 2.0),
        _planar_quads(rng, 48, 0.05, 1.2, 1.6, normal=(1, 1, 1)),
        _extrusions(rng, 16, 0.0, 0.8, (0.3, 2.0, 0.5),
                    Lightning.POINT_LIGHTNING),
        _extrusions(rng, 16, 0.0, 0.8, (0.3, 2.0, 0.5),
                    Lightning.SPOT_LIGHTNING)])


def adversarial_cases(seed=0):
    """{case: (quad (E, 4, 4), order (C,) int32, n_rows () int32, planes,
    mvp, viewport, H, W)}: K8's arguments on CPU tensors (module
    docstring). Every case but ``box-repeats`` prepares every row in
    order; ``box-repeats`` draws 211 rows of the box quads with repeats
    and prepares the first 203."""
    rng = np.random.default_rng(seed)
    h, w = RES
    box = {"planes": torch.from_numpy(BOX_PLANES), "mvp": torch.eye(4),
           "viewport": T.ViewPort(RES, FAR, NEAR)}
    cam = camera_matrices(
        (0.5, 3.0, 5.0), (0.0, 0.0, 0.0), (0.0, 1.0, 0.0), 60.0, NEAR, FAR,
        projection_type=PROJECTION_TYPE.PERSPECTIVE, system=SYSTEM.LH,
        subsystem=SUBSYSTEM.OPENGL, resolution=RES)
    cam = {"planes": cam["frustum_planes"], "mvp": cam["MVP"],
           "viewport": cam["viewport"]}
    box_quads = _box_quads(rng)
    quads = {
        "box": (box_quads, box),
        "box-repeats": (box_quads, box),
        "camera-point": (_extrusions(rng, 96, 0.0, 1.5, (1.0, 4.0, 2.0),
                                     Lightning.POINT_LIGHTNING), cam),
        "camera-spot": (_extrusions(rng, 96, 0.0, 1.5, (1.0, 4.0, 2.0),
                                    Lightning.SPOT_LIGHTNING), cam),
    }
    out = {}
    for case, (quad, m) in quads.items():
        e = quad.shape[0]
        if case == "box-repeats":
            order, n = rng.integers(0, e, 211), 203
        else:
            order, n = np.arange(e), e
        out[case] = (torch.from_numpy(np.ascontiguousarray(quad)),
                     torch.from_numpy(order.astype(np.int32)),
                     torch.tensor(n, dtype=torch.int32), m["planes"],
                     m["mvp"], m["viewport"], h, w)
    return out


@pytest.fixture(scope="module")
def cases():
    return adversarial_cases()


def clip_trace(quad, planes):
    """Per pass of the plain clip (ops/frustum._clip_one_plane): each
    active slot's distance to the plane and each crossing segment's
    denominator. Returns (final counts, distances, denominators), the
    last two flat over passes."""
    verts = torch.zeros((quad.shape[0], sh.QUAD_PMAX, 4))
    verts[:, :4] = quad
    count = torch.full((quad.shape[0],), 4, dtype=torch.int64)
    dists, denoms = [], []
    for plane in planes:
        idx = torch.arange(sh.QUAD_PMAX)
        active = idx < count[:, None]
        nxt = torch.where((idx + 1 >= count[:, None])[..., None],
                          verts[:, 0:1], torch.roll(verts, -1, dims=1))
        d_cur = frustum._dot4(verts, plane)
        d_nxt = frustum._dot4(nxt, plane)
        cross = active & ((d_cur >= 0) ^ (d_nxt >= 0))
        dists.append(d_cur[active])
        denoms.append(frustum._dot4(verts - nxt, plane)[cross])
        verts, count = frustum._clip_one_plane(verts, count, plane)
    return count, torch.cat(dists), torch.cat(denoms)


def test_adversarial_set_reaches_every_branch(cases):
    """Counts 0 and 3-10, vertices on a plane, parallel crossings, w = 1
    and w = 2, NaN and inf vertices, repeats in the order."""
    counts, on_plane, parallel = set(), 0, 0
    w_values, nan, inf = set(), 0, 0
    for case, (quad, order, n, planes, *_) in cases.items():
        rows = quad[order[:int(n)].long()]
        count, dist, denom = clip_trace(rows, planes)
        counts |= set(count.tolist())
        on_plane += int((dist == 0).sum())
        parallel += int((denom.abs() < 1e-10).sum())
        w_values |= set(rows[..., 3].flatten().tolist())
        nan += int(torch.isnan(rows).sum())
        inf += int(torch.isinf(rows).sum())
    assert {0, 3, 4, 5, 6, 7, 8, 9, 10} <= counts
    assert on_plane > 0 and parallel > 0 and nan > 0 and inf > 0
    assert {1.0, 2.0} <= w_values
    order, n = cases["box-repeats"][1], int(cases["box-repeats"][2])
    assert len(set(order[:n].tolist())) < n < order.shape[0]


def jax_tables(quad, order, n_rows, planes, mvp, viewport, h, w):
    """The JAX package's clip (vmapped clip_polygon), projection and
    pack_quads of the first ``n_rows`` rows of ``order`` (its compacted
    ``_prep``, shadow.py:262-271, ok = count >= 3). Returns (clipped,
    screen, qdata, qi) as numpy arrays."""
    import jax
    import jax.numpy as jnp

    from tpu_renderer.ops.frustum import clip_polygon
    from tpu_renderer.ops.raster_pallas import pack_quads
    from tpu_renderer.ops.transforms import matmul

    n = int(n_rows)
    sel = quad.numpy()[order.numpy()[:n]]
    planes, mvp, viewport = (jnp.asarray(t.numpy())
                             for t in (planes, mvp, viewport))

    @jax.jit
    def prep(sel):
        padded = jnp.zeros((n, sh.QUAD_PMAX, 4), jnp.float32)
        padded = padded.at[:, :4].set(sel)
        clipped, counts = jax.vmap(lambda v, c: clip_polygon(v, c, planes))(
            padded, jnp.full(n, 4, jnp.int32))
        ndc = matmul(clipped, mvp)
        screen = matmul(ndc / ndc[..., 3:4], viewport)
        qdata, qi = pack_quads(screen, counts, counts >= 3, h, w, NEAR, FAR)
        return clipped, screen, qdata, qi

    return tuple(np.asarray(a) for a in prep(jnp.asarray(sel)))


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax(cases, case):
    """quad_prep_plain's rows against the JAX package's: clip counts and
    ok equal, ok with box_valid equal; the active vertices at rtol 1e-5
    plus CLIP_ATOL (box cases, clipped) or SCREEN_ATOL (camera cases,
    projected); the rows past the count zero."""
    args = cases[case]
    qdata, qi = rc.quad_prep_plain(*args)
    quad, order, n_rows, planes, mvp, viewport = args[:6]
    n = int(n_rows)
    clipped_j, screen_j, _, qi_j = jax_tables(*args)
    np.testing.assert_array_equal(qi[:n, 4].numpy(), qi_j[:, 4])
    np.testing.assert_array_equal(qi[:n, 4].numpy() >= 3, qi_j[:, 4] >= 3)
    np.testing.assert_array_equal(qi[:n, 5].numpy(), qi_j[:, 5])
    rows = quad[order[:n].long()]
    padded = torch.zeros((n, sh.QUAD_PMAX, 4))
    padded[:, :4] = rows
    clipped, counts = frustum.clip_polygon(padded, torch.full((n,), 4),
                                           planes)
    screen, counts_p = sh.clip_project(
        rows, {"frustum_planes": planes, "MVP": mvp, "viewport": viewport})
    np.testing.assert_array_equal(counts.numpy(), qi[:n, 4].numpy())
    np.testing.assert_array_equal(counts_p.numpy(), qi[:n, 4].numpy())
    slots = (np.arange(sh.QUAD_PMAX)[None, :]
             < np.minimum(counts.numpy(), sh.QUAD_PMAX)[:, None])
    if case.startswith("box"):
        np.testing.assert_allclose(clipped.numpy()[slots], clipped_j[slots],
                                   rtol=1e-5, atol=CLIP_ATOL)
    else:
        got, want = screen.numpy()[slots], screen_j[slots]
        for k, atol in enumerate(SCREEN_ATOL):
            np.testing.assert_allclose(got[:, k], want[:, k], rtol=1e-5,
                                       atol=atol)
    assert (qdata[n:] == 0).all() and (qi[n:] == 0).all()
    assert (qi[:n, 5] > 0).any()


def test_ptxas_report_reads_one_kernel():
    """chip_smoke.ptxas_report picks one kernel's registers, stack and
    spills out of nvcc's -Xptxas -v log."""
    log = "\n".join([
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_"
        "113lines_kernelEv' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_"
        "113lines_kernelEv",
        "    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads",
        "ptxas info    : Used 30 registers, used 0 barriers",
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_"
        "116quad_prep_kernelEPKf' for 'sm_90a'",
        "ptxas info    : Function properties for _ZN12_GLOBAL__N_"
        "116quad_prep_kernelEPKf",
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads",
        "ptxas info    : Used 48 registers, used 1 barriers, 6368 bytes "
        "smem",
    ])
    assert chip_smoke.ptxas_report(log, "quad_prep_kernel") == {
        "registers": 48, "stack": 0, "spill_stores": 0, "spill_loads": 0}
    assert chip_smoke.ptxas_report(log, "lines_kernel")["stack"] == 8
    with pytest.raises(RuntimeError):
        chip_smoke.ptxas_report(log, "stencil_kernel")


# ------------------------------------------------------------- on the card

@pytest.fixture
def card_cases(cases):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc (run on the card)")
    return {case: tuple(a.cuda() if isinstance(a, torch.Tensor) else a
                        for a in args) for case, args in cases.items()}


def _check(args):
    """One K8 launch against quad_prep_plain on the same tensors."""
    rc.reset_launches()
    got = rc.quad_prep(*args)
    torch.cuda.synchronize()
    assert rc.LAUNCHES["quad_prep"] == 1
    assert chip_smoke._same(got, rc.quad_prep_plain(*args))
    n = max(0, min(int(args[2]), args[1].shape[0]))
    assert (got[0][n:] == 0).all() and (got[1][n:] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("case", CASES)
def test_quad_prep_matches_plain_on_card(card_cases, case):
    """K8 bit for bit against its plain version on the case's rows, with
    the count at each of SWEEP, C - 1 and C."""
    quad, order, _, *rest = card_cases[case]
    cap = order.shape[0]
    for n in sorted({*SWEEP, cap - 1, cap}):
        _check((quad, order, torch.tensor(n, dtype=torch.int32,
                                          device="cuda"), *rest))


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["box", "camera-spot"])
def test_quad_prep_around_the_group_count_on_card(card_cases, case):
    """Capacities and counts around the persistent grid's group count G
    (G - 1, G, G + 1, 2G + 3 rows, every row prepared, and G + 1 rows with
    a count of G): the groups' loop takes a second and a third row, and
    the zero fill starts mid-grid."""
    quad, _, _, *rest = card_cases[case]
    _, groups = rc.quad_prep_grid("cuda")
    rng = np.random.default_rng(1)
    for cap, n in ((groups - 1, groups - 1), (groups, groups),
                   (groups + 1, groups + 1), (2 * groups + 3, 2 * groups + 3),
                   (groups + 1, groups)):
        order = torch.from_numpy(rng.integers(0, quad.shape[0], cap).astype(
            np.int32)).cuda()
        _check((quad, order, torch.tensor(n, dtype=torch.int32,
                                          device="cuda"), *rest))
