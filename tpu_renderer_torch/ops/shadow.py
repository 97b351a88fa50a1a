"""Stencil shadow volumes, batched, in PyTorch.

Counterpart of ``tpu_renderer/ops/shadow.py``:

1. **Silhouette extraction** — parity of the light-facing mask summed over
   unique-edge ids (odd = silhouette); the surviving edge keeps the vertex
   order of the *last* light-facing incidence (reference XOR set,
   triangular.py:294-302). The facing test is ``normal @ light.position > 0``
   — position, not direction — like triangular.py:295. One pass covers
   every shadowing model: the packing's edge tables (:func:`edge_tables`)
   offset each model's edge and vertex ids, so one scatter over all
   incidences gives, edge for edge, what a pass per model gives.
2. **Extrusion** (core.py:613-621), including the reference's homogeneous
   quirk for directional lights (w = 2 on the extruded points), once over
   every edge.
3. **Compaction** (shadow.py:306-339 there): the edges in the stable
   silhouette-first order (JAX's ``argsort(~sil, stable=True)``, here an
   exclusive prefix sum and a scatter) and their silhouette count
   ``n_sil``, a 0-d int32 tensor on the edges' device: nothing waits for
   the device, so a captured frame replays with any count.
4. **Clip, project, pack** of the first ``n_sil`` edges of that order only
   (``raster_cuda.quad_prep``: K8, csrc/quad_prep.cu, on the card; on the
   CPU its plain version, :func:`clip_project` then
   ``raster_cuda.pack_quads``): each quad is clipped against the six
   world-space frustum planes (triangular.py:320, ops/frustum.clip_polygon),
   projected, and packed into the stencil kernel's tables, whose rows past
   the count are zero (inactive). JAX's static capacity ladder (E/5, E/3,
   E, picked by ``lax.cond``) exists because XLA needs static shapes; the
   port's tables keep the capacity E and K8 and K4 read the count on the
   device instead.
5. **Stencil** (triangular.py:319-368): point-in-convex-polygon by edge
   half-planes, plane-equation depth in divide-free multiply-compare form,
   geometry pixels only, +1 for front quads and -1 for back quads. The sum
   is over integers, so any order gives the same stencil; K4 bins and
   rasterizes only the first ``n_sil`` rows.

Under triangle sharding (a process ``group`` over the ``tris`` axis) each
rank holds a slice of every model's faces and their edge incidences: the
parity counts SUM and the last light-facing incidence MAXes over the
group, once per frame, so every rank sees the global silhouette and the
same global order; rank r then prepares the contiguous compact rows
``[r*c, min(n_sil, (r+1)*c))``, c = ceil(n_sil / n) computed on the
device, and the partial stencils SUM.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_renderer_torch.ops.frustum import clip_polygon
from tpu_renderer_torch.ops.lightning import Lightning
from tpu_renderer_torch.ops.transforms import normalize
from tpu_renderer_torch.ops.vertex import _rowvec
from tpu_renderer_torch.parallel.mesh import all_reduce

__all__ = ["light_facing", "edge_tables", "silhouette_edges",
           "extrude_quads", "quad_edge_coeffs", "prepare_quads",
           "silhouette_order", "clip_project",
           "quad_tables", "shadow_stencil",
           "QUAD_PMAX"]

#: Padded vertex capacity for a quad clipped by 6 planes (4 + 6 = 10 max).
QUAD_PMAX = 12


def _cross(a, b):
    """Row-wise cross product, component order of ``jnp.cross``."""
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def light_facing(world, light_position):
    """(F,) bool: the faces of ``world`` (F, 3, 3), each face's world
    positions, whose normal points at the light's position
    (``normal @ light.position > 0``, triangular.py:295)."""
    n = _cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
    return _dot3(n, light_position) > 0


def edge_tables(cfg, models):
    """The packing-only incidence tables of the shadow pass, over every
    shadowing model (``shadowing`` and ``num_edges > 0``) in model order,
    or None without one:

    - ``inc_edge`` (I,): each incidence's edge, offset by the edges of the
      shadowing models before;
    - ``inc_dir`` (I, 2): its directed vertex ids, offset by the vertices
      of all models before (ids into the vertex stage's stacked vertices);
    - ``inc_valid`` (I,): where it holds and its face is no padding;
    - ``inc_face`` (I,): its face's row in the frame's face order;
    - ``edge_first`` (E,): the first incidence of each edge's model, whose
      vertex pair an edge without a light-facing incidence takes (as
      :func:`silhouette_edges` gives such an edge its incidence 0's).

    Edge ids are offset so that no two models share an edge, and each
    edge's incidences lie in its own model's block, so one pass over the
    tables picks, edge for edge, what a pass per model would.
    ``pipeline.face_tables`` holds them as ``edges``."""
    parts = []
    n_verts = n_faces = n_edges = n_inc = 0
    for mc, md in zip(cfg.models, models):
        if mc.shadowing and mc.num_edges > 0:
            edge = md["inc_edge"].long()
            dev, count = edge.device, edge.shape[0]
            parts.append({
                "inc_edge": edge + n_edges,
                "inc_dir": md["inc_dir"].long() + n_verts,
                "inc_valid": (md["inc_valid"]
                              & md["pad_valid"].repeat_interleave(3)),
                "inc_face": torch.arange(count, device=dev) // 3 + n_faces,
                "edge_first": torch.full((mc.num_edges,), n_inc,
                                         dtype=torch.int64, device=dev),
            })
            n_edges += mc.num_edges
            n_inc += count
        n_verts += md["verts"].shape[0]
        n_faces += md["vid"].shape[0]
    if not parts:
        return None
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}


def _silhouette(inc_lf, inc_edge, inc_dir, edge_first, group, inc_order_base):
    """(silhouette (E,) bool, a_vid (E,), b_vid (E,)) of the light-facing
    incidences ``inc_lf`` (I,) over the tables of :func:`edge_tables`.

    The parity of an edge's light-facing incidences decides the silhouette;
    the edge keeps the direction of its last light-facing incidence, or of
    its ``edge_first`` incidence without one. With a process ``group`` the
    incidences are this rank's, whose first has the key
    ``inc_order_base`` (the rank's index times I): parity SUMs and the last
    key MAXes over the group, and the rank that holds that key gives the
    vertex pair (a MAX over the others' -1), so every rank returns the
    global silhouette (JAX shadow.py:46-97). Keys grow with the rank within
    each model, and ``edge_first`` is rank 0's key."""
    dev = inc_lf.device
    parity = torch.zeros(edge_first.shape[0], dtype=torch.int32, device=dev)
    parity.index_add_(0, inc_edge, inc_lf.to(torch.int32))
    n_inc = inc_lf.shape[0]
    key = torch.where(inc_lf, torch.arange(inc_order_base,
                                           inc_order_base + n_inc,
                                           device=dev), -1)
    last = torch.scatter_reduce(edge_first, 0, inc_edge, key, reduce="amax",
                                include_self=True)
    parity = all_reduce(parity, "sum", group, "silhouette")
    last = all_reduce(last, "max", group, "silhouette")

    silhouette = (parity & 1) == 1
    if group is None:
        ab = inc_dir[last]
    else:
        local = last - inc_order_base
        owns = (local >= 0) & (local < n_inc)
        ab = inc_dir[torch.clamp(local, 0, n_inc - 1)]
        ab = all_reduce(torch.where(owns[:, None], ab, -1), "max", group,
                        "silhouette")
    return silhouette, ab[:, 0], ab[:, 1]


def silhouette_edges(verts, vid, pad_valid, inc_edge, inc_dir, inc_valid,
                     light_position, num_edges, group=None, inc_order_base=0):
    """Per-edge silhouette mask + directed vertex ids of one model's tables.

    verts: (V, 4); vid: (Fp, 3); pad_valid: (Fp,); inc_edge / inc_dir /
    inc_valid: (3Fp,) / (3Fp, 2) / (3Fp,) incidence tensors.
    Returns (silhouette (E,) bool, a_vid (E,), b_vid (E,)); an edge without
    a light-facing incidence takes incidence 0's vertex pair.

    With a process ``group`` the faces and incidences are this rank's slice,
    whose first incidence has the global index ``inc_order_base``
    (:func:`_silhouette`). The frame's pass (:func:`prepare_quads`) runs
    the same steps once over every shadowing model.
    """
    world = verts[vid.long()][..., :3]
    facing = light_facing(world, light_position) & pad_valid
    # Each face's flag on its three incidences (an expand, not
    # repeat_interleave, so that a captured frame never waits for a count).
    inc_lf = facing[:, None].expand(-1, 3).reshape(-1) & inc_valid
    first = torch.zeros(num_edges, dtype=torch.int64, device=verts.device)
    return _silhouette(inc_lf, inc_edge.long(), inc_dir.long(), first, group,
                       inc_order_base)


def extrude_quads(verts, a_vid, b_vid, light, light_type):
    """Silhouette edges -> shadow quads (A, B, D, C), reference core.py:613-621."""
    A = verts[a_vid]
    B = verts[b_vid]
    one = torch.ones(1, dtype=torch.float32, device=verts.device)
    if light_type == Lightning.POINT_LIGHTNING:
        lp = torch.cat([light["position"], one])
        C = A + 1000.0 * normalize(A - lp)
        D = B + 1000.0 * normalize(B - lp)
    else:
        # Directional/spot: w gets +1 on top of the vertex's w=1 — the
        # reference's tuple-append quirk, kept for pixel parity.
        direction = normalize(light["position"] - light["center"]).reshape(-1)
        ext = torch.cat([direction * -1000.0, one])
        C = A + ext
        D = B + ext
    return torch.stack([A, B, D, C], dim=1)                      # (E, 4, 4)


def quad_edge_coeffs(sx, sy, counts, front):
    """Edge half-plane functions of convex screen polygons, orientation folded
    in: inside requires A*x + B*y + K > 0 on every edge. Inactive edge slots
    encode (0, 0, 1), an always-true test. sx, sy: (..., 12); counts, front:
    (...,)."""
    fs = torch.where(front, 1.0, -1.0).to(torch.float32)[..., None]
    slots = torch.arange(sx.shape[-1], device=sx.device)
    wrap = slots + 1 >= counts[..., None]
    px1 = torch.where(wrap, sx[..., 0:1], torch.roll(sx, -1, dims=-1))
    py1 = torch.where(wrap, sy[..., 0:1], torch.roll(sy, -1, dims=-1))
    A = (py1 - sy) * fs
    B = -(px1 - sx) * fs
    K = -(sx * A + sy * B)
    active = slots < counts[..., None]
    zero, one = torch.zeros_like(A), torch.ones_like(K)
    return (torch.where(active, A, zero), torch.where(active, B, zero),
            torch.where(active, K, one))


def quad_fragments(qrow, zb_sign, rows, cols, sign, nf2, fpn, fmn):
    """Signed stencil contribution of a chunk of Q packed shadow polygons.

    The JAX package's ``_quad_fragments`` (shadow.py:150) evaluated on the
    packed coefficients of ``raster_cuda.pack_quads`` (qdata columns
    [0:12] A, [12:24] B, [24:36] K, 36-38 zx zy zd; ``qrow`` also carries the
    0/1 ``ok`` and ``front`` words as columns 44 and 45). Returns (H, W) int32.
    """
    co = lambda c: qrow[:, c, None, None]
    m = None
    for i in range(QUAD_PMAX):
        e = co(i) * cols + co(12 + i) * rows + co(24 + i)
        m = e if m is None else torch.minimum(m, e)
    # zb >= sign*nf2/q  <=>  (zb*q - sign*nf2 >= 0) == (q > 0): the
    # multiply-compare form of raster_pallas.py:1100-1103, geometry pixels
    # only (background never reads the stencil).
    zraw = co(36) * cols + co(37) * rows + co(38)
    qden = fpn - zraw * fmn
    pass_z = ((zb_sign * qden - sign * nf2 >= 0) == (qden > 0)) \
        & (zb_sign < 3e38)
    mask = (m > 0) & pass_z & (co(44) > 0)
    contrib = torch.where(co(45) > 0, 1, -1).to(torch.int32)
    return torch.where(mask, contrib, 0).sum(0, dtype=torch.int32)


def prepare_quads(cfg, dyn, group=None, shard_idx=0, *, verts, world):
    """Silhouette -> extruded quads -> the silhouette-first order and count,
    in one pass over every shadowing model.

    Returns (quad (E, 4, 4) float32, order (C,) int32, count () int32), or
    None when no model casts shadows: the rows to prepare are
    ``quad[order[i]]`` for i < count (``raster_cuda.quad_prep``). On one
    device C = E, ``order`` is the stable silhouette-first permutation of
    the edges (JAX's ``argsort(~sil, stable=True)``, shadow.py:307) and
    count the silhouette count ``n_sil``. With a process ``group``
    (triangle sharding, ``dyn`` this rank's shard) C = ceil(E / n) and
    ``order`` is this rank's stretch of the global order, from
    ``shard_idx * c`` with c = ceil(n_sil / n), and count its length
    ``min(n_sil, (shard_idx + 1) * c) - shard_idx * c`` (at least 0), so
    the ranks' rows partition the one-device rows. No step waits for the
    device. The camera enters at K8 (JAX's takes ``cam_m`` here because
    its ``prepare_quads`` also clips and projects).

    The pass reads the edge tables of the face tables (``dyn["faces"]
    ["edges"]``, :func:`edge_tables`). ``verts`` (V, 4) float32, every
    model's vertices stacked in model order, and ``world`` (G, 3, 3), each
    face's world positions, are the vertex stage's
    (``raster_cuda.vertex_faces``, K10).
    """
    et = dyn["faces"].get("edges")
    if et is None:
        return None
    light = dyn["light"]
    inc_lf = (light_facing(world, light["position"])[et["inc_face"]]
              & et["inc_valid"])
    sil, a_vid, b_vid = _silhouette(
        inc_lf, et["inc_edge"], et["inc_dir"], et["edge_first"], group,
        shard_idx * inc_lf.shape[0])
    quad = extrude_quads(verts, a_vid, b_vid, light, cfg.light_type)
    order, n_sil = silhouette_order(sil)
    if group is None:
        return quad, order, n_sil
    e = quad.shape[0]
    n = dist.get_world_size(group)
    c = (n_sil + (n - 1)) // n
    start = shard_idx * c
    count = torch.clamp(torch.minimum(n_sil, start + c) - start, min=0)
    rows = torch.clamp(start + torch.arange(-(-e // n), device=quad.device),
                       max=e - 1)
    return quad, order[rows], count.to(torch.int32)


def silhouette_order(sil):
    """(order (E,) int32, n_sil () int32) of the silhouette flags (E,)
    bool: the stable silhouette-first permutation (JAX's ``argsort(~sil,
    stable=True)``, shadow.py:307) and the silhouette count, on the flags'
    device. A silhouette edge goes to the number of silhouette edges
    before it, any other edge after all n_sil of them, to the number of
    other edges before it: an exclusive prefix sum, no sort, no sync."""
    idx = torch.arange(sil.shape[0], dtype=torch.int32, device=sil.device)
    csum = torch.cumsum(sil, 0, dtype=torch.int32)
    n_sil = csum[-1]
    pos = torch.where(sil, csum - 1, n_sil + idx - csum)
    return torch.empty_like(idx).scatter_(0, pos.long(), idx), n_sil


def clip_project(quad, cam_m):
    """Extruded quads (Q, 4, 4) -> (screen (Q, QUAD_PMAX, 4), counts (Q,)
    int32): the six-plane world clip (ops/frustum.clip_polygon) and the
    projection MVP -> /w -> viewport (triangular.py:325-327), the JAX
    package's ``_prep`` (shadow.py:262-271). Slots past a quad's count
    hold the projection of a zero vertex (NaN)."""
    padded = torch.zeros((quad.shape[0], QUAD_PMAX, 4), dtype=torch.float32,
                         device=quad.device)
    padded[:, :4] = quad
    counts = torch.full((quad.shape[0],), 4, dtype=torch.int32,
                        device=quad.device)
    clipped, counts = clip_polygon(padded, counts, cam_m["frustum_planes"])
    ndc = _rowvec(clipped, cam_m["MVP"])
    return _rowvec(ndc / ndc[..., 3:4], cam_m["viewport"]), counts


def quad_tables(cfg, dyn, cam_m, height, width, ops=None, group=None,
                shard_idx=0, *, verts, world):
    """The stencil kernel's quad tables of a frame: :func:`prepare_quads`
    (on the vertex stage's ``verts`` and ``world``), then ``ops.quad_prep``
    (``raster_cuda.KERNELS`` by default: K8 on the card, its plain version
    on the CPU). ``cam_m`` holds
    frustum_planes, MVP and viewport on the quads' device. Returns (qdata
    (C, 44) float32, qi (C, 8) int32, count () int32), rows past the count
    zero, or None when no model casts shadows."""
    from tpu_renderer_torch.ops import raster_cuda

    prepared = prepare_quads(cfg, dyn, group, shard_idx, verts=verts,
                             world=world)
    if prepared is None:
        return None
    ops = raster_cuda.KERNELS if ops is None else ops
    qdata, qi = ops.quad_prep(*prepared, cam_m["frustum_planes"],
                              cam_m["MVP"], cam_m["viewport"], height, width)
    return qdata, qi, prepared[2]


def shadow_stencil(cfg, dyn, cam_m, zb_sign):
    """Full-frame signed stencil through the plain path: the quad tables
    of :func:`quad_tables`, on the frame's vertex pass, summed with
    :func:`quad_fragments`. ``dyn`` carries its face tables
    (``pipeline.with_face_tables``); ``zb_sign``: the final z-buffer in
    sign space."""
    from tpu_renderer_torch.ops import pipeline, raster_cuda

    height, width = zb_sign.shape
    verts = pipeline.stacked_vertices(dyn)
    world = pipeline._vertex_pass(cfg, dyn, cam_m, verts)["world"]
    tables = quad_tables(cfg, dyn, cam_m, height, width, raster_cuda.PLAIN,
                         verts=verts, world=world)
    if tables is None:
        return torch.zeros((height, width), dtype=torch.int32,
                           device=zb_sign.device)
    qdata, qi, n = tables
    zc = raster_cuda.stencil_scalars(dyn["camera"]["near"],
                                     dyn["camera"]["far"])
    return raster_cuda.stencil_plain(qdata, qi, zb_sign, cfg.system, zc,
                                     n_rows=n)
