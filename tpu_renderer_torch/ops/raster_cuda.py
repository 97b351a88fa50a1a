"""The port's hand-written CUDA kernels, their packers, their tile binning
and their plain PyTorch versions.

Counterpart of ``tpu_renderer/ops/raster_pallas.py``:

| wrapper             | kernel source          | replaces (Pallas)                       |
|---------------------|------------------------|-----------------------------------------|
| ``visibility``      | csrc/visibility.cu,    | visibility_gbuffer_pallas phase 0;      |
|                     | csrc/bins.cu           | visibility_pallas (z only: want_tid)    |
| ``gbuffer``         | csrc/gbuffer.cu        | visibility_gbuffer_pallas phase 1;      |
|                     |                        | gbuffer_pallas (owned range)            |
| ``sample_textures`` | csrc/sample_textures.cu| the in-kernel windowed texture sampler; |
|                     |                        | sample_textures_pallas (owned range)    |
| ``stencil``         | csrc/stencil.cu,       | stencil_pallas                          |
|                     | csrc/bins.cu           |                                         |
| ``gbuffer_slim``    | csrc/gbuffer_slim.cu   | phase 1, slim layouts (_slim_interp_face)|
|                     |                        | and gbuffer_pallas's (owned range)      |
| ``lines``           | csrc/lines.cu          | lines_pallas                            |
| ``tidpass``         | csrc/tidpass.cu        | tidpass_pallas                          |
| ``quad_prep``       | csrc/quad_prep.cu      | no pallas_call: the XLA clip, projection|
|                     |                        | and pack_quads of the compacted         |
|                     |                        | silhouette (shadow.py:262-339 there)    |
| ``shade``           | csrc/shade.cu          | no pallas_call: the XLA deferred shade  |
|                     |                        | (pipeline._shade_gbuffer :388 and       |
|                     |                        | shading.shade_general there)            |
| ``vertex_faces``    | csrc/vertex.cu         | no pallas_call: the XLA vertex stage    |
|                     |                        | (vertex.py, pipeline._build_face_batch) |
|                     |                        | and pack_faces, face_flags,             |
|                     |                        | pack_face_attrs, pack_slim_attrs        |
| ``overlay``,        | csrc/overlay.cu        | no pallas_call: the host overlay of the |
| ``overlay_quantize``|                        | debug camera's frustum (scene.py:824-848|
|                     |                        | there) and its flip, gamma and uint8    |

Sharded rendering (parallel/sharded.py) gives the raster kernels a block of
frame rows from ``row0`` (pixel math stays in global coordinates) and a
triangle shard's faces, whose global ids are ``gid0`` + the local index.
The G-buffer and sampler kernels then write only the pixels whose merged
tid lies in the shard's own range ``[gid0, gid0 + G_local)`` and zero
elsewhere, so the shards' partial planes sum to the whole. With the
defaults (``row0 = gid0 = 0``) every wrapper computes the one-device frame.

Each wrapper runs its plain version for tensors on the CPU, and only
there. For CUDA tensors it checks device, dtype, shape and contiguity,
allocates the outputs, launches the kernel on the current stream, raises if
the launch reports an error, and adds one to its entry in :data:`LAUNCHES`.
There is no fallback from the kernel: any other device raises. While a
frame is captured into a CUDA graph (ops/compiled.py) a launch is recorded,
not run: it counts into the program's own tally (:func:`counting_into`),
which every replay adds to :data:`LAUNCHES`.

With a debug camera, K1 (both modes) and K7 also take ``fdbg``
(:func:`pack_debug_planes`), the debug camera's clip planes of each face,
and test that second clip space where a face needs the per-pixel test;
these launches count under ``visibility_dbg``, ``visibility_z_dbg`` and
``tidpass_dbg``.

K1, K4 and K7 bin on the card (csrc/bins.cu, :func:`coarse_bins_plain`),
into scratch sized from what the host knows (table rows, frame size,
COARSE); K6 scatters each edge's DDA pixels with no binning. So no wrapper
waits for the device (:func:`tile_bins`, whose ``nonzero`` does, serves
tests and measurements only).

K8 (``quad_prep``) clips, projects and packs only the silhouette quads,
whose count it reads on the device, into tables of a capacity the host
knows, on a persistent grid sized from the card (:func:`quad_prep_grid`);
K4 bins only the rows below that count (``n_rows``). The work of both
follows the count, and neither wrapper reads it on the host.

K9 (``shade``) shades the whole frame in one launch whatever the number of
models: each pixel finds its model's texture (scale, offset) in a table by
its G-buffer model id (:func:`shade_scale_off`), so no pass runs per model.

K10 (``vertex_faces``) is the frame's vertex stage in one launch: from the
stacked vertices, the camera (read through its pointers) and the face
tables to the tables above (fdata, flags, the debug planes and the
shading row of the frame's layout). The columns that depend only on the
packing come prepacked with the face tables (:func:`attr_consts`,
:func:`face_bits`); its plain version is the composition it replaces,
:func:`face_batch` and the packers.

K11 (``overlay``) draws the debug camera's frustum over a float64 frame and
z-buffer from a segment table the host computes
(ops/overlay.frustum_segments), with numpy's semantics, in one block; K12
(``overlay_quantize``) flips, applies gamma 0.8 in float64 and truncates
to uint8. Their plain versions are the numpy of ops/overlay.py; the
scene launches them eagerly after the frame's replay.
"""
from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

from tpu_renderer_torch.ops import overlay as ov
from tpu_renderer_torch.ops import raster_plain as rp
from tpu_renderer_torch.ops import shading as sh
from tpu_renderer_torch.ops.lightning import Lightning
from tpu_renderer_torch.ops.transforms import normalize
from tpu_renderer_torch.ops.shadow import QUAD_PMAX, quad_edge_coeffs, \
    quad_fragments, _cross, _dot3
from tpu_renderer_torch.ops.vertex import (_rowvec, gather_faces,
                                           transform_vertices)
from tpu_renderer_torch.utils import profiling

__all__ = [
    "face_flags", "pack_faces", "pack_debug_planes", "pack_face_attrs",
    "pack_quads", "quad_prep", "quad_prep_plain", "quad_prep_grid",
    "pack_slim_attrs", "pack_lines", "stencil_scalars", "tile_bins",
    "coarse_bins_plain", "bin_scratch_bytes", "COARSE", "MAX_BIN_SCRATCH",
    "visibility", "gbuffer", "sample_textures", "stencil", "gbuffer_slim",
    "lines", "tidpass", "visibility_plain", "gbuffer_plain",
    "sample_textures_plain", "stencil_plain", "gbuffer_slim_plain",
    "lines_plain", "tidpass_plain", "texel_indices", "shade", "shade_plain",
    "shade_scale_off", "vertex_pass", "face_batch", "attr_consts",
    "face_bits", "vertex_faces", "vertex_faces_plain", "VERTEX_LAYOUTS",
    "overlay", "overlay_plain", "overlay_quantize", "overlay_quantize_plain",
    "MAX_SEGMENT_POINTS",
    "LAUNCHES", "reset_launches", "counting_into", "KERNELS", "PLAIN",
    "GB_CHANNELS", "SLIM_CHANNELS",
    "N_KINDS", "KINDS", "TILE",
]

#: Kernel launches per wrapper since the last :func:`reset_launches`; K1's
#: z-only launches count as ``visibility_z``, and K1's and K7's launches
#: with a debug camera's planes under the same keys with ``_dbg``, as K10's
#: with a debug camera's MVP.
LAUNCHES = {"visibility": 0, "visibility_z": 0, "visibility_dbg": 0,
            "visibility_z_dbg": 0, "gbuffer": 0, "sample_textures": 0,
            "stencil": 0, "gbuffer_slim": 0, "lines": 0, "tidpass": 0,
            "tidpass_dbg": 0, "quad_prep": 0, "shade": 0, "vertex": 0,
            "vertex_dbg": 0, "overlay": 0, "overlay_quantize": 0}


def reset_launches():
    for k in LAUNCHES:
        LAUNCHES[k] = 0


#: Where :func:`_launch` counts: LAUNCHES, or a capture's tally.
_counts = LAUNCHES


@contextlib.contextmanager
def counting_into(tally):
    """Count the launches made inside the block into the dict ``tally``
    instead of :data:`LAUNCHES`: a CUDA graph capture records its launches
    there (ops/compiled.py), and each replay adds them to LAUNCHES."""
    global _counts
    prev, _counts = _counts, tally
    try:
        yield tally
    finally:
        _counts = prev


#: Pixel tile edge of the binning grid; each CUDA block shades one tile.
TILE = 16
#: Edge of K1's and K4's coarse binning tiles; mirrors ``COARSE`` in
#: csrc/common.cuh, where the kernels fix it.
COARSE = 128
#: Largest coarse-list scratch (bytes) K1's and K4's wrappers allocate:
#: :func:`bin_scratch_bytes` grows with frame area times table rows.
MAX_BIN_SCRATCH = 2 ** 31

# ------------------------------------------------------------- G-buffer
#: Channel layout of the forward-interpolated G-buffer (general shader),
#: raster_pallas.py:1222-1235.
GB_WORLD = 0        # 0-2   fragment world position
GB_IU = 3           # 3     interpolated u
GB_IV = 4           # 4     interpolated v
GB_N = 5            # 5-7   interpolated vertex normal (unnormalized)
GB_TAN = 8          # 8-10  tangent (unnormalized)
GB_BIT = 11         # 11-13 bitangent (unnormalized)
GB_KD = 14          # 14-16 material Kd
GB_KS = 17          # 17-19 material Ks
GB_NS = 20          # 20    specular exponent
GB_KD_SLOT = 21     # 21    diffuse-map slot (-1 none), 22-23 its (TH, TW)
GB_NORM_SLOT = 24   # 24    normal-map slot, 25-26 (TH, TW), 27 tangent flag
GB_KS_SLOT = 28     # 28    specular-map slot, 29-30 (TH, TW)
GB_MODEL = 31       # 31    model id
GB_CHANNELS = 32

#: Per-face shading attribute table (pack_face_attrs), raster_pallas.py:1237:
#: [0:9] world xyz per vertex, [9:15] u0 u1 u2 v0 v1 v2, [15:24] vn per
#: vertex, [24:27] kd, [27:30] ks, [30] ns, [31] kd_slot, [32:34] kd (TH, TW),
#: [34] norm_slot, [35:37] norm (TH, TW), [37] norm_tangent, [38] ks_slot,
#: [39:41] ks (TH, TW), [41] model_id.
A_COLS = 42

#: Slim G-buffer layouts of the flat, gouraud and pbr shaders
#: (raster_pallas._SLIM_CHANNELS :1275): output channels per layout —
#:   flat:    [0:3] face world normal (constant per face)
#:   gouraud: [0:3] screen-barycentric vertex normal (unnormalized)
#:   pbr:     [0:3] that normal, [3:6] interpolated (sx, sy, z_lin),
#:            [6] Pm, [7] Pr, [8:11] Ka
SLIM_CHANNELS = {"flat": 3, "gouraud": 3, "pbr": 11}
#: Columns of the per-face slim table (pack_slim_attrs) per layout, and the
#: layout's number in the kernel's C interface.
SLIM_COLS = {"flat": 3, "gouraud": 9, "pbr": 23}
SLIM_LAYOUT_ID = {"flat": 0, "gouraud": 1, "pbr": 2}

#: The shading rows K10 writes: its layouts in the order of their numbers
#: in the kernel's C interface, and each row's columns.
VERTEX_LAYOUTS = ("general",) + tuple(SLIM_LAYOUT_ID)
ROW_COLS = {"general": A_COLS, **SLIM_COLS}
#: Packing constants per face (:func:`attr_consts`): the general row's 42
#: columns with world zero and vn zero where the model has none, then pm,
#: pr, ka and a zero column (rows of whole 16-byte words).
C_COLS = A_COLS + 6
#: Bits of the per-face constant word (:func:`face_bits`).
FB_HAS_VN, FB_CLIP, FB_ZWRITE, FB_REAL = 1, 2, 4, 8

#: Edge table of the wireframe kernel (pack_lines): [0] x0, [1] y0, [2] z0,
#: [3] sx, [4] sy, [5] sz per step, [6] step count, [7] major-x flag.
L_COLS = 8

#: Texture kinds sampled by K3, in sample-plane order: plane k and mask bit
#: k belong to KINDS[k].
KINDS = ("kd", "norm", "ks")
N_KINDS = len(KINDS)

#: Quad tables (pack_quads): qdata [0:12] A, [12:24] B, [24:36] K, 36-38
#: zx zy zd, 39 zero, [40:44] bbox as float; qi [0:4] bbox, 4 count,
#: 5 ok ∧ box_valid, 6 front.
Q_COLS = 44
QI_COLS = 8


# ------------------------------------------------------------- packers

def _conds(clip):                                 # (G, 3, 4) -> (G, 3, 6)
    x, y, z, w = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
    return torch.stack([x + w, w - x, y + w, w - y, z + w, w - z], dim=-1)


def face_flags(faces):
    """Per-face flag word: 1 valid | 2 clip_en | 4 z_write | 8 needs the
    per-pixel clip test (raster_pallas.face_flags :238). A clip-enabled face
    whose three vertices lie strictly inside every clip plane, of the
    camera and, when ``faces`` carries ``clip_dbg``, of the debug camera,
    passes the interpolated test at every interior pixel by convexity and
    skips it."""
    e_cam = _conds(faces["clip"]) * faces["inv_w"][..., None]
    all_inside = (e_cam > 0).all(dim=2).all(dim=1)
    if "clip_dbg" in faces:
        e_dbg = _conds(faces["clip_dbg"]) * faces["inv_w"][..., None]
        all_inside &= (e_dbg > 0).all(dim=2).all(dim=1)
    needs_ppc = faces["clip_en"] & ~all_inside
    i32 = lambda b: b.to(torch.int32)
    return (i32(faces["valid"]) | (i32(faces["clip_en"]) << 1)
            | (i32(faces["z_write"]) << 2) | (i32(needs_ppc) << 3))


def pack_faces(faces):
    """faces dict (ops/vertex.gather_faces layout) -> (G, 34) float32 table
    (raster_pallas.pack_faces :261 without the 128-lane padding; layout in
    raster_plain.F_*). Clip planes are pre-scaled per vertex:
    e[i, j] = inv_w[i] * cond_j(clip_i)."""
    g = faces["sx"].shape[0]
    e_cam = _conds(faces["clip"]) * faces["inv_w"][..., None]
    return torch.cat([faces["aff"], faces["inv_w"],
                      faces["bbox"].to(torch.float32),
                      e_cam.reshape(g, 18)], dim=1).contiguous()


def pack_debug_planes(faces):
    """The debug camera's clip planes of each face, pre-scaled as
    pack_faces' own: (G, 18) float32, e_dbg[i, j] = inv_w[i] *
    cond_j(clip_dbg_i) at 6*i + j (columns 34-52 of raster_pallas.pack_faces
    with a debug camera, kept in a table of their own so that the 34-column
    table and every kernel that reads only it stay as they are). None when
    ``faces`` has no ``clip_dbg`` (no debug camera)."""
    if "clip_dbg" not in faces:
        return None
    g = faces["sx"].shape[0]
    e_dbg = _conds(faces["clip_dbg"]) * faces["inv_w"][..., None]
    return e_dbg.reshape(g, rp.DBG_COLS).contiguous()


def pack_face_attrs(attrs):
    """Shading attribute dict -> (G, 42) float32 (raster_pallas.py:1245)."""
    g = attrs["world"].shape[0]
    f32 = lambda a: a.to(torch.float32)
    cols = [
        attrs["world"].reshape(g, 9),
        attrs["uv"][..., 0], attrs["uv"][..., 1],
        attrs["vn"].reshape(g, 9),
        attrs["kd"], attrs["ks"], attrs["ns"][:, None],
        f32(attrs["kd_slot"])[:, None], attrs["kd_shape"],
        f32(attrs["norm_slot"])[:, None], attrs["norm_shape"],
        f32(attrs["norm_tangent"])[:, None],
        f32(attrs["ks_slot"])[:, None], attrs["ks_shape"],
        f32(attrs["model_id"])[:, None],
    ]
    return torch.cat([f32(c) for c in cols], dim=1).contiguous()


def pack_quads(screen, counts, ok, height, width):
    """Clipped shadow polygons -> (qdata (E, 44) f32, qi (E, 8) int32)
    (raster_pallas.pack_quads :903 without the 128-lane padding).

    screen: (E, QUAD_PMAX, 4) viewport-space clipped polygons; counts: (E,)
    active vertex counts; ok: (E,) silhouette ∧ count >= 3.
    """
    e = screen.shape[0]
    dev = screen.device
    sx = screen[..., 0]
    sy = screen[..., 1]
    a = screen[:, 0, :3]
    nrm = _cross(a - screen[:, 1, :3], a - screen[:, 2, :3])
    d_coef = -_dot3(a, nrm)
    is_front = nrm[:, 2] < 0

    active = torch.arange(QUAD_PMAX, device=dev)[None, :] < counts[:, None]
    inf = float("inf")
    min_x = torch.clamp(torch.where(active, sx, inf).amin(1), min=0)
    max_x = torch.clamp(torch.where(active, sx, -inf).amax(1), max=width)
    min_y = torch.clamp(torch.where(active, sy, inf).amin(1), min=0)
    max_y = torch.clamp(torch.where(active, sy, -inf).amax(1), max=height)
    box_valid = ~((min_x > max_x) | (min_y > max_y))
    bbox = torch.ceil(torch.stack([min_x, max_x, min_y, max_y], 1))
    bbox = torch.where(torch.isfinite(bbox), bbox,
                       torch.zeros_like(bbox)).to(torch.int32)

    sx12 = torch.nan_to_num(sx, nan=0.0, posinf=3e38, neginf=-3e38)
    sy12 = torch.nan_to_num(sy, nan=0.0, posinf=3e38, neginf=-3e38)
    eA, eB, eK = quad_edge_coeffs(sx12, sy12, counts.to(torch.int32),
                                  is_front)
    # Plane depth as an affine function of the pixel: z_raw = zx*x+zy*y+zd
    # (edge-on quads with nrm.z == 0 cover no pixels).
    czs = torch.where(nrm[:, 2] == 0, torch.ones_like(nrm[:, 2]), nrm[:, 2])
    zx = -nrm[:, 0] / czs
    zy = -nrm[:, 1] / czs
    zd = -d_coef / czs
    qdata = torch.cat([eA, eB, eK, zx[:, None], zy[:, None], zd[:, None],
                       torch.zeros_like(zd)[:, None],
                       bbox.to(torch.float32)], dim=1).contiguous()
    qi = torch.zeros((e, QI_COLS), dtype=torch.int32, device=dev)
    qi[:, 0:4] = bbox
    qi[:, 4] = counts.to(torch.int32)
    qi[:, 5] = (ok & box_valid).to(torch.int32)
    qi[:, 6] = is_front.to(torch.int32)
    return qdata, qi


def quad_prep_plain(quad, order, n_rows, planes, mvp, viewport, height,
                    width):
    """K8's plain version: the quad tables of the first ``n_rows`` rows of
    ``order``. Row i < n_rows is ``quad[order[i]]`` clipped and projected
    (shadow.clip_project) and packed (:func:`pack_quads`, ok = count >= 3:
    every row it prepares is a silhouette edge's); the rows past the count
    are zero, so inactive. Reads the count on the host (the plain version
    serves the CPU path and, on the card, as the kernel's oracle).

    quad: (E, 4, 4) float32; order: (C,) int32 rows of ``quad``; n_rows: 0-d
    int32; planes (6, 4), mvp and viewport (4, 4) float32. Returns (qdata
    (C, 44) float32, qi (C, 8) int32).
    """
    from tpu_renderer_torch.ops.shadow import clip_project

    cap = order.shape[0]
    k = max(0, min(int(n_rows), cap))
    qdata = torch.zeros((cap, Q_COLS), dtype=torch.float32,
                        device=quad.device)
    qi = torch.zeros((cap, QI_COLS), dtype=torch.int32, device=quad.device)
    screen, counts = clip_project(
        quad[order[:k].long()],
        {"frustum_planes": planes, "MVP": mvp, "viewport": viewport})
    qdata[:k], qi[:k] = pack_quads(screen, counts, counts >= 3, height,
                                   width)
    return qdata, qi


def pack_slim_attrs(attrs, layout):
    """Shading attrs -> (G, SLIM_COLS[layout]) float32 slim face table,
    column for column as raster_pallas.pack_slim_attrs (:1278): flat the
    face normal; gouraud the 9 vertex-normal components; pbr those, then
    sx, sy, szlin per vertex, pm, pr and ka."""
    g = attrs["vn"].shape[0]
    if layout == "flat":
        cols = [attrs["face_normal"]]
    elif layout == "gouraud":
        cols = [attrs["vn"].reshape(g, 9)]
    elif layout == "pbr":
        cols = [attrs["vn"].reshape(g, 9),
                attrs["sx"], attrs["sy"], attrs["szlin"],
                attrs["pm"][:, None], attrs["pr"][:, None], attrs["ka"]]
    else:
        raise ValueError(f"unknown slim layout {layout!r}")
    return torch.cat([c.to(torch.float32) for c in cols], dim=1).contiguous()


#: Per-face shading attributes of a model's packet, which the vertex stage
#: hands on as they are.
FACE_ATTRS = ("uv", "kd", "ks", "ns", "pm", "pr", "ka", "kd_slot",
              "ks_slot", "norm_slot", "norm_tangent", "kd_shape", "ks_shape",
              "norm_shape")


def vertex_pass(verts, vid, cam, height, width, culling):
    """The one vertex pass of a frame, which every vertex stage reads: the
    stacked vertices ``verts`` (V, 4) through the camera ``cam`` (MVP,
    viewport, near, far), gathered per face through the ids ``vid`` (G, 3)
    (vertex.gather_faces, with its masks)."""
    va = transform_vertices(verts, cam["MVP"], cam["viewport"], cam["near"],
                            cam["far"])
    return gather_faces(va, vid, height, width, culling)


def face_batch(verts, ft, cam, height, width, culling, dbg_mvp=None):
    """Vertex stage + per-face gathers for every model at once
    (pipeline._build_face_batch :133 of the JAX package without the
    sampler-window fields; the attrs carry what every shader reads,
    :218-229): one transform of every model's vertices ``verts``, stacked
    in model order, one gather of every face through the offset ids of the
    face tables ``ft`` (:func:`vertex_pass`), one face normal. Every
    operation is elementwise or a row gather, so each face's values round
    as a pass over its model alone would. ``cam`` holds MVP, viewport, near
    and far. With the debug camera's ``dbg_mvp``, the raster dict also
    carries ``clip_dbg``, each face's vertices in its clip space
    (:175-178). Returns (raster dict, attrs dict) of per-face tensors, the
    faces in model order."""
    f = vertex_pass(verts, ft["vid"], cam, height, width, culling)
    world = f["world"]                                  # (G, 3, 3)
    face_normal = normalize(_cross(world[:, 1] - world[:, 0],
                                   world[:, 2] - world[:, 0]))
    # Faces without vertex normals shade with the face normal
    # (reference Face.get_normals fallback, core.py:186-187).
    vn = torch.where(ft["has_vn"][:, None, None], ft["vn"],
                     face_normal[:, None, :])
    faces = {
        "sx": f["sx"], "sy": f["sy"], "inv_w": f["inv_w"], "aff": f["aff"],
        "clip": f["clip"], "bbox": f["bbox"],
        "valid": f["valid"] & ft["pad_valid"],
        "clip_en": ft["clip_en"], "z_write": ft["z_write"],
    }
    if dbg_mvp is not None:
        # Elementwise in float32, as transform_vertices' clip space.
        faces["clip_dbg"] = _rowvec(verts, dbg_mvp)[ft["vid"]]
    attrs = {"sx": f["sx"], "sy": f["sy"], "szlin": f["szlin"],
             "world": world, "vn": vn, "face_normal": face_normal,
             **{k: ft[k] for k in FACE_ATTRS},
             "model_id": ft["model_id"]}
    return faces, attrs


def attr_consts(ft):
    """The packing constants K10 reads per face, from the face tables
    ``ft`` (pipeline.face_tables builds them with the tables): (G, C_COLS)
    float32, the general row of :func:`pack_face_attrs` with the world
    columns zero and vn as the tables hold it (zero for a model without
    vertex normals), then pm, pr and ka of :func:`pack_slim_attrs`' pbr
    row, each column cast as those packers cast it, and a zero column."""
    g = ft["vid"].shape[0]
    zero = torch.zeros((g, 3, 3), dtype=torch.float32, device=ft["vid"].device)
    general = pack_face_attrs({**ft, "world": zero})
    pbr = [ft["pm"][:, None], ft["pr"][:, None], ft["ka"], zero[:, 0, :1]]
    return torch.cat([general] + [c.to(torch.float32) for c in pbr],
                     dim=1).contiguous()


def face_bits(ft):
    """The per-face constant word K10 reads, (G,) int32 from the face
    tables ``ft``: FB_HAS_VN | FB_CLIP (clip_en) | FB_ZWRITE (z_write) |
    FB_REAL (pad_valid)."""
    i32 = lambda b: b.to(torch.int32)
    return (i32(ft["has_vn"]) * FB_HAS_VN | i32(ft["clip_en"]) * FB_CLIP
            | i32(ft["z_write"]) * FB_ZWRITE | i32(ft["pad_valid"]) * FB_REAL)


def vertex_faces_plain(verts, ft, cam, height, width, culling, layout,
                       dbg_mvp=None):
    """K10's plain version: :func:`face_batch`, then :func:`pack_faces`,
    :func:`face_flags`, :func:`pack_debug_planes` and the shading row of
    ``layout`` (:func:`pack_face_attrs` for "general", else
    :func:`pack_slim_attrs`). Returns (fdata (G, 34), flags (G,) int32,
    fdbg (G, 18) or None, rows (G, ROW_COLS[layout]), world (G, 3, 3))."""
    faces, attrs = face_batch(verts, ft, cam, height, width, culling,
                              dbg_mvp)
    rows = (pack_face_attrs(attrs) if layout == "general"
            else pack_slim_attrs(attrs, layout))
    return (pack_faces(faces), face_flags(faces), pack_debug_planes(faces),
            rows, attrs["world"])


def pack_lines(p0, p1, height, width):
    """Directed screen-space edges -> the wireframe kernel's tables
    (raster_pallas.pack_lines :2507, without the 128-lane padding and the
    tube coefficients: K6 walks each edge's bbox along its major axis).

    Replicates the reference DDA (line.py:6-16) in closed form: right-to-left
    normalization (dx > 0 swaps the endpoints), steps = max(|dx|, |dy|),
    ``int(steps)`` uniform float steps. A zero-length edge draws its start
    pixel; a sub-pixel edge (0 < steps < 1) draws nothing.

    p0, p1: (E, 3) float32 (x, y, z) endpoints, z linearized. Returns
    (ldata (E, L_COLS) float32, bbox (E, 4) int32 [x0, x1, y0, y1) windows
    clipped to the frame, 0 where not finite).
    """
    swap = (p1[:, 0] - p0[:, 0]) > 0
    a = torch.where(swap[:, None], p1, p0)
    b = torch.where(swap[:, None], p0, p1)
    d = b - a
    adx = torch.abs(d[:, 0])
    ady = torch.abs(d[:, 1])
    steps = torch.maximum(adx, ady)
    pt = steps == 0
    one = torch.ones_like(steps)
    stepv = d / torch.where(pt, one, steps)[:, None]
    nsteps = torch.where(pt, one, torch.floor(steps))
    majx = (pt | (adx >= ady)).to(torch.float32)
    ldata = torch.cat([a, stepv, nsteps[:, None], majx[:, None]], dim=1)

    x_lo = torch.floor(torch.minimum(a[:, 0], b[:, 0]))
    x_hi = torch.floor(torch.maximum(a[:, 0], b[:, 0])) + 1
    y_lo = torch.floor(torch.minimum(a[:, 1], b[:, 1]))
    y_hi = torch.floor(torch.maximum(a[:, 1], b[:, 1])) + 1
    bbox = torch.stack([torch.clamp(x_lo, 0, width), torch.clamp(x_hi, 0, width),
                        torch.clamp(y_lo, 0, height),
                        torch.clamp(y_hi, 0, height)], dim=1)
    bbox = torch.where(torch.isfinite(bbox), bbox, torch.zeros_like(bbox))
    return ldata.contiguous(), bbox.to(torch.int32).contiguous()


def stencil_scalars(near, far):
    """(2·near·far, far + near, far − near) in float32, as Python floats —
    the depth constants the stencil test reads (raster_pallas.py:1035).
    K4 reads them from a (3,) float32 tensor on the card (``zc`` of
    :func:`stencil`); the frame stages them with the camera matrices
    (pipeline.frame_inputs)."""
    near = torch.as_tensor(near, dtype=torch.float32)
    far = torch.as_tensor(far, dtype=torch.float32)
    return (float(2.0 * near * far), float(far + near), float(far - near))


def tile_bins(bbox, active, height, width, tile=TILE, row0=0):
    """Per-tile primitive lists in primitive order (a plain counterpart of
    raster_pallas.face_bins / _bin_quads, by bounding box only).

    bbox: (N, 4) int [x0, x1, y0, y1) windows in frame coordinates;
    active: (N,) bool; the tiles cover ``height`` rows from ``row0``
    (bin_primitives :153-160). Returns (offsets (T + 1,) int32, items (M,)
    int32): tile t = ty * tiles_x + tx lists items[offsets[t]:offsets[t +
    1]], ascending.
    """
    dev = bbox.device
    n_ty = -(-height // tile)
    n_tx = -(-width // tile)
    ty = torch.arange(n_ty, device=dev)[:, None] * tile + row0
    tx = torch.arange(n_tx, device=dev)[:, None] * tile
    b = bbox.to(torch.int64)
    ov_x = (b[None, :, 0] < tx + tile) & (b[None, :, 1] > tx)    # (Tx, N)
    ov_y = (b[None, :, 2] < ty + tile) & (b[None, :, 3] > ty)    # (Ty, N)
    ov = (ov_y[:, None, :] & ov_x[None, :, :] & active[None, None, :])
    ov = ov.reshape(n_ty * n_tx, -1)
    counts = ov.sum(1)
    offsets = torch.zeros(n_ty * n_tx + 1, dtype=torch.int64, device=dev)
    offsets[1:] = torch.cumsum(counts, 0)
    items = torch.nonzero(ov)[:, 1]          # row-major: tile, then order
    return offsets.to(torch.int32), items.to(torch.int32).contiguous()


def coarse_bins_plain(bbox, active, height, width, row0=0, n_rows=None):
    """The coarse lists csrc/bins.cu builds for K1 and K4: for each COARSE
    tile over ``height`` rows from ``row0`` (row-major), the active
    primitives whose bbox overlaps it, in table order.

    bbox: (N, 4) [x0, x1, y0, y1) windows, compared in their own type (K1's
    packed float windows as floats, K4's int32 ones as integers); active:
    (N,) bool; ``n_rows``: None, or a 0-d int32 tensor, the count of
    leading rows K4's lists scan (the rest count as inactive). Returns
    (counts (T,) int32, items (T, N) int32, -1 past each tile's count).
    """
    dev = bbox.device
    n = bbox.shape[0]
    if n_rows is not None:
        active = active & (torch.arange(n, device=dev) < n_rows)
    b = bbox if bbox.is_floating_point() else bbox.to(torch.int64)
    ty = torch.arange(-(-height // COARSE), device=dev,
                      dtype=b.dtype)[:, None] * COARSE + row0
    tx = torch.arange(-(-width // COARSE), device=dev,
                      dtype=b.dtype)[:, None] * COARSE
    ov_x = (b[None, :, 0] < tx + COARSE) & (b[None, :, 1] > tx)
    ov_y = (b[None, :, 2] < ty + COARSE) & (b[None, :, 3] > ty)
    ov = (ov_y[:, None, :] & ov_x[None, :, :] & active[None, None, :])
    ov = ov.reshape(-1, n)
    order = torch.arange(n, device=dev).expand_as(ov)
    items = torch.where(ov, order, n).sort(1).values
    items = torch.where(items < n, items, -1)
    return ov.sum(1).to(torch.int32), items.to(torch.int32)


def bin_scratch_bytes(n, height, width):
    """Bytes of the coarse lists K1's and K4's wrappers allocate for a table
    of ``n`` rows: a count and room for every row per COARSE tile."""
    return _coarse_tiles(height, width) * (max(n, 1) + 1) * 4


def _coarse_tiles(height, width):
    return -(-height // COARSE) * -(-width // COARSE)


def _bin_scratch(n, height, width, device):
    """(counts, items) int32 buffers for csrc/bins.cu, sized on the host.
    Raises ValueError above MAX_BIN_SCRATCH bytes."""
    need = bin_scratch_bytes(n, height, width)
    if need > MAX_BIN_SCRATCH:
        raise ValueError(
            f"coarse binning of {n} rows at {height}x{width} needs {need} "
            f"bytes of scratch ((H/{COARSE}) * (W/{COARSE}) * (rows + 1) * 4),"
            f" above MAX_BIN_SCRATCH = {MAX_BIN_SCRATCH}")
    tiles = _coarse_tiles(height, width)
    return (torch.empty(tiles, dtype=torch.int32, device=device),
            torch.empty(tiles * max(n, 1), dtype=torch.int32, device=device))


# ------------------------------------------------------------- plain versions

def visibility_plain(fdata, flags, height, width, sign, row0=0,
                     want_tid=True, fdbg=None):
    """K1's plain version: raster_plain's z pass then id pass.
    Returns (zb_sign (H, W) float32, tid (H, W) int32), or (zb_sign, None)
    with ``want_tid=False``."""
    return rp.render_visibility(fdata, flags, height, width, sign, row0=row0,
                                want_tid=want_tid, fdbg=fdbg)


def tidpass_plain(fdata, flags, zb_sign, sign, row0=0, gid0=0, fdbg=None):
    """K7's plain version: raster_plain's id pass against the given final
    z-buffer. Returns tid (H, W) int32, gid0 + face index or -1."""
    height, width = zb_sign.shape
    return rp.visibility_pass(fdata, flags, zb_sign, height, width, sign,
                              row0=row0, gid0=gid0, fdbg=fdbg)


def _owned(tid, gid0, g_local):
    """(face index (H, W) int64, 0 where not owned; owned (H, W) bool): the
    pixels whose id lies in ``[gid0, gid0 + g_local)``."""
    own = (tid >= gid0) & (tid < gid0 + g_local)
    return torch.where(own, tid - gid0, torch.zeros_like(tid)).long(), own


def gbuffer_plain(fdata, adata, tid, row0=0, gid0=0):
    """K2's plain version: a per-pixel gather of the winning face's rows,
    then _gb_interp_face's expressions term for term (raster_pallas.py:
    1322-1397), zero where the pixel's id is not one of this table's
    ``[gid0, gid0 + G)``. Returns (32, H, W) float32."""
    height, width = tid.shape
    fid, own = _owned(tid, gid0, fdata.shape[0])
    f = fdata[fid]                                     # (H, W, 34)
    a = adata[fid]                                     # (H, W, 42)
    rows, cols = rp._grid(height, width, tid.device, row0)
    co = lambda c: f[..., c]
    at = lambda c: a[..., c]
    v = co(0) * cols + co(1) * rows + co(2)
    w = co(3) * cols + co(4) * rows + co(5)
    u = 1.0 - v - w
    su, sv, sw = u * co(9), v * co(10), w * co(11)
    inv_s = 1.0 / (su + sv + sw)
    pb0, pb1, pb2 = su * inv_s, sv * inv_s, sw * inv_s

    def interp(c0, c1, c2):
        return pb0 * c0 + pb1 * c1 + pb2 * c2

    out = [None] * GB_CHANNELS
    wx = [at(i) for i in range(9)]
    for ci in range(3):
        out[GB_WORLD + ci] = interp(wx[ci], wx[3 + ci], wx[6 + ci])
    u0, u1, u2 = at(9), at(10), at(11)
    vv0, vv1, vv2 = at(12), at(13), at(14)
    out[GB_IU] = interp(u0, u1, u2)
    out[GB_IV] = interp(vv0, vv1, vv2)
    nv = [at(15 + i) for i in range(9)]
    n = [interp(nv[c], nv[3 + c], nv[6 + c]) for c in range(3)]
    for ci in range(3):
        out[GB_N + ci] = n[ci]
    # Tangent/bitangent via the adjugate of A = (b-a, c-a, n) (du2 = dv2 = 0).
    e1 = [wx[3] - wx[0], wx[4] - wx[1], wx[5] - wx[2]]
    e2 = [wx[6] - wx[0], wx[7] - wx[1], wx[8] - wx[2]]
    c0 = [e2[1] * n[2] - e2[2] * n[1],
          e2[2] * n[0] - e2[0] * n[2],
          e2[0] * n[1] - e2[1] * n[0]]
    c1 = [n[1] * e1[2] - n[2] * e1[1],
          n[2] * e1[0] - n[0] * e1[2],
          n[0] * e1[1] - n[1] * e1[0]]
    det = e1[0] * c0[0] + e1[1] * c0[1] + e1[2] * c0[2]
    inv_det = 1.0 / det
    du0, du1 = u1 - u0, u2 - u0
    dv0, dv1 = vv1 - vv0, vv2 - vv0
    for ci in range(3):
        out[GB_TAN + ci] = (c0[ci] * du0 + c1[ci] * du1) * inv_det
        out[GB_BIT + ci] = (c0[ci] * dv0 + c1[ci] * dv1) * inv_det
    for ci in range(3):
        out[GB_KD + ci] = at(24 + ci)
        out[GB_KS + ci] = at(27 + ci)
    out[GB_NS] = at(30)
    for off in range(10):                 # slots, shapes, tangent flag
        out[GB_KD_SLOT + off] = at(31 + off)
    out[GB_MODEL] = at(41)
    gb = torch.stack(out)
    return torch.where(own[None], gb, torch.zeros_like(gb))


def gbuffer_slim_plain(fdata, sdata, tid, layout, row0=0, gid0=0):
    """K5's plain version: a per-pixel gather of the winning face's rows,
    then _slim_interp_face's expressions term for term (raster_pallas.py:
    1294-1319) with RAW screen barycentrics u = 1 - v - w (no perspective
    correction, as the reference's flat/gouraud/pbr shaders), zero where
    the pixel's id is not one of ``[gid0, gid0 + G)``. Returns
    (SLIM_CHANNELS[layout], H, W) float32."""
    height, width = tid.shape
    fid, own = _owned(tid, gid0, fdata.shape[0])
    s = sdata[fid]                                     # (H, W, SLIM_COLS)
    at = lambda c: s[..., c]
    if layout == "flat":
        out = [at(ci) for ci in range(3)]
    else:
        f = fdata[fid]                                 # (H, W, 34)
        rows, cols = rp._grid(height, width, tid.device, row0)
        co = lambda c: f[..., c]
        v = co(0) * cols + co(1) * rows + co(2)
        w = co(3) * cols + co(4) * rows + co(5)
        u = 1.0 - v - w

        def interp(c0, c1, c2):
            return u * c0 + v * c1 + w * c2

        out = [interp(at(ci), at(3 + ci), at(6 + ci)) for ci in range(3)]
        if layout == "pbr":
            for ci in range(3):                    # sx / sy / z_lin triples
                b = 9 + 3 * ci
                out.append(interp(at(b), at(b + 1), at(b + 2)))
            out += [at(18), at(19)] + [at(20 + ci) for ci in range(3)]
    gb = torch.stack(out)
    return torch.where(own[None], gb, torch.zeros_like(gb))


def _wrap_clamped(x, dim):
    """pipeline._wrap_index (truncate, then numpy-style floor-mod wrap), then
    clamped into [0, dim - 1] before the integer cast so that no pixel can
    index outside its texture; NaN lands on 0. ``dim`` is float32."""
    i = torch.trunc(x)
    wrapped = i - dim * torch.floor(i / dim)
    wrapped = torch.where(wrapped >= 0, wrapped, torch.zeros_like(wrapped))
    wrapped = torch.where(wrapped <= dim - 1.0, wrapped, dim - 1.0)
    return wrapped.to(torch.int64)


def sample_textures_plain(tid, iu, iv, ftex, slots, pool, gid0=0):
    """K3's plain version: for each pixel won by one of ftex's faces (ids
    ``[gid0, gid0 + G)``) and each texture kind, the
    nearest texel at col = clip(iu, max=1)·(TW−1), row = (1 − clip(iv,
    max=1))·(TH−1), truncated and floor-mod wrapped (reference get_UV,
    core.py:138-143), gathered from the scene-wide texel pool.

    ftex: (G, N_KINDS, 3) int32 per-face (global slot or -1, TH, TW);
    slots: (S, 2) int32 (pool offset, row stride); pool: (P,) int32 packed
    RGB texels. A face's kind samples nothing where its slot is -1 or past
    ``slots``, or where its index falls outside ``pool``. Returns (samp
    (N_KINDS, H, W) int32, mask (H, W) int32 with bit k set where kind k
    was sampled).
    """
    idx, hit = texel_indices(tid, iu, iv, ftex, slots, pool, gid0)
    samp = []
    mask = torch.zeros(tid.shape, dtype=torch.int32, device=tid.device)
    for k in range(ftex.shape[1]):
        texel = pool[idx[k]] if pool.numel() else torch.zeros_like(tid)
        samp.append(torch.where(hit[k], texel, torch.zeros_like(texel)))
        mask |= hit[k].to(torch.int32) << k
    return torch.stack(samp).to(torch.int32), mask


def texel_indices(tid, iu, iv, ftex, slots, pool, gid0=0):
    """The pool index each pixel samples per kind, and where it samples
    (see sample_textures_plain). Returns (idx (N_KINDS, H, W) int64, 0
    where nothing is sampled; hit (N_KINDS, H, W) bool)."""
    fid, win = _owned(tid, gid0, ftex.shape[0])
    ciu = torch.clamp(iu, max=1.0)
    civ = torch.clamp(iv, max=1.0)
    n_slots = slots.shape[0]
    rows = torch.cat([slots.long(), slots.new_zeros((1, 2), dtype=torch.long)])
    idxs, hits = [], []
    for k in range(ftex.shape[1]):
        ft = ftex[:, k][fid]                              # (H, W, 3)
        slot = ft[..., 0]
        th = ft[..., 1].to(torch.float32)
        tw = ft[..., 2].to(torch.float32)
        col = _wrap_clamped(ciu * (tw - 1.0), tw)
        row = _wrap_clamped((1.0 - civ) * (th - 1.0), th)
        hit = win & (slot >= 0) & (slot < n_slots)
        # Pixels that sample nothing read the zero row past the table.
        st = rows[torch.where(hit, slot, n_slots).long()]
        idx = st[..., 0] + row * st[..., 1] + col
        hit &= (idx >= 0) & (idx < pool.numel())
        idxs.append(torch.where(hit, idx, torch.zeros_like(idx)))
        hits.append(hit)
    return torch.stack(idxs), torch.stack(hits)


def stencil_plain(qdata, qi, zb_sign, sign, zc, row0=0, n_rows=None,
                  chunk=16):
    """K4's plain version: the JAX package's _quad_fragments summed over the
    quads (see shadow.quad_fragments), on the rows from ``row0``; ``zc``
    holds (nf2, fpn, fmn), a (3,) float32 tensor or three floats;
    ``n_rows``: None (every row) or a 0-d int32 tensor, the count of
    leading table rows that take part. Returns (H, W) int32."""
    nf2, fpn, fmn = zc
    height, width = zb_sign.shape
    dev = zb_sign.device
    rows, cols = rp._grid(height, width, dev, row0)
    st = torch.zeros((height, width), dtype=torch.int32, device=dev)
    keep = qi[:, 5] > 0                  # quads without ok contribute 0
    if n_rows is not None:
        keep &= torch.arange(qi.shape[0], device=dev) < n_rows
    qdata, qi = qdata[keep], qi[keep]
    for q0 in range(0, qdata.shape[0], chunk):
        qrow = torch.cat([qdata[q0:q0 + chunk],
                          qi[q0:q0 + chunk, 5:7].to(torch.float32)], dim=1)
        st += quad_fragments(qrow, zb_sign, rows, cols, sign, nf2, fpn, fmn)
    return st


def lines_plain(ldata, bbox, active, zbuf, height, width):
    """K6's plain version: lines_pallas's per-pixel closed-form DDA
    inversion (raster_pallas.py:2621-2640), vectorised over pixels and
    chunks of edges.

    A pixel is lit iff some active edge's DDA pixel lands on it inside the
    edge's bbox, inside 0 < row < h-1, 0 < col < w-1, and passes the strict
    ``zbuf - z > 0`` test (no handedness sign: the reference hard-codes it).
    Along the major axis the step is exactly -1 in x (right-to-left) or
    +-1 in y, so the step index is k = floor(x0 - col) or the matching
    ceil/floor in y, and the pixel is on the line iff the minor axis floors
    to it. Returns (H, W) int32.
    """
    dev = zbuf.device
    rows = torch.arange(height, dtype=torch.float32, device=dev)[:, None]
    cols = torch.arange(width, dtype=torch.float32, device=dev)[None]
    inframe = (rows > 0) & (rows < height - 1) & (cols > 0) & (cols < width - 1)
    keep = active.to(torch.bool)
    ldata, bbox = ldata[keep], bbox[keep]
    chunk = max(1, (1 << 24) // (height * width))    # edges per pass
    lit_any = torch.zeros((height, width), dtype=torch.bool, device=dev)
    for e0 in range(0, ldata.shape[0], chunk):
        ld = ldata[e0:e0 + chunk, :, None, None]
        bb = bbox[e0:e0 + chunk, :, None, None]
        x0, y0, z0 = ld[:, 0], ld[:, 1], ld[:, 2]
        sxv, syv, szv = ld[:, 3], ld[:, 4], ld[:, 5]
        nst = ld[:, 6]
        majx = ld[:, 7] > 0
        k_x = torch.floor(x0 - cols)
        k_y = torch.where(syv > 0, torch.ceil(rows - y0), torch.floor(y0 - rows))
        kk = torch.where(majx, k_x, k_y)
        other = torch.where(majx, torch.floor(y0 + kk * syv) - rows,
                            torch.floor(x0 + kk * sxv) - cols)
        inbox = ((cols >= bb[:, 0]) & (cols < bb[:, 1])
                 & (rows >= bb[:, 2]) & (rows < bb[:, 3]))
        lit = (other == 0) & (kk >= 0) & (kk < nst) & inbox
        z = z0 + kk * szv
        lit_any |= (lit & (zbuf - z > 0)).any(0)
    return (lit_any & inframe).to(torch.int32)


def shade_scale_off(cfg, dyn, device):
    """K9's model table: (M, N_KINDS, 2) float32, each model's texture
    (scale, offset) per kind of :data:`KINDS` (models/scene.py
    _texture_stack), zeros where the model has no such map (K3 samples no
    kind a model lacks, so those rows are never read). Built on
    ``device`` from the models' tensors, with no copy from the host."""
    has = {"kd": "has_map_kd", "norm": "has_norm", "ks": "has_map_ks"}
    zero = torch.zeros(2, dtype=torch.float32, device=device)
    rows = [md[f"{kind}_scale_off"] if getattr(mc, has[kind]) else zero
            for mc, md in zip(cfg.models, dyn["models"]) for kind in KINDS]
    return torch.stack(rows).reshape(len(cfg.models), N_KINDS, 2)


def _unpack_texel(packed, scale, offset):
    """RGB-packed int32 texels -> float RGB under the (scale, offset)
    dequantization affine (models/scene.py _texture_stack)."""
    r = (packed & 0xFF).to(torch.float32)
    g = ((packed >> 8) & 0xFF).to(torch.float32)
    b = ((packed >> 16) & 0xFF).to(torch.float32)
    rgb = torch.stack([r, g, b], dim=-1) / 255.0
    return rgb * scale + offset


def shade_plain(tid, stencil, gb, samp, samp_mask, scale_off, light,
                position, background):
    """K9's plain version: the general shader's deferred shading
    (pipeline._shade_gbuffer :388 of the JAX package, sampler branch, then
    shading.shade_general), the texture maps' (scale, offset) looked up per
    pixel by its model id.

    tid (H, W) int32; stencil (H, W) int32, or None without shadows; gb the
    (32, H, W) float32 G-buffer; samp (N_KINDS, H, W) int32 and samp_mask
    (H, W) int32 (K3's), or both None where no model has a map; scale_off
    (M, N_KINDS, 2) float32 (:func:`shade_scale_off`); light the frame's
    light dict (its tensors, ``direction`` and ``light_type``); position
    (3,) the camera's; background (3,) a colour or (H, W, 3) the skybox.
    Kind k's sample replaces the G-buffer's value where bit k of samp_mask
    is set and the pixel's model id is a row of scale_off. Returns the
    (H, W, 3) float32 frame.
    """
    vec = lambda c: torch.movedim(gb[c:c + 3], 0, -1)
    n_base = normalize(vec(GB_N))
    color, normal = vec(GB_KD), n_base
    specular_light = vec(GB_KS) * 255.0
    if samp is not None:
        model_id = gb[GB_MODEL]
        m = model_id.to(torch.int64)
        known = ((m >= 0) & (m < scale_off.shape[0])
                 & (m.to(torch.float32) == model_id))
        so = scale_off[torch.where(known, m, torch.zeros_like(m))]

        def sampled(k):
            rgb = _unpack_texel(samp[k], so[..., k, 0:1], so[..., k, 1:2])
            return rgb, known & (((samp_mask >> k) & 1) > 0)

        rgb, mask = sampled(0)
        color = torch.where(mask[..., None], rgb, color)
        s, mask = sampled(1)
        tangent_n = (normalize(vec(GB_TAN)) * s[..., 0:1] +
                     normalize(vec(GB_BIT)) * s[..., 1:2] +
                     n_base * s[..., 2:3])
        is_tangent = gb[GB_NORM_SLOT + 3] > 0.5
        mapped = torch.where(is_tangent[..., None], tangent_n, s)
        normal = torch.where(mask[..., None], normalize(mapped), n_base)
        rgb, mask = sampled(2)
        specular_light = torch.where(mask[..., None], rgb[..., 0:1] * 255.0,
                                     specular_light)
    pix = {"color": color, "normal": normal, "frag_world": vec(GB_WORLD),
           "specular_light": specular_light, "ns": gb[GB_NS][..., None]}
    rgb = sh.shade_general(pix, light, position, shadows_mask=(
        None if stencil is None else stencil != 0))
    return torch.where((tid < 0)[..., None], background, rgb)


# ------------------------------------------------------------- wrappers

def _on_cpu(*tensors):
    """True when every tensor lies on the CPU (the plain path); False when
    every one lies on a CUDA device (the kernel path); raises otherwise."""
    kinds = {t.device.type for t in tensors}
    if kinds == {"cpu"}:
        return True
    if kinds == {"cuda"} and len({t.device for t in tensors}) == 1:
        return False
    raise RuntimeError(f"kernel inputs must all lie on the CPU or all on one "
                       f"CUDA device, got {[str(t.device) for t in tensors]}")


def _require(t, name, dtype, shape):
    if t.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {t.dtype}")
    if len(shape) != t.dim() or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def _require_aligned(t, name, align):
    """The kernel stages rows of ``t`` with ``align``-byte copies."""
    if t.data_ptr() % align:
        raise ValueError(f"{name}: must start on a {align}-byte boundary")


def _launch(name, *args, counter=None):
    """Launch ``tr_<name>`` on the current stream; raise if the launch
    fails, else add one to ``LAUNCHES[counter or name]`` (or to the tally
    of the capture in progress, :func:`counting_into`)."""
    from tpu_renderer_torch.ops import _build

    stream = torch.cuda.current_stream().cuda_stream
    rc = getattr(_build.load(), f"tr_{name}")(*args, stream)
    if rc != 0:
        raise RuntimeError(f"CUDA kernel {name} failed to launch: "
                           f"cudaError {rc}")
    key = counter or name
    _counts[key] = _counts.get(key, 0) + 1


def _face_tables(fdata, flags, fdbg):
    """Check K1's and K7's face tables for a launch: fdata (G, 34) and fdbg
    (G, 18) or None float32, 8-byte aligned (their rows are staged by
    8-byte copies); flags (G,) int32. Returns G."""
    g = fdata.shape[0]
    _require(fdata, "fdata", torch.float32, (g, rp.F_COLS))
    _require(flags, "flags", torch.int32, (g,))
    _require_aligned(fdata, "fdata", 8)
    if fdbg is not None:
        _require(fdbg, "fdbg", torch.float32, (g, rp.DBG_COLS))
        _require_aligned(fdbg, "fdbg", 8)
    return g


def _ptr(t):
    return None if t is None else t.data_ptr()


def visibility(fdata, flags, height, width, sign, row0=0, want_tid=True,
               fdbg=None):
    """K1: final sign-space z-buffer and winning face index per pixel, for
    ``height`` rows from ``row0``.

    fdata: (G, 34) float32 (pack_faces); flags: (G,) int32 (face_flags);
    fdbg: (G, 18) float32 (pack_debug_planes) with a debug camera, else
    None. Returns (zb_sign (H, W) float32, tid (H, W) int32, -1 =
    background), or (zb_sign, None) with ``want_tid=False`` (z-only mode,
    counted as ``visibility_z``; with fdbg, ``visibility_dbg`` and
    ``visibility_z_dbg``).
    """
    tensors = (fdata, flags) if fdbg is None else (fdata, flags, fdbg)
    if _on_cpu(*tensors):
        return visibility_plain(fdata, flags, height, width, sign, row0,
                                want_tid, fdbg)
    g = _face_tables(fdata, flags, fdbg)
    counts, items = _bin_scratch(g, height, width, fdata.device)
    zb = torch.empty((height, width), dtype=torch.float32,
                     device=fdata.device)
    tid = (torch.empty((height, width), dtype=torch.int32,
                       device=fdata.device) if want_tid else None)
    counter = ("visibility" if want_tid else "visibility_z") + (
        "" if fdbg is None else "_dbg")
    _launch("visibility", fdata.data_ptr(), flags.data_ptr(), _ptr(fdbg), g,
            counts.data_ptr(), items.data_ptr(), height, width, row0,
            float(sign), int(want_tid), zb.data_ptr(), _ptr(tid),
            counter=counter)
    return zb, tid


def tidpass(fdata, flags, zb_sign, sign, row0=0, gid0=0, fdbg=None):
    """K7: winning face ids against the given final z-buffer ``zb_sign``
    (H, W) float32, for its rows from ``row0``: gid0 + the last face index
    that covers the pixel and passes ``zb >= z * sign``, -1 elsewhere.
    fdata, flags, fdbg as for :func:`visibility` (launches with fdbg count
    as ``tidpass_dbg``). Returns (H, W) int32."""
    tensors = (fdata, flags, zb_sign) + (() if fdbg is None else (fdbg,))
    if _on_cpu(*tensors):
        return tidpass_plain(fdata, flags, zb_sign, sign, row0, gid0, fdbg)
    g = _face_tables(fdata, flags, fdbg)
    height, width = zb_sign.shape
    _require(zb_sign, "zb_sign", torch.float32, (height, width))
    counts, items = _bin_scratch(g, height, width, fdata.device)
    tid = torch.empty((height, width), dtype=torch.int32, device=fdata.device)
    _launch("tidpass", fdata.data_ptr(), flags.data_ptr(), _ptr(fdbg), g,
            counts.data_ptr(), items.data_ptr(), zb_sign.data_ptr(), height,
            width, row0, gid0, float(sign), tid.data_ptr(),
            counter="tidpass" + ("" if fdbg is None else "_dbg"))
    return tid


def gbuffer(fdata, adata, tid, row0=0, gid0=0):
    """K2: the 32-channel G-buffer of each pixel won by one of the table's
    faces (ids ``[gid0, gid0 + G)``), zero elsewhere, rows from ``row0``.
    fdata (G, 34), adata (G, 42) float32; tid (H, W) int32."""
    if _on_cpu(fdata, adata, tid):
        return gbuffer_plain(fdata, adata, tid, row0, gid0)
    g = fdata.shape[0]
    height, width = tid.shape
    _require(fdata, "fdata", torch.float32, (g, rp.F_COLS))
    _require(adata, "adata", torch.float32, (g, A_COLS))
    _require(tid, "tid", torch.int32, (height, width))
    gb = torch.empty((GB_CHANNELS, height, width), dtype=torch.float32,
                     device=tid.device)
    _launch("gbuffer", fdata.data_ptr(), adata.data_ptr(), tid.data_ptr(),
            height, width, row0, gid0, g, gb.data_ptr())
    return gb


def sample_textures(tid, iu, iv, ftex, slots, pool, gid0=0):
    """K3: nearest-texel samples per kind and the sampled-kind bitmask of
    the pixels won by ftex's faces (see sample_textures_plain for the
    arguments), 4 pixels a thread over the flat frame. iu and iv may be
    planes of the G-buffer: where a plane is not 16-byte aligned, the
    kernel's scalar instance runs instead of its 16-byte one."""
    if _on_cpu(tid, iu, iv, ftex, slots, pool):
        return sample_textures_plain(tid, iu, iv, ftex, slots, pool, gid0)
    height, width = tid.shape
    g, n_kinds = ftex.shape[0], ftex.shape[1]
    _require(tid, "tid", torch.int32, (height, width))
    _require(iu, "iu", torch.float32, (height, width))
    _require(iv, "iv", torch.float32, (height, width))
    _require(ftex, "ftex", torch.int32, (g, n_kinds, 3))
    _require(slots, "slots", torch.int32, (None, 2))
    _require(pool, "pool", torch.int32, (None,))
    if not 0 < n_kinds <= 8 or pool.numel() >= 2 ** 31:
        raise ValueError("sample_textures: 1-8 kinds and < 2**31 texels")
    samp = torch.empty((n_kinds, height, width), dtype=torch.int32,
                       device=tid.device)
    mask = torch.empty((height, width), dtype=torch.int32, device=tid.device)
    _launch("sample_textures", tid.data_ptr(), iu.data_ptr(), iv.data_ptr(),
            ftex.data_ptr(), slots.data_ptr(), pool.data_ptr(), n_kinds,
            slots.shape[0], pool.numel(), height, width, gid0, g,
            samp.data_ptr(), mask.data_ptr())
    return samp, mask


def stencil(qdata, qi, zb_sign, sign, zc, row0=0, n_rows=None):
    """K4: signed shadow-volume stencil against the final z-buffer.

    qdata (E, 44) float32, qi (E, 8) int32 (:func:`quad_prep` or
    :func:`pack_quads`); zb_sign (H, W) float32, the rows from ``row0``;
    sign ±1; zc (3,) float32 on the same device, :func:`stencil_scalars`'
    (nf2, fpn, fmn), which K4 reads through its pointer; n_rows None (every
    row) or a 0-d int32 tensor on the same device, the count of leading
    rows K4 bins, which it reads through its pointer (quad_prep's count).
    Returns (H, W) int32.
    """
    tensors = (qdata, qi, zb_sign, zc) + (() if n_rows is None else
                                          (n_rows,))
    if _on_cpu(*tensors):
        return stencil_plain(qdata, qi, zb_sign, sign, zc, row0, n_rows)
    e = qdata.shape[0]
    height, width = zb_sign.shape
    _require(qdata, "qdata", torch.float32, (e, Q_COLS))
    _require(qi, "qi", torch.int32, (e, QI_COLS))
    _require(zb_sign, "zb_sign", torch.float32, (height, width))
    _require(zc, "zc", torch.float32, (3,))
    if n_rows is not None:
        _require(n_rows, "n_rows", torch.int32, ())
    _require_aligned(qdata, "qdata", 16)
    counts, items = _bin_scratch(e, height, width, zb_sign.device)
    st = torch.empty((height, width), dtype=torch.int32,
                     device=zb_sign.device)
    _launch("stencil", qdata.data_ptr(), qi.data_ptr(), e, _ptr(n_rows),
            counts.data_ptr(), items.data_ptr(), zb_sign.data_ptr(), height,
            width, row0, float(sign), zc.data_ptr(), st.data_ptr())
    return st


#: Quads a block of K8 prepares at once: 256 threads, a half-warp each
#: (mirrors GROUPS_PER_BLOCK in csrc/quad_prep.cu, where the kernel fixes it).
QUAD_PREP_GROUPS_PER_BLOCK = 16
#: K8's persistent grid per CUDA device index (:func:`quad_prep_grid`).
_PREP_BLOCKS = {}


def quad_prep_grid(device):
    """(blocks, groups) of K8's persistent grid on the CUDA ``device``: its
    SMs times the blocks resident on one, 16 quads (groups) a block. Asked
    of the card at the first call on the device (a graph's capture comes
    after an eager warm-up, so never inside one) and cached; the grid does
    not depend on the table's capacity or the count."""
    from tpu_renderer_torch.ops import _build

    device = torch.device(device)
    idx = (device.index if device.index is not None
           else torch.cuda.current_device())
    if idx not in _PREP_BLOCKS:
        blocks = ctypes.c_int(0)
        with torch.cuda.device(idx):
            err = _build.load().tr_quad_prep_blocks(ctypes.byref(blocks))
        if err != 0 or blocks.value < 1:
            raise RuntimeError(f"quad_prep: no persistent grid on cuda:{idx}"
                               f" (cudaError {err}, {blocks.value} blocks)")
        _PREP_BLOCKS[idx] = blocks.value
    blocks = _PREP_BLOCKS[idx]
    return blocks, blocks * QUAD_PREP_GROUPS_PER_BLOCK


def quad_prep(quad, order, n_rows, planes, mvp, viewport, height, width):
    """K8: the stencil kernel's quad tables of the silhouette quads (see
    quad_prep_plain for the arguments), a half-warp per quad on a
    persistent grid (:func:`quad_prep_grid`): rows below ``n_rows``, which
    the kernel reads through its pointer, are clipped, projected and
    packed, the rest written as zeros. Returns (qdata (C, 44) float32, qi
    (C, 8) int32)."""
    if _on_cpu(quad, order, n_rows, planes, mvp, viewport):
        return quad_prep_plain(quad, order, n_rows, planes, mvp, viewport,
                               height, width)
    e, cap = quad.shape[0], order.shape[0]
    _require(quad, "quad", torch.float32, (e, 4, 4))
    _require(order, "order", torch.int32, (cap,))
    _require(n_rows, "n_rows", torch.int32, ())
    _require(planes, "planes", torch.float32, (6, 4))
    _require(mvp, "mvp", torch.float32, (4, 4))
    _require(viewport, "viewport", torch.float32, (4, 4))
    blocks, _ = quad_prep_grid(quad.device)
    qdata = torch.empty((cap, Q_COLS), dtype=torch.float32,
                        device=quad.device)
    qi = torch.empty((cap, QI_COLS), dtype=torch.int32, device=quad.device)
    # The zero rows are written 16 bytes a store.
    _require_aligned(qdata, "qdata", 16)
    _require_aligned(qi, "qi", 16)
    _launch("quad_prep", quad.data_ptr(), order.data_ptr(), cap,
            n_rows.data_ptr(), planes.data_ptr(), mvp.data_ptr(),
            viewport.data_ptr(), height, width, qdata.data_ptr(),
            qi.data_ptr(), blocks)
    return qdata, qi


def gbuffer_slim(fdata, sdata, tid, layout, row0=0, gid0=0):
    """K5: the slim G-buffer (SLIM_CHANNELS[layout] planes) of each pixel
    won by one of the table's faces (ids ``[gid0, gid0 + G)``), zero
    elsewhere, rows from ``row0``. fdata (G, 34) float32 (pack_faces);
    sdata (G, SLIM_COLS[layout]) float32 (pack_slim_attrs); tid (H, W)
    int32; layout "flat", "gouraud" or "pbr"."""
    if _on_cpu(fdata, sdata, tid):
        return gbuffer_slim_plain(fdata, sdata, tid, layout, row0, gid0)
    g = fdata.shape[0]
    height, width = tid.shape
    _require(fdata, "fdata", torch.float32, (g, rp.F_COLS))
    _require(sdata, "sdata", torch.float32, (g, SLIM_COLS[layout]))
    _require(tid, "tid", torch.int32, (height, width))
    gb = torch.empty((SLIM_CHANNELS[layout], height, width),
                     dtype=torch.float32, device=tid.device)
    _launch("gbuffer_slim", fdata.data_ptr(), sdata.data_ptr(),
            tid.data_ptr(), SLIM_LAYOUT_ID[layout], height, width, row0, gid0,
            g, gb.data_ptr())
    return gb


def lines(ldata, bbox, active, zbuf, height, width):
    """K6: the wireframe mask, (H, W) int32 (1 = lit; see lines_plain).

    ldata (E, 8) float32 and bbox (E, 4) int32 from :func:`pack_lines`;
    active (E,) bool; zbuf (H, W) float32, the real (not sign-space)
    z-buffer.
    """
    if _on_cpu(ldata, bbox, active, zbuf):
        return lines_plain(ldata, bbox, active, zbuf, height, width)
    e = ldata.shape[0]
    _require(ldata, "ldata", torch.float32, (e, L_COLS))
    _require(bbox, "bbox", torch.int32, (e, 4))
    _require(active, "active", torch.bool, (e,))
    _require(zbuf, "zbuf", torch.float32, (height, width))
    mask = torch.empty((height, width), dtype=torch.int32, device=zbuf.device)
    _launch("lines", ldata.data_ptr(), bbox.data_ptr(), active.data_ptr(), e,
            zbuf.data_ptr(), height, width, mask.data_ptr())
    return mask


#: The light's entries in K9's light table (:func:`_light_table`).
_LIGHT_KEYS = ("position", "direction", "color", "ambient",
               "specular_strength", "constant", "linear", "quadratic")
#: The spot cone's smoothstep as PyTorch computes it on the card
#: (shading.smoothstep): x - cos 20°, times the float32 reciprocal of
#: cos 10° - cos 20°.
_SPOT_EDGE0 = float(torch.tensor(sh._COS20, dtype=torch.float32))
_SPOT_SCALE = float(torch.tensor(1.0) / torch.tensor(sh._COS10 - sh._COS20,
                                                     dtype=torch.float32))


def _light_table(light, position):
    """K9's light table, (19,) float32 on the light's device: the light's
    position, direction, color, ambient (3 each), specular_strength,
    constant, linear and quadratic, then the camera ``position``."""
    return torch.cat([light[k].reshape(-1) for k in _LIGHT_KEYS]
                     + [position.reshape(-1)])


def shade(tid, stencil, gb, samp, samp_mask, scale_off, light, position,
          background):
    """K9: the general shader's deferred shading of the frame in one launch
    (see shade_plain for the arguments), 4 pixels a thread over the flat
    frame (one where a plane is not 16-byte aligned); the light type,
    shadows (a stencil given) and the background kind (a (3,) colour or an
    (H, W, 3) plane) pick the kernel's instance. Returns the (H, W, 3)
    float32 frame."""
    table = [light[k] for k in _LIGHT_KEYS]
    maps = () if samp is None else (samp, samp_mask, scale_off)
    tensors = (tid, gb, position, background, *table, *maps) + (
        () if stencil is None else (stencil,))
    if _on_cpu(*tensors):
        return shade_plain(tid, stencil, gb, samp, samp_mask, scale_off,
                           light, position, background)
    height, width = tid.shape
    _require(tid, "tid", torch.int32, (height, width))
    if stencil is not None:
        _require(stencil, "stencil", torch.int32, (height, width))
    _require(gb, "gb", torch.float32, (GB_CHANNELS, height, width))
    if (samp is None) != (samp_mask is None):
        raise ValueError("shade: samp and samp_mask come together")
    if samp is not None:
        _require(samp, "samp", torch.int32, (N_KINDS, height, width))
        _require(samp_mask, "samp_mask", torch.int32, (height, width))
        _require(scale_off, "scale_off", torch.float32, (None, N_KINDS, 2))
    sky = background.dim() != 1
    _require(background, "background", torch.float32,
             (height, width, 3) if sky else (3,))
    lt = _light_table(light, position)
    _require(lt, "light", torch.float32, (19,))
    out = torch.empty((height, width, 3), dtype=torch.float32,
                      device=tid.device)
    _launch("shade", tid.data_ptr(), _ptr(stencil), gb.data_ptr(),
            _ptr(samp), _ptr(samp_mask), _ptr(scale_off),
            0 if samp is None else scale_off.shape[0], lt.data_ptr(),
            Lightning(light["light_type"]).value, background.data_ptr(),
            int(sky), _SPOT_EDGE0, _SPOT_SCALE, height, width,
            out.data_ptr())
    return out


def vertex_faces(verts, ft, cam, height, width, culling, layout,
                 dbg_mvp=None):
    """K10: the frame's vertex stage in one launch, one thread per face
    (see vertex_faces_plain for the arguments and outputs). The kernel
    reads the face tables' ``vid``, ``attr_consts`` and ``face_bits``, and
    the camera's MVP, viewport, near and far (and ``dbg_mvp``) through
    their pointers, so a captured frame replays with each frame's camera.
    Counted as ``vertex``, with a debug camera as ``vertex_dbg``. The
    general row holds the world positions in its first 9 columns, and
    ``world`` is a view of them; a slim layout's come in a (G, 3, 3)
    table of their own."""
    cam_t = (cam["MVP"], cam["viewport"], cam["near"], cam["far"])
    tensors = (verts, ft["vid"], ft["attr_consts"], ft["face_bits"],
               *cam_t) + (() if dbg_mvp is None else (dbg_mvp,))
    if _on_cpu(*tensors):
        return vertex_faces_plain(verts, ft, cam, height, width, culling,
                                  layout, dbg_mvp)
    vid, consts, bits = ft["vid"], ft["attr_consts"], ft["face_bits"]
    g = vid.shape[0]
    _require(verts, "verts", torch.float32, (None, 4))
    _require_aligned(verts, "verts", 16)
    _require(vid, "vid", torch.int64, (g, 3))
    _require(consts, "attr_consts", torch.float32, (g, C_COLS))
    _require_aligned(consts, "attr_consts", 16)
    _require(bits, "face_bits", torch.int32, (g,))
    for name, t, shape in zip(("MVP", "viewport", "near", "far"), cam_t,
                              ((4, 4), (4, 4), (), ())):
        _require(t, name, torch.float32, shape)
    if dbg_mvp is not None:
        _require(dbg_mvp, "dbg_mvp", torch.float32, (4, 4))
    dev = verts.device
    empty = lambda *shape: torch.empty(shape, dtype=torch.float32, device=dev)
    fdata = empty(g, rp.F_COLS)
    flags = torch.empty((g,), dtype=torch.int32, device=dev)
    fdbg = None if dbg_mvp is None else empty(g, rp.DBG_COLS)
    rows = empty(g, ROW_COLS[layout])
    general = layout == "general"
    world = rows[:, :9].view(g, 3, 3) if general else empty(g, 3, 3)
    _launch("vertex", verts.data_ptr(), vid.data_ptr(), consts.data_ptr(),
            bits.data_ptr(), *(t.data_ptr() for t in cam_t), _ptr(dbg_mvp),
            g, height, width, int(culling), VERTEX_LAYOUTS.index(layout),
            fdata.data_ptr(), flags.data_ptr(), _ptr(fdbg), rows.data_ptr(),
            None if general else world.data_ptr(),
            counter="vertex" + ("" if dbg_mvp is None else "_dbg"))
    return fdata, flags, fdbg, rows, world


def overlay_plain(table, frame, zbuf, sign, counter):
    """K11's plain version: ops/overlay.draw_segments of the segment table
    ``table`` (S, SEG_COLS) float64 on the host, over ``frame`` (H, W, 3)
    and ``zbuf`` (H, W) float64, in place (on a CUDA device through a copy
    on the host); the line pixels are added to ``counter``, a (1,) int64
    tensor on their device. Returns (frame, zbuf, counter)."""
    host = frame.device.type == "cpu"
    f, z = (frame.numpy(), zbuf.numpy()) if host else (
        frame.cpu().numpy(), zbuf.cpu().numpy())
    pixels = ov.draw_segments(table.numpy(), f, z, sign)
    if not host:
        frame.copy_(torch.from_numpy(f))
        zbuf.copy_(torch.from_numpy(z))
    counter += pixels
    return frame, zbuf, counter


#: Points K11 takes in one segment row: 64 a thread of its one block.
MAX_SEGMENT_POINTS = 64 * 1024


def overlay(table, frame, zbuf, sign, counter):
    """K11: the debug camera's frustum drawn over ``frame`` (H, W, 3) and
    ``zbuf`` (H, W) float64, in place, from the segment table ``table``
    (S, SEG_COLS) float64 on the host (ops/overlay.frustum_segments), with
    numpy's semantics (see overlay_plain); the line pixels that pass the
    depth test are added to ``counter``, a (1,) int64 tensor on the frame's
    device, which the host does not read. Returns (frame, zbuf, counter).
    On the card the table goes up in one copy from pinned memory (the
    ``overlay`` copy site), and the kernel draws in one block."""
    if _on_cpu(frame, zbuf, counter):
        return overlay_plain(table, frame, zbuf, sign, counter)
    height, width = zbuf.shape
    rows = table.shape[0]
    _require(table, "table", torch.float64, (rows, ov.SEG_COLS))
    if table.device.type != "cpu":
        raise ValueError("overlay: the segment table lies on the host")
    _require(frame, "frame", torch.float64, (height, width, 3))
    _require(zbuf, "zbuf", torch.float64, (height, width))
    _require(counter, "counter", torch.int64, (1,))
    if rows > ov.MAX_SEGMENTS or (
            rows and table[:, 6].max() > MAX_SEGMENT_POINTS):
        raise ValueError(f"overlay: at most {ov.MAX_SEGMENTS} rows of "
                         f"{MAX_SEGMENT_POINTS} points")
    dev = frame.device
    # The upload is the ``overlay`` copy site (utils/profiling.py).
    profiling.count_copies("overlay", profiling.tally([(table, "cpu", dev)]))
    table = table.pin_memory().to(dev, non_blocking=True)
    scratch = torch.zeros(2 * height * width, dtype=torch.int32, device=dev)
    _launch("overlay", table.data_ptr(), rows, frame.data_ptr(),
            zbuf.data_ptr(), height, width, float(sign), scratch.data_ptr(),
            counter.data_ptr())
    return frame, zbuf, counter


def overlay_quantize_plain(frame):
    """K12's plain version: ``(clip(frame[::-1] ** 0.8, 0, 1) * 255)`` cast
    to uint8 in numpy, from ``frame`` (H, W, 3) float64; returns the (H, W,
    3) uint8 tensor on the frame's device."""
    f = frame.cpu().numpy()
    out = (np.clip(f[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)
    return torch.from_numpy(out).to(frame.device)


def overlay_quantize(frame):
    """K12: the flip, gamma 0.8, clip to [0, 1], x255 and truncation to
    uint8 of ``frame`` (H, W, 3) float64, all in float64 (see
    overlay_quantize_plain). Returns (H, W, 3) uint8."""
    if _on_cpu(frame):
        return overlay_quantize_plain(frame)
    height, width = frame.shape[:2]
    _require(frame, "frame", torch.float64, (height, width, 3))
    if height > 65535:
        raise ValueError("overlay_quantize: at most 65,535 rows")
    out = torch.empty((height, width, 3), dtype=torch.uint8,
                      device=frame.device)
    _launch("overlay_quantize", frame.data_ptr(), out.data_ptr(), height,
            width)
    return out


class _Ops:
    """The per-frame raster operations render_core and render_debug_frame
    call, and the debug camera's overlay that Scene.render draws after
    render_core."""

    def __init__(self, visibility, gbuffer, sample_textures, stencil,
                 gbuffer_slim, lines, tidpass, quad_prep, shade, vertex_faces,
                 overlay, overlay_quantize):
        self.visibility = visibility
        self.gbuffer = gbuffer
        self.sample_textures = sample_textures
        self.stencil = stencil
        self.gbuffer_slim = gbuffer_slim
        self.lines = lines
        self.tidpass = tidpass
        self.quad_prep = quad_prep
        self.shade = shade
        self.vertex_faces = vertex_faces
        self.overlay = overlay
        self.overlay_quantize = overlay_quantize


#: The main path: kernels on CUDA tensors, plain versions on CPU tensors.
KERNELS = _Ops(visibility, gbuffer, sample_textures, stencil, gbuffer_slim,
               lines, tidpass, quad_prep, shade, vertex_faces, overlay,
               overlay_quantize)
#: The plain versions on any device: the oracle a kernel run is held to.
PLAIN = _Ops(visibility_plain, gbuffer_plain, sample_textures_plain,
             stencil_plain, gbuffer_slim_plain, lines_plain, tidpass_plain,
             quad_prep_plain, shade_plain, vertex_faces_plain, overlay_plain,
             overlay_quantize_plain)
