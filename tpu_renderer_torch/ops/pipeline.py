"""The whole-frame render path, in PyTorch: the single-device kernel
branches of ``tpu_renderer/ops/pipeline.py``.

    K10 vertex stage over every model at once       raster_cuda.vertex_faces
       (packing-only tables: face_tables)
    -> K1 visibility: z-buffer + winning face id    raster_cuda.visibility
    general shader:
    -> K2 G-buffer: 32 interpolated channels        raster_cuda.gbuffer
    -> K3 texture samples from the texel pool       raster_cuda.sample_textures
    flat / gouraud / pbr shaders:
    -> K5 slim G-buffer: 3 or 11 channels           raster_cuda.gbuffer_slim
    -> shadow quads (silhouette, extrude, order),   ops/shadow.py
       one pass over every shadowing model
    -> K8 clip, project, pack the silhouette quads  raster_cuda.quad_prep
    -> K4 signed stencil                            raster_cuda.stencil
    -> deferred shading over the background         K9 raster_cuda.shade /
       (a color, or the cubemap skybox)             _shade_slim; _background,
                                                    ops/cubemap.py
    -> vertical flip, gamma 0.8, uint8              render_frame

Supersampling (``render_ssaa``) runs the same path on a ``SceneConfig``
whose resolution is already ss-scaled, then box-filters the float frame
down by ss before the flip. ``face_statistics`` counts, per model, how each
face fared in the last frame's winner ids (``Scene.stats``).

The wireframe and points shaders (``render_debug_frame``) run the gouraud
path for the z-buffer, re-run the vertex stage over every face, and draw
edges through K6 (``raster_cuda.lines``) or vertex splats through a
scatter-max.

With a debug camera (``SceneConfig.has_debug_camera``, ``dyn["debug_camera"]``)
every face also carries its vertices in the debug camera's clip space, and
K1 and K7 clip against both frusta (``raster_cuda.pack_debug_planes``), as
the JAX package's ``with_debug`` kernels do; every other stage is
unchanged. Its frustum overlay is drawn on the host (``Scene.render``).

Sharded (``parallel/sharded.py``, the JAX package's shard_map branches
:688-852 and :878-924): ``render_core`` renders a block of rows from
``row0`` on every path. With a triangle shard (``tris_group``) it runs

    K1 z only -> MIN of zb -> K7 tidpass -> MAX of tid
    -> K2 / K5 owned range -> SUM -> K3 owned range -> SUM of samp, mask
    -> the shard's stretch of the silhouette quads -> K8 -> K4
    -> SUM of stencil -> shade

each merge under a ``tr.merge_<what>`` range (parallel/mesh.py).

``SceneConfig`` holds the static facts of a scene (resolution,
handedness, per-model flags) and ``dyn`` the tensors. The kernels run
where the tensors lie: on a CUDA device through the hand-written kernels,
on the CPU through their plain versions.

Every entry point is "stage, then body". :func:`frame_inputs` composes
on the host, in float32, what each frame derives from the camera: its
matrices, near and far, its position, K4's depth constants, the debug
camera's MVP and the skybox's corner rays, keeping what does not move
with the camera's position (:func:`_camera_constants`); it packs them
into one staging buffer. :func:`with_face_tables` gives the frame its
per-face tables (:func:`face_tables`, ``dyn["faces"]``; a Scene's dyn
carries them). The bodies (``_core``, ``_frame``, ``_ssaa``,
``_debug_frame``, ``_stats``) read only device tensors: the staged
buffer's views, the face tables, and what a frame can change
(:func:`_program_inputs`: each model's vertices and texture maps, the
light, the background), never the host camera and never a model's own
per-face fields. The eager functions (:func:`render_core`,
:func:`render_frame`, :func:`render_ssaa`, :func:`render_debug_frame`,
:func:`face_statistics`) move the buffer to ``dyn``'s device and run the
body. Their ``*_jit`` counterparts, the JAX package's compiled frame
(pipeline.py:953-1060 there), run the same body as a program of
ops/compiled.py: on a CUDA device a CUDA graph captured once per static
key and replayed with each frame's inputs, on the CPU the body over the
program's static buffers.
"""
from __future__ import annotations

import dataclasses
import math
from collections import OrderedDict
from dataclasses import dataclass
from typing import Tuple

import numpy as np
import torch

from tpu_renderer_torch.constants import SYSTEM
from tpu_renderer_torch.models.camera import camera_matrices
from tpu_renderer_torch.ops import compiled
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import shading as sh
from tpu_renderer_torch.ops import transforms as T
from tpu_renderer_torch.ops.cubemap import fill_skybox, skybox_inputs
from tpu_renderer_torch.ops.lightning import Lightning
from tpu_renderer_torch.ops.shadow import _cross, edge_tables, quad_tables
from tpu_renderer_torch.ops.transforms import normalize
from tpu_renderer_torch.parallel.mesh import all_reduce
from tpu_renderer_torch.utils.profiling import span

__all__ = ["SceneConfig", "ModelConfig", "render_core", "render_frame",
           "render_ssaa", "render_debug_frame", "face_statistics",
           "render_core_jit", "render_frame_jit", "render_ssaa_jit",
           "render_debug_frame_jit", "face_statistics_jit", "frame_inputs",
           "staged", "face_tables", "with_face_tables", "stacked_vertices",
           "texture_tables",
           "SHADER_GENERAL", "SHADER_FLAT", "SHADER_GOURAUD", "SHADER_PBR",
           "SHADER_WIREFRAME", "SHADER_POINTS", "SHADERS", "SLIM_SHADERS",
           "DEBUG_SHADERS"]

SHADER_GENERAL = "general"
SHADER_FLAT = "flat"
SHADER_GOURAUD = "gouraud"
SHADER_PBR = "pbr"
SHADER_WIREFRAME = "wireframe"
SHADER_POINTS = "points"
#: Shaders through the slim G-buffer (K5), and through render_debug_frame.
SLIM_SHADERS = (SHADER_FLAT, SHADER_GOURAUD, SHADER_PBR)
DEBUG_SHADERS = (SHADER_WIREFRAME, SHADER_POINTS)
SHADERS = (SHADER_GENERAL,) + SLIM_SHADERS + DEBUG_SHADERS


@dataclass(frozen=True)
class ModelConfig:
    """Static per-model facts."""
    num_faces: int                 # padded face count
    clip: bool                     # per-pixel clip test (reference Model.clip)
    depth_test: bool               # z-buffer writes (reference Model.depth_test)
    shadowing: bool                # casts shadow volumes
    has_vn: bool                   # vertex normals present
    has_uv: bool
    has_map_kd: bool
    has_map_ks: bool
    has_norm: bool
    num_edges: int = 0             # unique silhouette-edge count


@dataclass(frozen=True)
class SceneConfig:
    """Static scene facts."""
    resolution: Tuple[int, int]    # (height, width)
    system: int                    # SYSTEM.LH (-1) / SYSTEM.RH (+1)
    subsystem: int
    shadows: bool
    cam_projection_type: int
    backface_culling: bool
    light_type: Lightning
    models: Tuple[ModelConfig, ...]
    shader: str = SHADER_GENERAL   # one of SHADERS
    background: str = "color"      # "color" | "cubemap"
    has_debug_camera: bool = False
    dbg_projection_type: int = 0


def _cam_matrices(cfg: SceneConfig, cam, device, projection_type=None):
    """Camera matrices, composed on the CPU in float32, then moved: the
    scene's resolution and systems, with ``projection_type`` (default the
    camera's, ``cfg.cam_projection_type``); also the camera's ``near`` and
    ``far`` as 0-d float32 tensors, which the vertex stage reads."""
    if projection_type is None:
        projection_type = cfg.cam_projection_type
    m = camera_matrices(
        cam["position"], cam["center"], cam["up"], cam["fovy"], cam["near"],
        cam["far"], projection_type=projection_type,
        system=cfg.system, subsystem=cfg.subsystem,
        resolution=cfg.resolution)
    for k in ("near", "far"):
        m[k] = torch.as_tensor(cam[k], dtype=torch.float32).reshape(())
    return {k: v.to(device) for k, v in m.items()}


def _debug_mvp(cfg: SceneConfig, dyn, device):
    """The debug camera's MVP (pipeline.py:590-593 of the JAX package: the
    scene's resolution and systems, the debug camera's projection type), or
    None without a debug camera."""
    if not cfg.has_debug_camera:
        return None
    return _cam_matrices(cfg, dyn["debug_camera"], device,
                         cfg.dbg_projection_type)["MVP"]


#: Camera constants kept at most (:func:`_camera_constants`).
MAX_CAMERA_CONSTANTS = 16
#: The entries of a frame that do not move with the camera's position,
#: by what they depend on (:func:`_camera_constants`); the least recently
#: used is dropped past MAX_CAMERA_CONSTANTS.
_CAMERA_CONSTANTS = OrderedDict()
#: Component orders of a cross product:
#: a × b = a[_C1] * b[_C2] - a[_C2] * b[_C1].
_C1, _C2 = np.array([1, 2, 0]), np.array([2, 0, 1])


def _host32(x):
    """A camera parameter (a tensor, an array or a number) as a float32
    numpy array, rounded once to float32 as ``torch.as_tensor(x,
    dtype=torch.float32)`` rounds it."""
    if isinstance(x, torch.Tensor):
        x = x.tolist()
    return np.asarray(x, np.float32)


def _camera_constants(cfg: SceneConfig, projection_type, fovy, near, far):
    """The entries of a frame that depend on the scene's resolution and
    systems, the projection type and the camera's ``fovy``, ``near`` and
    ``far`` (0-d float32 arrays), and not on where the camera stands:
    {projection, viewport} (4, 4) float32 CPU tensors and ``host``, the
    buffer's {viewport, near, far, zc} as float32 arrays. Made by the
    functions that :func:`_cam_matrices` and the stencil's constants call
    (so in their bits), then kept by those values' float32 bits: a zoom,
    another near or far or another resolution is another entry."""
    key = (cfg.resolution, cfg.system, cfg.subsystem, projection_type,
           fovy.tobytes(), near.tobytes(), far.tobytes())
    entry = _CAMERA_CONSTANTS.get(key)
    if entry is not None:
        _CAMERA_CONSTANTS.move_to_end(key)
        return entry
    fovy_t, near_t, far_t = (torch.from_numpy(v) for v in (fovy, near, far))
    height, width = cfg.resolution
    projection = T.perspectives[cfg.subsystem][projection_type][cfg.system](
        fovy_t, width / height, near_t, far_t)
    viewport = T.ViewPort(cfg.resolution, far_t, near_t)
    zc = np.asarray(rc.stencil_scalars(near_t, far_t), np.float32)
    entry = {"projection": projection, "viewport": viewport,
             "host": {"viewport": viewport.numpy(), "near": near.copy(),
                      "far": far.copy(), "zc": zc}}
    _CAMERA_CONSTANTS[key] = entry
    while len(_CAMERA_CONSTANTS) > MAX_CAMERA_CONSTANTS:
        _CAMERA_CONSTANTS.popitem(last=False)
    return entry


def _unit(v):
    """v / |v| of a float32 (3,) array, as ops/transforms.normalize: the
    norm from torch's own kernel (its CPU kernel fuses the sum of
    squares), a zero norm taken as 1."""
    n = torch.linalg.vector_norm(torch.from_numpy(v), ord=2, dim=-1,
                                 keepdim=True).item()
    return v / np.float32(n if n != 0 else 1)


def _cross3(a, b):
    """a × b of float32 (3,) arrays, each component a product less a
    product, as ops/transforms._cross3."""
    return a[_C1] * b[_C2] - a[_C2] * b[_C1]


def _compose(cfg: SceneConfig, cam, projection_type):
    """A camera's matrices for a frame, in the float32 operations of
    models/camera.camera_matrices (so in its bits), with the projection
    and viewport of :func:`_camera_constants`: {lookat, projection,
    viewport} float32 CPU tensors (``skybox_inputs`` reads them), the
    ``MVP`` and the camera's ``position`` as float32 arrays, and the
    constants' ``host`` arrays. The look-at rotation is built with
    (center, position, up), as there; the products are torch's own,
    written into numpy arrays."""
    fovy, near, far = (_host32(cam[k]).reshape(()) for k in
                       ("fovy", "near", "far"))
    constants = _camera_constants(cfg, projection_type, fovy, near, far)
    position = _host32(cam["position"])
    eye = position.reshape(3)
    forward = _unit(eye - _host32(cam["center"]).reshape(3))
    right = _unit(_cross3(_host32(cam["up"]), forward))
    rotate = np.eye(4, dtype=np.float32)
    rotate[:3, 0] = right
    rotate[:3, 1] = _cross3(forward, right)
    rotate[:3, 2] = np.float32(-1 if cfg.system == SYSTEM.LH else 1) * forward
    translate = np.eye(4, dtype=np.float32)
    translate[3, :3] = -eye
    lookat = torch.from_numpy(np.empty((4, 4), np.float32))
    mvp = np.empty((4, 4), np.float32)
    torch.mm(torch.from_numpy(translate), torch.from_numpy(rotate),
             out=lookat)
    torch.mm(lookat, constants["projection"], out=torch.from_numpy(mvp))
    return {"lookat": lookat, "projection": constants["projection"],
            "viewport": constants["viewport"], "MVP": mvp,
            "position": position, "host": constants["host"]}


def _frustum_planes(mvp):
    """ops/frustum.extract_frustum_planes of a (4, 4) float32 MVP as a
    numpy array: the same sums of its columns, normed by torch's own
    kernel."""
    col = mvp.T
    planes = np.empty((6, 4), np.float32)
    planes[0::2] = col[3] + col[:3]           # left, bottom, near
    planes[1::2] = col[3] - col[:3]           # right, top, far
    t = torch.from_numpy(planes)
    t.div_(torch.linalg.vector_norm(t, dim=-1, keepdim=True))
    return planes


def frame_inputs(cfg: SceneConfig, dyn):
    """The host stage of a frame: everything it derives from the camera,
    composed on the CPU in float32, packed into one staging buffer.

    Entries: the camera's MVP, viewport, frustum_planes, near and far, its
    ``position``, K4's depth constants ``zc`` (raster_cuda.stencil_scalars),
    with a debug camera its ``dbg_MVP``, and over a cubemap the corner
    rays ``sky_rays`` and triangle scalars ``sky_tri``
    (cubemap.skybox_inputs). Each frame composes the look-at matrix, the
    MVPs and the planes in a few numpy operations and torch's matrix
    product and norm (:func:`_compose`); the entries that do not move with
    the camera's position are kept (:func:`_camera_constants`). The bits
    are those of :func:`_cam_matrices`, :func:`_debug_mvp` and
    raster_cuda.stencil_scalars. Returns (buffer (N,) float32 CPU tensor,
    layout: a tuple of (name, shape), the same for every frame of a scene,
    which :func:`staged` reads the buffer with).
    """
    with span("frame_inputs"):
        cam = _compose(cfg, dyn["camera"], cfg.cam_projection_type)
        host = cam["host"]
        parts = [("MVP", cam["MVP"]), ("viewport", host["viewport"]),
                 ("frustum_planes", _frustum_planes(cam["MVP"])),
                 ("near", host["near"]), ("far", host["far"]),
                 ("position", cam["position"]), ("zc", host["zc"])]
        if cfg.has_debug_camera:
            dbg = _compose(cfg, dyn["debug_camera"], cfg.dbg_projection_type)
            parts.append(("dbg_MVP", dbg["MVP"]))
        if cfg.background == "cubemap":
            rays, tri = skybox_inputs(cam)
            parts += [("sky_rays", rays.numpy()), ("sky_tri", tri.numpy())]
        layout = tuple((name, a.shape) for name, a in parts)
        buf = np.concatenate([a for _, a in parts], axis=None)
        return torch.from_numpy(buf), layout


def staged(buf, layout):
    """{name: view} of a staging buffer by its layout (:func:`frame_inputs`)
    on whatever device the buffer lies: what a body reads."""
    views, at = {}, 0
    for name, shape in layout:
        n = math.prod(shape)
        views[name] = buf[at:at + n].view(shape)
        at += n
    return views


def _device(dyn):
    """The device a frame of ``dyn`` renders on: its light's."""
    return dyn["light"]["position"].device


def _stage(cfg: SceneConfig, dyn):
    """Stage a frame for an eager body: the buffer moved to ``dyn``'s
    device, as views."""
    buf, layout = frame_inputs(cfg, dyn)
    return staged(buf.to(_device(dyn)), layout)


#: The entries of a model's packet that a frame can change: with the light
#: and the background, a compiled program's inputs. The per-face fields
#: stay in the packet as the source of :func:`face_tables`.
_FRAME_ATTRS = ("verts",) + tuple(f"{kind}_{part}" for kind in rc.KINDS
                                  for part in ("stack", "scale_off"))


def _program_inputs(dyn):
    """What a frame of ``dyn`` can change, and so all that a program takes
    as inputs: each model's :data:`_FRAME_ATTRS`, the light, and the
    background colour or the skybox."""
    models = [{k: md[k] for k in _FRAME_ATTRS if k in md}
              for md in dyn["models"]]
    return {"models": models,
            **{k: dyn[k] for k in ("light", "background_color", "skybox")
               if k in dyn}}


def _body_dyn(cfg, dyn):
    """What a body reads of ``dyn``: its program inputs and its face
    tables (:func:`with_face_tables`)."""
    dyn = with_face_tables(cfg, dyn)
    inputs = _program_inputs(dyn)
    if "faces" in dyn:
        inputs["faces"] = dyn["faces"]
    return inputs


def face_tables(cfg: SceneConfig, models):
    """The per-face tables of a frame that depend only on its packing,
    every model's in model order: its packet's shading attributes and
    padding mask ``pad_valid``; ``vid``, the vertex ids offset by the
    vertices of the models before (ids into every model's vertices stacked
    in order); ``vn`` and ``has_vn``, the vertex normals (zeros for a model
    without them) and where they hold; the constants ``clip_en``,
    ``z_write`` and ``model_id``; K10's packing constants ``attr_consts``
    and ``face_bits`` (raster_cuda.attr_consts, face_bits: those columns
    prepacked as the vertex stage's rows hold them); and, when a model
    casts shadows, ``edges``, the shadow pass's incidence tables
    (shadow.edge_tables).

    Built in two places only: ``Scene._prepare`` once per packing (cached
    in ``Scene._face_tables``), and :func:`with_face_tables` for a ``dyn``
    without them, before any body runs."""
    parts, n_verts = [], 0
    for m_i, (mc, md) in enumerate(zip(cfg.models, models)):
        vid = md["vid"].long()
        F, dev = vid.shape[0], vid.device
        parts.append({
            **{k: md[k] for k in rc.FACE_ATTRS},
            "pad_valid": md["pad_valid"],
            "vid": vid + n_verts,
            "vn": (md["vn"] if mc.has_vn else
                   torch.zeros((F, 3, 3), dtype=torch.float32, device=dev)),
            "has_vn": torch.full((F,), mc.has_vn, device=dev),
            "clip_en": torch.full((F,), mc.clip, device=dev),
            "z_write": torch.full((F,), mc.depth_test, device=dev),
            "model_id": torch.full((F,), m_i, dtype=torch.int32, device=dev),
        })
        n_verts += md["verts"].shape[0]
    tables = {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
    tables["attr_consts"] = rc.attr_consts(tables)
    tables["face_bits"] = rc.face_bits(tables)
    edges = edge_tables(cfg, models)
    if edges is not None:
        tables["edges"] = edges
    return tables


def with_face_tables(cfg: SceneConfig, dyn):
    """``dyn`` with its per-face tables ``dyn["faces"]``: as it is where it
    has them (a Scene's dyn always does) or has no model, else a copy with
    :func:`face_tables` of its models. Every entry point calls it before
    the body, and the compiled ones before the program's key is formed, so
    no body builds tables. Whoever changes ``dyn["models"]`` drops
    ``dyn["faces"]`` (parallel/sharded.py)."""
    if "faces" in dyn or not cfg.models:
        return dyn
    return dict(dyn, faces=face_tables(cfg, dyn["models"]))


def stacked_vertices(dyn):
    """(V, 4) float32: every model's vertices stacked in model order, the
    vertices that the ids of :func:`face_tables` index."""
    return torch.cat([md["verts"] for md in dyn["models"]]).to(torch.float32)


def _vertex_pass(cfg: SceneConfig, dyn, cam_m, verts):
    """The one vertex pass of a frame (raster_cuda.vertex_pass) of the
    stacked vertices ``verts`` through the camera ``cam_m`` (MVP, viewport,
    near, far) and ``dyn["faces"]["vid"]``, with its masks: what
    ``stats()``, the debug shaders' vertices and the plain shadow stencil
    read."""
    height, width = cfg.resolution
    return rc.vertex_pass(verts, dyn["faces"]["vid"], cam_m, height, width,
                          cfg.backface_culling)


def _build_face_batch(cfg: SceneConfig, dyn, cam_m, dbg_mvp=None, *, verts):
    """raster_cuda.face_batch of the frame (the composition K10 replaces:
    its plain version packs what this returns): (raster dict, attrs dict)
    of per-face tensors over ``dyn["faces"]``."""
    height, width = cfg.resolution
    return rc.face_batch(verts, dyn["faces"], cam_m, height, width,
                         cfg.backface_culling, dbg_mvp)


def texture_tables(cfg: SceneConfig, dyn, attrs):
    """The scene-wide texel pool K3 gathers from.

    Every distinct texture stack, for each kind in ``raster_cuda.KINDS``,
    is flattened into one int32 pool once; a global slot is one stack
    layer. Models that hold the same stack tensor (instances of one mesh,
    Scene._pack_model) point their faces at the same slots, as the JAX
    package's instances share one window block (scene.py:645-665 there).
    Each face's local slot and map shape come from ``attrs``, the face
    tables (``dyn["faces"]``, or the vertex stage's attrs, which hand their
    columns on); model m's faces are the rows its ``num_faces`` give, after
    the models before it. Only the stacks come from ``dyn["models"]``.
    Returns (ftex (G, N_KINDS, 3) int32 per-face (global slot or -1, TH,
    TW), slots (S, 2) int32 (pool offset, row stride), pool (P,) int32), or
    None when no model carries a texture map.
    """
    dev = attrs["kd_slot"].device
    rows = [0]
    for mc in cfg.models:
        rows.append(rows[-1] + mc.num_faces)
    if rows[-1] != attrs["kd_slot"].shape[0]:
        raise ValueError(f"the models' num_faces add up to {rows[-1]}, the "
                         f"frame has {attrs['kd_slot'].shape[0]} faces")
    pool, slots, ftex = [], [], []
    offset = n_slots = 0
    for k, kind in enumerate(rc.KINDS):
        has = {"kd": "has_map_kd", "norm": "has_norm", "ks": "has_map_ks"}[kind]
        face_slot = []
        first_slot = {}                 # id(stack) -> its first global slot
        for m, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
            local = attrs[f"{kind}_slot"][rows[m]:rows[m + 1]].to(torch.int32)
            if not getattr(mc, has):
                face_slot.append(torch.full_like(local, -1))
                continue
            stack = md[f"{kind}_stack"]                   # (N, TH, TW) int32
            if id(stack) not in first_slot:
                n, th, tw = stack.shape
                pool.append(stack.reshape(-1))
                base = torch.arange(n, dtype=torch.int64, device=dev)
                slots.append(torch.stack(
                    [offset + base * th * tw,
                     torch.full_like(base, tw)], dim=1))
                first_slot[id(stack)] = n_slots
                offset += n * th * tw
                n_slots += n
            face_slot.append(torch.where(local >= 0,
                                         local + first_slot[id(stack)],
                                         torch.full_like(local, -1)))
        shape = attrs[f"{kind}_shape"].to(torch.int32)
        ftex.append(torch.stack([torch.cat(face_slot), shape[:, 0],
                                 shape[:, 1]], dim=1))
    if not pool:
        return None
    if offset >= 2 ** 31:
        raise ValueError("texture pool exceeds 2**31 texels")
    return (torch.stack(ftex, dim=1).contiguous(),
            torch.cat(slots).to(torch.int32).contiguous(),
            torch.cat(pool).to(torch.int32).contiguous())


def _light(cfg: SceneConfig, dyn):
    light = dict(dyn["light"])
    light["light_type"] = cfg.light_type
    light["direction"] = normalize(light["position"] - light["center"]).reshape(-1)
    return light


def _background(cfg: SceneConfig, dyn, st, height, width, row0=0):
    """The fill of ``height`` frame rows from ``row0`` where no face won
    (pipeline._background :506): the background color, or the cubemap
    skybox through the camera's staged rays."""
    if cfg.background == "color":
        return dyn["background_color"].expand(height, width, 3)
    return fill_skybox(dyn["skybox"]["packed"], st["sky_rays"],
                       st["sky_tri"], (height, width), row0)


def _shade_slim(cfg: SceneConfig, dyn, tid, gb, camera_position, background):
    """Deferred shading from the slim G-buffer (pipeline._shade_slim :513).
    flat, gouraud and pbr read no textures and no stencil (reference
    triangular.py:174-182, 220-266)."""
    light = _light(cfg, dyn)
    vec = lambda c: torch.movedim(gb[c:c + 3], 0, -1)
    if cfg.shader == SHADER_FLAT:
        rgb = sh.shade_flat(vec(0), light)
    elif cfg.shader == SHADER_GOURAUD:
        rgb = sh.shade_gouraud_n(vec(0), light)
    else:                                           # SHADER_PBR
        pix = {"normal_raw": normalize(vec(0)), "screen_pos": vec(3),
               "metallic": gb[6][..., None], "roughness": gb[7],
               "ao": vec(8)}
        rgb = sh.shade_pbr(pix, light, camera_position)
    return torch.where((tid < 0)[..., None], background, rgb)


def render_core(cfg: SceneConfig, dyn, ops=rc.KERNELS, *, local_height=None,
                row0=0, tris_group=None, tris_idx=0):
    """Render the frame BEFORE flip/quantize, for the general, flat,
    gouraud or pbr shader: stage on the host, then the body on ``dyn``'s
    device.

    ``ops`` supplies the raster operations; the default runs the CUDA
    kernels on a CUDA device and their plain versions on the CPU.
    ``raster_cuda.PLAIN`` runs the plain versions on any device — the oracle
    a kernel run is compared with. Returns (frame (H, W, 3) float32, zbuf,
    tid, stencil).

    Sharded: the ``local_height`` frame rows from ``row0``; with a process
    ``tris_group``, ``dyn`` is shard ``tris_idx`` of the faces
    (parallel.sharded.shard_dyn) and the buffers merge over the group (see
    the module docstring). Every rank of the group takes the same branches,
    so all call the same collectives in the same order.
    """
    return _core(cfg, _body_dyn(cfg, dyn), _stage(cfg, dyn), ops,
                 local_height=local_height, row0=row0, tris_group=tris_group,
                 tris_idx=tris_idx)


def _core(cfg: SceneConfig, dyn, st, ops, *, local_height=None, row0=0,
          tris_group=None, tris_idx=0):
    """render_core's body: ``st`` the staged views, ``dyn`` without the
    host camera."""
    height, width = cfg.resolution
    if local_height is None:
        local_height = height
    sign = cfg.system
    device = st["MVP"].device
    slim = cfg.shader in SLIM_SHADERS
    if not slim and cfg.shader != SHADER_GENERAL:
        raise ValueError(f"render_core draws no {cfg.shader!r} frames "
                         "(render_debug_frame does)")
    shape = (local_height, width)
    if not cfg.models:
        # Empty scene: background only (the reference renders its fill).
        frame = _background(cfg, dyn, st, *shape, row0)
        zbuf = torch.full(shape, float("inf") * sign, device=device)
        tid = torch.full(shape, -1, dtype=torch.int32, device=device)
        return frame, zbuf, tid, torch.zeros_like(tid)
    with span("vertex"):
        verts = stacked_vertices(dyn)
        fdata, flags, fdbg, rows, world = ops.vertex_faces(
            verts, dyn["faces"], st, height, width, cfg.backface_culling,
            cfg.shader if slim else SHADER_GENERAL, st.get("dbg_MVP"))
        # Global face ids are shard-major: gid0 + the local index
        # (pipeline.py:236-237 of the JAX package).
        gid0 = tris_idx * fdata.shape[0]
    if tris_group is None:
        with span("visibility"):
            zb_sign, tid = ops.visibility(fdata, flags, *shape, sign,
                                          row0=row0, fdbg=fdbg)
    else:
        # A shard's own winners mean nothing before its z-buffer meets the
        # others': z alone, MIN, then every shard claims against the merged
        # buffer and the highest global id wins.
        with span("visibility"):
            zb_sign, _ = ops.visibility(fdata, flags, *shape, sign, row0=row0,
                                        want_tid=False, fdbg=fdbg)
        zb_sign = all_reduce(zb_sign, "min", tris_group, "zb")
        with span("tidpass"):
            tid = ops.tidpass(fdata, flags, zb_sign, sign, row0=row0,
                              gid0=gid0, fdbg=fdbg)
        tid = all_reduce(tid, "max", tris_group, "tid")
    with span("gbuffer"):
        if slim:
            gb = ops.gbuffer_slim(fdata, rows, tid, cfg.shader, row0=row0,
                                  gid0=gid0)
        else:
            gb = ops.gbuffer(fdata, rows, tid, row0=row0, gid0=gid0)
    gb = all_reduce(gb, "sum", tris_group, "gbuffer")
    samp = samp_mask = None
    if not slim:
        with span("sample_textures"):
            tables = texture_tables(cfg, dyn, dyn["faces"])
            if tables is not None:
                samp, samp_mask = ops.sample_textures(
                    tid, gb[rc.GB_IU], gb[rc.GB_IV], *tables, gid0=gid0)
        if tables is not None:
            samp = all_reduce(samp, "sum", tris_group, "samples")
            samp_mask = all_reduce(samp_mask, "sum", tris_group, "samples")

    stencil = torch.zeros(shape, dtype=torch.int32, device=device)
    if cfg.shadows:
        # Computed for every shader and returned; the slim shaders do not
        # read it (pipeline.py:878-939 of the JAX package).
        # One pass over every shadowing model, on the vertex stage's
        # stacked vertices and face positions; only the silhouette quads
        # are clipped, projected, packed (K8) and binned (K4), as many as
        # the count on the device says.
        with span("shadow_quads"):
            tables = quad_tables(cfg, dyn, st, height, width, ops,
                                 tris_group, tris_idx, verts=verts,
                                 world=world)
        if tables is not None:
            qdata, qi, n_sil = tables
            with span("stencil"):
                stencil = ops.stencil(qdata, qi, zb_sign, sign, st["zc"],
                                      row0=row0, n_rows=n_sil)
            stencil = all_reduce(stencil, "sum", tris_group, "stencil")

    with span("shade"):
        if slim:
            background = _background(cfg, dyn, st, *shape, row0)
            frame = _shade_slim(cfg, dyn, tid, gb, st["position"], background)
        else:
            # K9 takes a colour background as its three floats.
            background = (dyn["background_color"] if cfg.background == "color"
                          else _background(cfg, dyn, st, *shape, row0))
            scale_off = (None if samp is None
                         else rc.shade_scale_off(cfg, dyn, device))
            frame = ops.shade(tid, stencil if cfg.shadows else None, gb, samp,
                              samp_mask, scale_off, _light(cfg, dyn),
                              st["position"], background)
    return frame, zb_sign * sign, tid, stencil


def _quantize(frame):
    """Vertical flip + gamma 0.8 + quantize (reference core.py:640)."""
    with span("quantize"):
        out = torch.clamp(torch.flip(frame, [0]) ** 0.8, 0.0, 1.0) * 255
        return out.to(torch.uint8)


def render_frame(cfg: SceneConfig, dyn, ops=rc.KERNELS):
    """One frame: (frame_u8 (H, W, 3), zbuf, tid, stencil)."""
    return _frame(cfg, _body_dyn(cfg, dyn), _stage(cfg, dyn), ops)


def _frame(cfg, dyn, st, ops):
    frame, zbuf, tid, stencil = _core(cfg, dyn, st, ops)
    return _quantize(frame), zbuf, tid, stencil


def render_ssaa(cfg: SceneConfig, dyn, ss, ops=rc.KERNELS):
    """A supersampled frame (pipeline.render_ssaa_jit :1049 of the JAX
    package): ``cfg.resolution`` is already ss-scaled; the float frame is
    box-filtered down by ``ss`` before the flip, gamma and quantize.
    Returns (frame_u8 (H/ss, W/ss, 3), zbuf, tid, stencil), the buffers at
    the scaled size."""
    return _ssaa(cfg, _body_dyn(cfg, dyn), _stage(cfg, dyn), ss, ops)


def _ssaa(cfg, dyn, st, ss, ops):
    frame, zbuf, tid, stencil = _core(cfg, dyn, st, ops)
    with span("ssaa"):
        hh, ww = frame.shape[0], frame.shape[1]
        frame = frame.reshape(hh // ss, ss, ww // ss, ss, 3).mean(dim=(1, 3))
    return _quantize(frame), zbuf, tid, stencil


def face_statistics(cfg: SceneConfig, dyn, tid):
    """Per-model face counters from a frame's winner ids ``tid``
    (pipeline.face_statistics :1060 of the JAX package; the reference's
    per-face Errors tally, core.py:624-636), on the tensors' device.

    Returns a list, one dict per model, of 0-d int64 tensors: total,
    rendered (faces that own at least one pixel of ``tid``),
    backface_culled, degenerate (EMPTY_B), offscreen (WRONG_MIN_MAX, an
    empty clamped bbox) and occluded_or_clipped (the rest: the reference's
    fragment-level CLIPPED and EMPTY_Z outcomes collapse here). The vertex
    stage runs again at ``cfg.resolution``.
    """
    buf, layout = frame_inputs(cfg, dyn)
    return _stats(cfg, _body_dyn(cfg, dyn),
                  staged(buf.to(tid.device), layout), tid)


#: The counters of :func:`face_statistics`, in the order of its dicts.
_STATS = ("total", "rendered", "backface_culled", "degenerate", "offscreen",
          "occluded_or_clipped")


def _stats(cfg, dyn, st, tid):
    if not cfg.models:
        return []
    device = tid.device
    ft = dyn["faces"]
    # Pixels per global face id; background pixels (tid < 0) go to a spare
    # slot g_total and add 0, as JAX's clip(tid, -1) with mode="drop" does.
    g_total = ft["vid"].shape[0]
    ids = tid.reshape(-1).long()
    fg = ids >= 0
    owned = torch.zeros(g_total + 1, dtype=torch.int32, device=device)
    owned.index_add_(0, torch.where(fg, ids, g_total), fg.to(torch.int32))

    # The vertex pass's own masks, as its ``valid`` folds them.
    f = _vertex_pass(cfg, dyn, st, stacked_vertices(dyn))
    real = ft["pad_valid"]
    culled = real & f["culled"]
    degenerate = real & ~culled & f["degenerate"]
    offscreen = real & ~culled & ~degenerate & ~f["box_valid"]
    rendered = real & (owned[:g_total] > 0)
    leftover = real & ~culled & ~degenerate & ~offscreen & ~rendered
    masks = torch.stack([real, rendered, culled, degenerate, offscreen,
                         leftover], dim=1).long()
    # Per-model sums: integer sums, exact in any order.
    counts = torch.zeros((len(cfg.models), len(_STATS)), dtype=torch.int64,
                         device=device)
    counts.index_add_(0, ft["model_id"].long(), masks)
    return [dict(zip(_STATS, row.unbind())) for row in counts]


def render_debug_frame(cfg: SceneConfig, dyn, kind, ops=rc.KERNELS):
    """Wireframe / points frames (pipeline.render_debug_frame :957,
    reference triangular.py:269-283).

    - the gouraud path (K1, K5, and K4 with shadows) resolves the z-buffer,
      with the debug camera's clip space where the scene has one; its
      shading is discarded;
    - every real face (no culling or validity masks: the reference iterates
      all of model.face_array) re-runs the vertex stage, z linearized;
    - wireframe: the three directed edges of every face through K6, one
      color over the background;
    - points: the vertex splats' last write wins, resolved by a scatter-max
      over the write index whose parity picks red or blue.

    Returns (frame_u8, zbuf, tid, stencil) like render_frame.
    """
    if kind not in DEBUG_SHADERS:
        raise ValueError(f"not a debug shader: {kind!r}")
    return _debug_frame(cfg, _body_dyn(cfg, dyn), _stage(cfg, dyn), kind,
                        ops)


def _debug_frame(cfg, dyn, st, kind, ops):
    _, zbuf, tid, stencil = _core(
        dataclasses.replace(cfg, shader=SHADER_GOURAUD), dyn, st, ops)
    height, width = cfg.resolution
    frame = _background(cfg, dyn, st, height, width)
    if not cfg.models:
        return _quantize(frame), zbuf, tid, stencil

    with span("debug_vertex"):
        sx, sy, sz, fn, valid = _debug_vertices(cfg, dyn, st)
    if kind == SHADER_WIREFRAME:
        with span("lines"):
            mask = ops.lines(*_wireframe_lines(sx, sy, sz, valid, zbuf,
                                               height, width))
            color = _rgb(64 / 255, 64 / 255, 128 / 255, zbuf.device)
            frame = torch.where((mask > 0)[..., None], color, frame)
    else:
        with span("points"):
            frame = torch.where(*_point_splats(st, sx, sy, fn, valid, height,
                                               width), frame)
    return _quantize(frame), zbuf, tid, stencil


def _rgb(r, g, b, device):
    """A (3,) float32 colour made on ``device`` by fills: no copy from the
    host, so a frame that holds it can be captured into a CUDA graph."""
    return torch.stack([torch.full((), v, dtype=torch.float32, device=device)
                        for v in (r, g, b)])


def _jit(name, static, cfg, dyn, body, *tensors):
    """Stage on the host, then run ``body(inputs, staged views)`` as the
    program of ops/compiled.py keyed by (name, cfg, ``static``, the staging
    layout, the identity of the face tables; the device and every input's
    shape and dtype): ``inputs`` is (:func:`_program_inputs` of ``dyn``
    with the face tables, ``tensors``). The face tables
    (:func:`with_face_tables`, built before the key is formed where ``dyn``
    has none; a Scene builds them once per packing, and nothing writes
    them) are no input: the body reads them as they are, so no frame
    copies them, and another packing's tables are another program. The
    input tree is made under ``tr.program_inputs``."""
    buf, layout = frame_inputs(cfg, dyn)
    with span("program_inputs"):
        inputs = _body_dyn(cfg, dyn)
        faces = inputs.pop("faces", None)

    def run(inputs, b):
        d, rest = inputs
        if faces is not None:
            d = dict(d, faces=faces)
        return body((d, rest), staged(b, layout))

    return compiled.call((name, cfg, static, layout,
                          None if faces is None else id(faces)),
                         run, buf, (inputs, tensors), _device(dyn))


def render_frame_jit(cfg: SceneConfig, dyn):
    """:func:`render_frame` as a compiled program (the JAX package's
    ``render_frame_jit``, pipeline.py:953, which Scene.render calls at
    scene.py:850): captured once per static key, replayed with each
    frame's camera, light, vertices, textures and background."""
    return _jit("render_frame", None, cfg, dyn,
                lambda inputs, st: _frame(cfg, inputs[0], st, rc.KERNELS))


def render_ssaa_jit(cfg: SceneConfig, dyn, ss):
    """:func:`render_ssaa` as a compiled program (``render_ssaa_jit``,
    pipeline.py:1049 of the JAX package; Scene.render at scene.py:816);
    ``ss`` is part of the key."""
    return _jit("render_ssaa", ss, cfg, dyn,
                lambda inputs, st: _ssaa(cfg, inputs[0], st, ss, rc.KERNELS))


def render_core_jit(cfg: SceneConfig, dyn):
    """:func:`render_core` (one device) as a compiled program
    (``render_core_jit``, pipeline.py:1043 of the JAX package): the
    pre-flip float frame and the buffers, for the debug camera's host
    overlay (scene.py:831) and the host debug shaders (:910)."""
    return _jit("render_core", None, cfg, dyn,
                lambda inputs, st: _core(cfg, inputs[0], st, rc.KERNELS))


def render_debug_frame_jit(cfg: SceneConfig, dyn, kind):
    """:func:`render_debug_frame` as a compiled program (the JAX package's
    jitted ``render_debug_frame``, pipeline.py:956, static ``kind``;
    Scene.render at scene.py:896)."""
    if kind not in DEBUG_SHADERS:
        raise ValueError(f"not a debug shader: {kind!r}")
    return _jit("render_debug_frame", kind, cfg, dyn,
                lambda inputs, st: _debug_frame(cfg, inputs[0], st, kind,
                                                rc.KERNELS))


def face_statistics_jit(cfg: SceneConfig, dyn, tid):
    """:func:`face_statistics` as a compiled program (the JAX package's
    jitted ``face_statistics``, pipeline.py:1060; Scene.stats at
    scene.py:874); ``tid`` is an input, refilled in place."""
    return _jit("face_statistics", None, cfg, dyn,
                lambda inputs, st: _stats(cfg, inputs[0], st, inputs[1][0]),
                tid)


def _debug_vertices(cfg: SceneConfig, dyn, cam_m):
    """The vertex pass (:func:`_vertex_pass`) over every face of every
    model, without culling or validity masks: per-face screen x, y and
    linearized z (F, 3) each, the unit world face normal (F, 3), and the
    mask (F,) of real (not padding) faces. ``cam_m`` holds MVP, viewport,
    near and far."""
    f = _vertex_pass(cfg, dyn, cam_m, stacked_vertices(dyn))
    world = f["world"]
    fn = normalize(_cross(world[:, 1] - world[:, 0],
                          world[:, 2] - world[:, 0]))
    return f["sx"], f["sy"], f["szlin"], fn, dyn["faces"]["pad_valid"]


def _wireframe_lines(sx, sy, sz, valid, zbuf, height, width):
    """K6's arguments: the three directed edges of every face (vertices
    0->1, 1->2, 2->0) packed by raster_cuda.pack_lines, each active where
    its face is real, and the z-buffer. Column rolls and expands, not
    index lists or repeat_interleave, so that nothing is copied from the
    host or waited for in a captured frame."""
    nxt = lambda a: torch.roll(a, -1, dims=1)
    p0 = torch.stack([sx, sy, sz], -1).reshape(-1, 3)
    p1 = torch.stack([nxt(sx), nxt(sy), nxt(sz)], -1).reshape(-1, 3)
    ldata, lbbox = rc.pack_lines(p0, p1, height, width)
    return (ldata, lbbox, valid[:, None].expand(-1, 3).reshape(-1), zbuf,
            height, width)


def _point_splats(st, sx, sy, fn, valid, height, width):
    """(mask (H, W, 1), rgb (H, W, 3)) of the points shader
    (pipeline.py:1016-1037 of the JAX package).

    Faces facing the camera direction (-position normalized; keep
    normal · cam_dir > 0) splat their vertices in the write order
    (v0 R)(v1 B)(v1 R)(v2 B)(v2 R)(v0 B); a pixel keeps its last write,
    found with a scatter-max over the write index. Writes outside the frame,
    of culled faces or from non-finite coordinates go to a spare slot H·W
    that is sliced off.
    """
    device = sx.device
    pos = st["position"]
    cam_dir = -pos / torch.clamp(torch.linalg.vector_norm(pos), min=1e-30)
    keep = valid & ((fn * cam_dir).sum(-1) > 0)
    vsel = (0, 1, 1, 2, 2, 0)
    fx = torch.stack([sx[:, v] for v in vsel], dim=1)
    fy = torch.stack([sy[:, v] for v in vsel], dim=1)
    finite = torch.isfinite(fx) & torch.isfinite(fy)
    # Truncating casts, like .astype; coordinates are clamped to [-1, size]
    # first (which keeps in-frame ones and out-of-frame ones out), so no
    # cast leaves int32's range.
    off = lambda x, size: torch.where(finite, x, -1.0).clamp(-1.0, float(size))
    ci = off(fx, width).to(torch.int32)
    ri = off(fy, height).to(torch.int32)
    inb = finite & (ri >= 0) & (ri < height) & (ci >= 0) & (ci < width)
    ok = keep[:, None] & inb
    order = torch.arange(ok.numel(), dtype=torch.int64, device=device)
    lin = torch.where(ok, ri.to(torch.int64) * width + ci,
                      torch.full_like(ri, height * width, dtype=torch.int64))
    win = torch.full((height * width + 1,), -1, dtype=torch.int64,
                     device=device)
    win.scatter_reduce_(0, lin.reshape(-1), order, "amax", include_self=True)
    win = win[:height * width].reshape(height, width)
    blue = _rgb(0.0, 0.0, 1.0, device)
    red = _rgb(1.0, 0.0, 0.0, device)
    rgb = torch.where(((win & 1) == 1)[..., None], blue, red)
    return (win >= 0)[..., None], rgb
