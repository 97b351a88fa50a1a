"""The whole-frame render path, in PyTorch: the main (general-shader,
single-device) branch of ``tpu_renderer/ops/pipeline.py``.

    vertex stage (per model)                        ops/vertex.py
    -> global face batch (models concatenated)      _build_face_batch
    -> K1 visibility: z-buffer + winning face id    raster_cuda.visibility
    -> K2 G-buffer: 32 interpolated channels        raster_cuda.gbuffer
    -> K3 texture samples from the texel pool       raster_cuda.sample_textures
    -> shadow quads (silhouette, extrude, clip)     ops/shadow.py
    -> K4 signed stencil                            raster_cuda.stencil
    -> deferred Blinn-Phong shading                 _shade_gbuffer
    -> background, vertical flip, gamma 0.8, uint8  render_frame

PyTorch runs eagerly, so there is no compiled program: ``SceneConfig``
holds the static facts of a scene (resolution, handedness, per-model flags)
and ``dyn`` the tensors. The kernels run where the tensors lie: on a CUDA
device through the hand-written kernels, on the CPU through their plain
versions.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch

from tpu_renderer_torch.models.camera import camera_matrices
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops import shading as sh
from tpu_renderer_torch.ops.lightning import Lightning
from tpu_renderer_torch.ops.shadow import _cross, prepare_quads
from tpu_renderer_torch.ops.transforms import normalize
from tpu_renderer_torch.ops.vertex import gather_faces, transform_vertices

__all__ = ["SceneConfig", "ModelConfig", "render_core", "render_frame",
           "texture_tables", "SHADER_GENERAL"]

SHADER_GENERAL = "general"


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


def _cam_matrices(cfg: SceneConfig, cam, device):
    """Camera matrices, composed on the CPU in float32, then moved."""
    m = camera_matrices(
        cam["position"], cam["center"], cam["up"], cam["fovy"], cam["near"],
        cam["far"], projection_type=cfg.cam_projection_type,
        system=cfg.system, subsystem=cfg.subsystem,
        resolution=cfg.resolution)
    return {k: v.to(device) for k, v in m.items()}


def _build_face_batch(cfg: SceneConfig, dyn, cam_m):
    """Vertex stage + per-face gathers for every model, concatenated
    (pipeline._build_face_batch :133 without the sampler-window fields).
    Returns (raster dict, attrs dict) of per-face tensors."""
    height, width = cfg.resolution
    near, far = dyn["camera"]["near"], dyn["camera"]["far"]
    raster_parts, attr_parts = [], []
    for m_i, (mc, md) in enumerate(zip(cfg.models, dyn["models"])):
        va = transform_vertices(md["verts"], cam_m["MVP"], cam_m["viewport"],
                                near, far)
        f = gather_faces(va, md["vid"], height, width, cfg.backface_culling)
        F = md["vid"].shape[0]
        world = f["world"]                              # (F, 3, 3)
        face_normal = normalize(_cross(world[:, 1] - world[:, 0],
                                       world[:, 2] - world[:, 0]))
        # Faces without vertex normals shade with the face normal
        # (reference Face.get_normals fallback, core.py:186-187).
        vn = md["vn"] if mc.has_vn else face_normal[:, None, :].expand(F, 3, 3)
        dev = world.device
        raster_parts.append({
            "sx": f["sx"], "sy": f["sy"], "inv_w": f["inv_w"], "aff": f["aff"],
            "clip": f["clip"], "bbox": f["bbox"],
            "valid": f["valid"] & md["pad_valid"],
            "clip_en": torch.full((F,), mc.clip, device=dev),
            "z_write": torch.full((F,), mc.depth_test, device=dev),
        })
        attr_parts.append({
            "world": world, "vn": vn, "uv": md["uv"], "kd": md["kd"],
            "ks": md["ks"], "ns": md["ns"],
            "kd_slot": md["kd_slot"], "ks_slot": md["ks_slot"],
            "norm_slot": md["norm_slot"], "norm_tangent": md["norm_tangent"],
            "kd_shape": md["kd_shape"], "ks_shape": md["ks_shape"],
            "norm_shape": md["norm_shape"],
            "model_id": torch.full((F,), m_i, dtype=torch.int32, device=dev),
        })
    cat = lambda parts: {k: torch.cat([p[k] for p in parts], dim=0)
                         for k in parts[0]}
    return cat(raster_parts), cat(attr_parts)


def texture_tables(cfg: SceneConfig, dyn, attrs):
    """The scene-wide texel pool K3 gathers from.

    Every model's texture stacks, for each kind in ``raster_cuda.KINDS``,
    are flattened into one int32 pool; a global slot is one stack layer.
    Returns (ftex (G, N_KINDS, 3) int32 per-face (global slot or -1, TH, TW),
    slots (S, 2) int32 (pool offset, row stride), pool (P,) int32), or None
    when no model carries a texture map.
    """
    dev = attrs["kd_slot"].device
    pool, slots, ftex = [], [], []
    offset = n_slots = 0
    for k, kind in enumerate(rc.KINDS):
        has = {"kd": "has_map_kd", "norm": "has_norm", "ks": "has_map_ks"}[kind]
        face_slot = []
        for mc, md in zip(cfg.models, dyn["models"]):
            local = md[f"{kind}_slot"].to(torch.int32)
            if getattr(mc, has):
                stack = md[f"{kind}_stack"]               # (N, TH, TW) int32
                n, th, tw = stack.shape
                pool.append(stack.reshape(-1))
                base = torch.arange(n, dtype=torch.int64, device=dev)
                slots.append(torch.stack(
                    [offset + base * th * tw,
                     torch.full_like(base, tw)], dim=1))
                face_slot.append(torch.where(local >= 0, local + n_slots,
                                             torch.full_like(local, -1)))
                offset += n * th * tw
                n_slots += n
            else:
                face_slot.append(torch.full_like(local, -1))
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


def _unpack_texel(packed, scale_off):
    """RGB-packed int32 texels -> float RGB under the stack's (scale,
    offset) dequantization affine (models/scene.py _texture_stack)."""
    r = (packed & 0xFF).to(torch.float32)
    g = ((packed >> 8) & 0xFF).to(torch.float32)
    b = ((packed >> 16) & 0xFF).to(torch.float32)
    rgb = torch.stack([r, g, b], dim=-1) / 255.0
    return rgb * scale_off[0] + scale_off[1]


def _shade_gbuffer(cfg: SceneConfig, dyn, tid, stencil, gb, samp, samp_mask,
                   camera_position):
    """Deferred shading from the G-buffer and the K3 texture samples
    (pipeline._shade_gbuffer :388, sampler branch)."""
    height, width = tid.shape
    bg = tid < 0
    vec = lambda c: torch.movedim(gb[c:c + 3], 0, -1)
    frag_world = vec(rc.GB_WORLD)
    model_id = gb[rc.GB_MODEL]

    def sampled(m, md, kind):
        k = rc.KINDS.index(kind)
        rgb = _unpack_texel(samp[k], md[f"{kind}_scale_off"])
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
            specular_light = torch.where(mask[..., None], rgb[..., 0:1] * 255.0,
                                         specular_light)

    light = dict(dyn["light"])
    light["light_type"] = cfg.light_type
    light["direction"] = normalize(light["position"] - light["center"]).reshape(-1)
    pix = {"color": color, "normal": normal, "frag_world": frag_world,
           "specular_light": specular_light, "ns": gb[rc.GB_NS][..., None]}
    rgb = sh.shade_general(pix, light, camera_position,
                           shadows_mask=(stencil != 0) if cfg.shadows else None)
    background = dyn["background_color"].expand(height, width, 3)
    return torch.where(bg[..., None], background, rgb)


def _span(stage):
    """A named range (``tr.<stage>``) in torch.profiler traces; it records
    nothing when no profiler runs."""
    return torch.profiler.record_function(f"tr.{stage}")


def render_core(cfg: SceneConfig, dyn, ops=rc.KERNELS):
    """Render the frame BEFORE flip/quantize.

    ``ops`` supplies the four raster operations; the default runs the CUDA
    kernels on a CUDA device and their plain versions on the CPU.
    ``raster_cuda.PLAIN`` runs the plain versions on any device — the oracle
    a kernel run is compared with. Returns (frame (H, W, 3) float32, zbuf,
    tid, stencil).
    """
    height, width = cfg.resolution
    sign = cfg.system
    device = dyn["light"]["position"].device
    if not cfg.models:
        # Empty scene: background only (the reference renders its fill).
        frame = dyn["background_color"].expand(height, width, 3)
        zbuf = torch.full((height, width), float("inf") * sign, device=device)
        tid = torch.full((height, width), -1, dtype=torch.int32, device=device)
        return frame, zbuf, tid, torch.zeros_like(tid)
    with _span("vertex"):
        cam_m = _cam_matrices(cfg, dyn["camera"], device)
        faces, attrs = _build_face_batch(cfg, dyn, cam_m)
        fdata = rc.pack_faces(faces)
        flags = rc.face_flags(faces)
        adata = rc.pack_face_attrs(attrs)
    with _span("visibility"):
        zb_sign, tid = ops.visibility(fdata, flags, height, width, sign)
    with _span("gbuffer"):
        gb = ops.gbuffer(fdata, adata, tid)
    samp = samp_mask = None
    with _span("sample_textures"):
        tables = texture_tables(cfg, dyn, attrs)
        if tables is not None:
            samp, samp_mask = ops.sample_textures(
                tid, gb[rc.GB_IU], gb[rc.GB_IV], *tables)

    stencil = torch.zeros((height, width), dtype=torch.int32, device=device)
    if cfg.shadows:
        with _span("shadow_quads"):
            prepared = prepare_quads(cfg, dyn, cam_m)
            if prepared is not None:
                qdata, qi = rc.pack_quads(*prepared, height, width)
        if prepared is not None:
            zc = rc.stencil_scalars(dyn["camera"]["near"], dyn["camera"]["far"])
            with _span("stencil"):
                stencil = ops.stencil(qdata, qi, zb_sign, sign, *zc)

    with _span("shade"):
        cam_pos = torch.as_tensor(dyn["camera"]["position"],
                                  dtype=torch.float32, device=device)
        frame = _shade_gbuffer(cfg, dyn, tid, stencil, gb, samp, samp_mask,
                               cam_pos)
    return frame, zb_sign * sign, tid, stencil


def render_frame(cfg: SceneConfig, dyn, ops=rc.KERNELS):
    """One frame: (frame_u8 (H, W, 3), zbuf, tid, stencil)."""
    frame, zbuf, tid, stencil = render_core(cfg, dyn, ops)
    with _span("quantize"):
        # Vertical flip + gamma 0.8 + quantize (reference core.py:640).
        out = torch.clamp(torch.flip(frame, [0]) ** 0.8, 0.0, 1.0) * 255
        out = out.to(torch.uint8)
    return out, zbuf, tid, stencil
