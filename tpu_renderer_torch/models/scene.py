"""Scene: model container + camera/light binding + the render() entry point.

Counterpart of ``tpu_renderer/models/scene.py`` (reference core.py:558-640)
on one device: the six shaders (general, flat, gouraud, pbr, wireframe,
points), optional shadow volumes, a color or cubemap-skybox background, a
debug camera (its clip space in the rasterizer, and its frustum drawn over
the frame after it), the camera and light gizmos (``show=True``),
supersampling (``supersample``) and per-model statistics (``stats()``).
Fixed reference quirks kept from the JAX package: ``shadows=`` is honored
and ``Model.shadowing`` gates which models cast shadows; camera/light
bindings live on the Scene instance; default camera/light are fresh per
Scene.

``device`` defaults to ``"cuda"``: a Scene renders on the card unless the
caller asks for the CPU (``device="cpu"``, the plain versions of the
kernels). On a host without CUDA, ``Scene()`` raises RuntimeError.

``render()`` and ``stats()`` go through the compiled entry points
(``pipeline.render_frame_jit``, ``render_ssaa_jit``, ``render_core_jit``,
``render_debug_frame_jit``, ``face_statistics_jit``), as the JAX package's
Scene goes through its jitted ones: on the card each frame replays a CUDA
graph captured once per static key (ops/compiled.py); a camera or light
move, new vertex positions or new texels of the same shape replay the same
graph. The frame's per-face tables (``pipeline.face_tables``) are built once
per packing; new faces, uv, normals or materials (``Model.bump_version``)
build new ones, and with them a new program.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, List, Optional

import numpy as np
import torch

from tpu_renderer_torch.constants import SUBSYSTEM, SYSTEM
from tpu_renderer_torch.models import gizmos
from tpu_renderer_torch.models.camera import Camera, Light
from tpu_renderer_torch.models.model import Model
from tpu_renderer_torch.ops import transforms as T
from tpu_renderer_torch.ops import pipeline as pl
from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops.cubemap import CubeMap
from tpu_renderer_torch.ops.errors import Errors
from tpu_renderer_torch.ops.overlay import (draw_points, draw_view_frustum,
                                            draw_wireframe, frustum_segments)
from tpu_renderer_torch.ops.pipeline import (
    DEBUG_SHADERS, ModelConfig, SceneConfig, SHADER_GENERAL, SHADER_GOURAUD,
    SHADERS, face_statistics_jit, render_core, render_core_jit,
    render_debug_frame_jit, render_frame_jit, render_ssaa_jit)
from tpu_renderer_torch.utils import profiling
from tpu_renderer_torch.utils.profiling import span

__all__ = ["Scene"]

_PAD = 8  # face-count padding multiple (the JAX package's scan chunk)


def _pad_rows(a: np.ndarray, rows: int) -> np.ndarray:
    if len(a) == rows:
        return a
    pad = np.zeros((rows - len(a), *a.shape[1:]), dtype=a.dtype)
    return np.concatenate([a, pad], axis=0)


def _material_table(model: Model, attr: str, width: int) -> np.ndarray:
    """Per-material-group scalar/vector attribute table, broadcast to width."""
    out = []
    for name in model.material_group:
        mat = model.materials.get(name, model.materials["default"])
        val = np.atleast_1d(np.asarray(getattr(mat, attr), dtype=np.float32))
        out.append(np.broadcast_to(val, (width,)) if width > 1 else val[:1])
    return np.stack(out)


def _texture_stack(model: Model, attr: str, device="cpu"):
    """Stack all materials' ``attr`` maps, RGB-packed into one int32 texel,
    on ``device``.

    Textures originate from 8-bit images (core.py:100-105), so quantizing
    back to 8 bits per channel under a per-stack (scale, offset) affine —
    (1, 0) for raw [0, 1] maps, (2, -1) for ``*2-1``-normalized normal
    maps — reconstructs the original float values exactly. A texel uses 24
    bits, so int32 holds it with the same bits as the JAX package's uint32.

    The float maps go to ``device`` as they are and are quantized there,
    one elementwise operation at a time in float32, so each texel gets the
    bits of the numpy arithmetic ``round(clip((tex - offset) / scale, 0,
    1) * 255)``: a map changed every frame costs its upload and a few
    launches, not host passes over every texel.

    Returns (stack (N, TH, TW) int32 tensor, slot (G,), shape (G, 2),
    tangent (G,), scale_offset (2,) float32 tensor), the tensors on
    ``device``, or None when no material carries the map.
    """
    groups = model.material_group
    entries = []
    for gi, name in enumerate(groups):
        mat = model.materials.get(name, model.materials["default"])
        tex = mat.__dict__.get(attr)
        if tex is not None:
            tangent = bool((tex.dtype.metadata or {}).get("tangent", False))
            entries.append((gi, torch.as_tensor(
                np.asarray(tex, np.float32), device=device), tangent))
    if not entries:
        return None
    th = max(t.shape[0] for _, t, _ in entries)
    tw = max(t.shape[1] for _, t, _ in entries)
    lo = torch.stack([t.min() for _, t, _ in entries]).min()
    offset = torch.where(lo < 0, lo.new_full((), -1.0), 0.0)
    scale = 1.0 - offset

    stack = torch.zeros((len(entries), th, tw), dtype=torch.int32,
                        device=device)
    slot = np.full(len(groups), -1, np.int32)
    shape = np.ones((len(groups), 2), np.float32)
    tangent_flags = np.zeros(len(groups), bool)
    for si, (gi, tex, tangent) in enumerate(entries):
        q = (tex[..., :3] - offset) / scale
        q = q.clamp_(0, 1).mul_(255).round_().to(torch.int32)
        stack[si, :tex.shape[0], :tex.shape[1]] = (
            q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16))
        slot[gi] = si
        shape[gi] = tex.shape[:2]
        tangent_flags[gi] = tangent
    return (stack, slot, shape, tangent_flags, torch.stack([scale, offset]))


def _count_copies(site, way, tensors):
    """One visit of the copy site ``site``, which copies the CUDA tensors
    among ``tensors`` in direction ``way`` (a CPU tensor is made or handed
    over without a transfer)."""
    cuda = [t for t in tensors if t.is_cuda]
    copies = {way: [len(cuda), sum(t.nbytes for t in cuda)]} if cuda else {}
    profiling.count_copies(site, copies)


def _readback(*tensors):
    """``t.cpu().numpy()`` of each tensor, under ``tr.readback``, counted
    at the ``readback`` copy site."""
    with span("readback"):
        _count_copies("readback", "d2h", tensors)
        return [t.cpu().numpy() for t in tensors]


def _check_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("Scene(device='cuda') but CUDA is not available "
                           "on this host")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {device}")
    return device


class Scene:
    def __init__(self, camera: Optional[Camera] = None,
                 light: Optional[Light] = None, shadows: bool = False,
                 debug_camera: Optional[Camera] = None,
                 resolution=(1500, 1500), system=SYSTEM.RH,
                 subsystem=SUBSYSTEM.DIRECTX, skymap=None,
                 shader: str = SHADER_GENERAL, supersample: int = 1, *,
                 device="cuda"):
        if shader not in SHADERS:
            raise ValueError(f"unknown shader {shader!r}; one of {SHADERS}")
        if (skymap is not None and not isinstance(skymap, CubeMap)
                and np.shape(skymap) != (3,)):
            raise ValueError("skymap takes a CubeMap or an RGB color")
        self.device = _check_device(device)
        self.system = system
        self.subsystem = subsystem
        self.resolution = tuple(int(r) for r in resolution)
        self.models: List[Model] = []
        self.shadows = shadows
        self.skybox = skymap
        self.shader = shader
        #: Draw the debug camera's frustum over the frame like the reference
        #: (core.py:638) whenever a debug camera is present.
        self.debug_overlay = True
        #: Supersampling factor, read at render time: render at ss x the
        #: resolution, box-filter down before quantization.
        self.supersample = int(supersample)
        self._packets: Dict[int, dict] = {}
        self._shared: Dict[tuple, tuple] = {}
        self._face_parts: Dict[tuple, tuple] = {}
        self._faces = None
        self.camera = camera if camera is not None else Camera(
            position=(0, 0, 1), center=(0, 0, 0))
        self.light = light if light is not None else Light(position=(1, 1, 1))
        self.debug_camera = debug_camera
        self.last_zbuf = None
        self.last_tid = None
        self.last_stencil = None

    # ------------------------------------------------------------- binding

    def __setattr__(self, key, value):
        # Bind camera/light objects to this scene (reference Bound
        # descriptor, core.py:527-555) and add their gizmos.
        super().__setattr__(key, value)
        if key in ("camera", "light", "debug_camera") and value is not None:
            value.scene = self
            if getattr(value, "show", False):
                self._add_gizmo(value)

    def _add_gizmo(self, obj):
        """A sphere at a light, a frustum-shaped mesh at a camera (reference
        core.py:532-552; scene.py:368-389 of the JAX package): procedural
        meshes scaled by 0.1 and carried by inv(lookat), normals by the
        inverse of its 3x3 part (flipped), pinv where a matrix is singular;
        no per-pixel clip test."""
        sub = (gizmos.make_sphere() if isinstance(obj, Light)
               else gizmos.make_camera_gizmo())
        sub.clip = False
        sub = sub @ T.scale(0.1)
        lookat = np.asarray(obj.lookat, np.float64)
        try:
            inv = np.linalg.inv(lookat)
        except np.linalg.LinAlgError:
            inv = np.linalg.pinv(lookat)
        sub = sub @ inv
        try:
            inv3 = np.linalg.inv(lookat[:3, :3])
        except np.linalg.LinAlgError:
            inv3 = np.linalg.pinv(lookat[:3, :3])
        sub.normals = (-sub.normals @ inv3).astype(np.float32) \
            if sub.normals is not None else None
        self.add_model(sub)

    def add_model(self, model: Model):
        self.models.append(model)

    # ------------------------------------------------------------- packing

    def _pack_model(self, model: Model) -> dict:
        """Per-model tensors on the scene's device, cached until the model's
        vertices or textures change (scene.py:396 of the JAX package,
        without the sampler window metadata).

        Only ``verts`` is the model's own. The rest depends on the faces,
        uv, normals and materials, which ``model @ transform`` shares by
        reference, so it is cached on those objects' identities and the
        version (:meth:`_pack_shared`): instances of one mesh get the same
        device tensors, texture stacks and slot tables included, as the
        JAX package's instances share one atlas (scene.py:459-480 there).
        A texture change bumps the version, which keys a new part; its
        per-face tables stay the same tensors while they are equal
        (:meth:`_intern_faces`)."""
        key = id(model)
        cached = self._packets.get(key)
        if (cached is not None and cached["_verts_src"] is model.vertices
                and cached["_version"] == model._version):
            return cached

        F = model.num_faces
        Fp = max(_PAD, -(-F // _PAD) * _PAD)
        srcs = (model.materials, model.material_group, model.uv,
                model.normals, model._faces)
        skey = tuple(id(s) for s in srcs) + (F, Fp, model._version)
        hit = self._shared.get(skey)
        if hit is None:
            if cached is not None:
                # The part this model packed from before: a texture
                # changed every frame keeps one part, not one per frame.
                self._shared.pop(cached["_shared_key"], None)
            # The sources are pinned beside the part, so no key can alias
            # the id() of a freed object.
            hit = self._shared[skey] = (
                self._pack_shared(model, F, Fp, srcs), srcs)
        fields, flags = hit[0]
        packet = {
            "_verts_src": model.vertices,
            "_version": model._version,
            "_shared_key": skey,
            "verts": torch.as_tensor(model.vertices, dtype=torch.float32,
                                     device=self.device),
            **fields,
            "_config": ModelConfig(
                num_faces=Fp, clip=model.clip, depth_test=model.depth_test,
                shadowing=model.shadowing, **flags),
        }
        self._packets[key] = packet
        return packet

    def _pack_shared(self, model: Model, F: int, Fp: int, srcs):
        """The part of a packet that instances share: (tensors by name,
        with ``_faces`` the dict of its per-face tables, ModelConfig's flags
        of it)."""
        faces = model.face_array
        vid = _pad_rows(faces[:, :, 0].astype(np.int64), Fp)
        pad_valid = np.zeros(Fp, bool)
        pad_valid[:F] = True
        if model.uv is not None:
            uv = model.uv[faces[:, :, 1]][..., :2].astype(np.float32)
        else:
            uv = np.zeros((F, 3, 2), np.float32)
        mtl = faces[:, 0, 3].astype(np.int64)
        # Host arrays of the per-face tables, tensors of the rest, in the
        # packet's order.
        packet = {
            "vid": vid,
            "pad_valid": pad_valid,
            "uv": _pad_rows(uv, Fp),
            "kd": _pad_rows(_material_table(model, "Kd", 3)[mtl], Fp),
            "ks": _pad_rows(_material_table(model, "Ks", 3)[mtl], Fp),
            "ns": _pad_rows(_material_table(model, "Ns", 1)[:, 0][mtl], Fp),
            "pm": _pad_rows(_material_table(model, "Pm", 1)[:, 0][mtl], Fp),
            "pr": _pad_rows(_material_table(model, "Pr", 1)[:, 0][mtl], Fp),
            "ka": _pad_rows(_material_table(model, "Ka", 3)[mtl], Fp),
        }
        has_vn = model.normals is not None
        if has_vn:
            packet["vn"] = _pad_rows(
                model.normals[faces[:, :, 2]].astype(np.float32), Fp)

        # Edge incidence tensors for batched silhouette extraction.
        et = model.edge_table
        inc_edge = np.zeros(3 * Fp, np.int64)
        inc_dir = np.zeros((3 * Fp, 2), np.int64)
        inc_valid = np.zeros(3 * Fp, bool)
        inc_edge[:3 * F] = et.incidence_edge
        inc_dir[:3 * F] = et.incidence_dir
        inc_valid[:3 * F] = True
        packet.update(inc_edge=inc_edge, inc_dir=inc_dir, inc_valid=inc_valid)

        flags = {}
        for kind, attr in (("kd", "map_Kd"), ("ks", "map_Ks"), ("norm", "norm")):
            st = _texture_stack(model, attr, self.device)
            flags[kind] = st is not None
            if st is None:
                packet[f"{kind}_slot"] = np.full(Fp, -1, np.int32)
                packet[f"{kind}_shape"] = np.ones((Fp, 2), np.float32)
                continue
            stack, slot, shape, tangent, scale_off = st
            packet[f"{kind}_stack"] = stack
            packet[f"{kind}_slot"] = _pad_rows(slot[mtl], Fp)
            packet[f"{kind}_shape"] = _pad_rows(shape[mtl], Fp)
            packet[f"{kind}_scale_off"] = scale_off
            if kind == "norm":
                packet["norm_tangent"] = _pad_rows(tangent[mtl], Fp)
        if "norm_tangent" not in packet:
            packet["norm_tangent"] = np.zeros(Fp, bool)
        part = self._intern_faces(srcs, F, Fp, {
            k: a for k, a in packet.items() if isinstance(a, np.ndarray)})
        packet = {k: part.get(k, a) for k, a in packet.items()}
        packet["_faces"] = part
        return packet, dict(
            has_vn=has_vn, has_uv=model.uv is not None,
            has_map_kd=flags["kd"], has_map_ks=flags["ks"],
            has_norm=flags["norm"], num_edges=et.num_edges)

    def _intern_faces(self, srcs, F: int, Fp: int, arrays: dict) -> dict:
        """The device tensors of a shared part's per-face tables (host
        ``arrays`` by name): those of the last part packed from the same
        sources if every array equals its, so that a texture change keeps
        them, and with them the frame's ``dyn["faces"]`` and its compiled
        program; new ones otherwise."""
        key = tuple(id(s) for s in srcs) + (F, Fp)
        hit = self._face_parts.get(key)
        if hit is not None and hit[1].keys() == arrays.keys() and all(
                a.dtype == hit[1][k].dtype and np.array_equal(a, hit[1][k])
                for k, a in arrays.items()):
            return hit[2]
        part = {k: torch.as_tensor(a, device=self.device)
                for k, a in arrays.items()}
        # The sources are pinned beside the part, as in _shared.
        self._face_parts[key] = (srcs, arrays, part)
        return part

    def _face_tables(self, cfg, packets) -> dict:
        """``dyn["faces"]``: ``pipeline.face_tables`` of the frame, built
        again only when a model's per-face tables, vertex count or flags
        change."""
        key = tuple((id(p["_faces"]), p["verts"].shape[0], p["_config"])
                    for p in packets)
        if self._faces is None or self._faces[0] != key:
            # The parts are pinned beside the tables, so no key can alias
            # the id() of a freed part.
            self._faces = (key, [p["_faces"] for p in packets],
                           pl.face_tables(cfg, packets))
        return self._faces[2]

    @staticmethod
    def _cam_dyn(cam) -> dict:
        """Camera parameters as float32 CPU tensors: the per-frame matrices
        are composed on the host (pipeline.frame_inputs)."""
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32))
        return {"position": f32(cam.position), "center": f32(cam.center),
                "up": f32(cam.up), "fovy": f32(cam.fovy),
                "near": f32(cam.near), "far": f32(cam.far)}

    def _light_dyn(self) -> dict:
        lt = self.light
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device)
        light = {"position": f32(lt.position), "center": f32(lt.center),
                 "color": f32(lt.color), "ambient": f32(lt.ambient),
                 "specular_strength": f32(lt.specular_strength),
                 "constant": f32(lt.constant), "linear": f32(lt.linear),
                 "quadratic": f32(lt.quadratic)}
        _count_copies("light", "h2d", light.values())
        return light

    def _background(self):
        """("cubemap", None) or ("color", (3,) float32 tensor)."""
        if isinstance(self.skybox, CubeMap):
            _count_copies("background", "h2d", ())
            return "cubemap", None
        # Reference default purple-ish background (core.py:600).
        color = (self.skybox if self.skybox is not None
                 else [64 / 255, 0.5, 198 / 255])
        color = torch.as_tensor(np.asarray(color, np.float32),
                                device=self.device)
        _count_copies("background", "h2d", (color,))
        return "color", color

    # -------------------------------------------------------------- render

    def _prepare(self, resolution=None):
        """Pack the scene into (static SceneConfig, dict of tensors), at
        ``resolution`` (default the scene's; the SSAA render passes the
        scaled one). The per-model packets stay cached."""
        with span("prepare"):
            packets = [self._pack_model(m) for m in self.models]
            background, bg_color = self._background()
            cfg = SceneConfig(
                resolution=tuple(resolution or self.resolution),
                system=self.system,
                subsystem=self.subsystem, shadows=self.shadows,
                cam_projection_type=self.camera.projection_type,
                backface_culling=self.camera.backface_culling,
                light_type=self.light.light_type,
                models=tuple(p["_config"] for p in packets),
                shader=self.shader, background=background,
                has_debug_camera=self.debug_camera is not None,
                dbg_projection_type=(self.debug_camera.projection_type
                                     if self.debug_camera else 0))
            dyn = {
                "models": [{k: v for k, v in p.items()
                            if not k.startswith("_")} for p in packets],
                "camera": self._cam_dyn(self.camera),
                "light": self._light_dyn(),
            }
            if packets:
                dyn["faces"] = self._face_tables(cfg, packets)
            if self.debug_camera is not None:
                dyn["debug_camera"] = self._cam_dyn(self.debug_camera)
            if background == "color":
                dyn["background_color"] = bg_color
            else:
                dyn["skybox"] = self.skybox.as_device_arrays(self.device)
            return cfg, dyn

    def render(self) -> np.ndarray:
        """Render one frame; returns (H, W, 3) uint8, same as core.py:587-640.
        The z-buffer, winner ids and stencil stay on the device as
        ``last_zbuf``, ``last_tid`` and ``last_stencil``.

        With a debug camera (and ``debug_overlay``), the general, flat,
        gouraud and pbr frames get its frustum drawn over them
        (scene.py:824-848 of the JAX package, which draws on the host): the
        pre-flip frame and the z-buffer are cast to float64 on the scene's
        device, the host computes the frustum's segments with both
        cameras' float64 host matrices, K11 draws them and K12 flips,
        applies gamma 0.8 and casts to uint8, both in float64 on the card
        (on the CPU, their numpy plain versions); only the uint8 frame
        comes to the host. ``last_zbuf`` is then the z-buffer as the
        overlay left it, a float64 tensor on the scene's device. Wireframe
        and points draw no overlay, as in the JAX package.

        With ``supersample`` = ss > 1 (scene.py:797-819 of the JAX package)
        the frame renders at ss times the resolution and is box-filtered
        down (``pipeline.render_ssaa_jit``); ``last_*`` then hold the
        buffers at the scaled size. With the wireframe or points shader, or
        a debug camera, ss is ignored with a RuntimeWarning and the frame
        renders at its own size.

        Every path runs a compiled program (``pipeline.*_jit``): on the
        card a replayed CUDA graph, captured at the first frame of its
        static key; if capture or replay fails, this raises.

        The frame runs under a ``tr.render`` span (utils/profiling.py), its
        copy to the host under ``tr.readback``; after that copy the timers
        of a replay made under a profiler are read."""
        with span("render"):
            frame = self._render()
            profiling.read_replay_timers()
            return frame

    def _render(self) -> np.ndarray:
        ss = self.supersample
        if ss > 1 and (self.shader in DEBUG_SHADERS
                       or self.debug_camera is not None):
            # The debug shaders' splats are exact per pixel, and the overlay
            # draws on the pre-flip frame at its own size.
            reason = ("wireframe/points shader" if self.shader in
                      DEBUG_SHADERS else "debug-camera overlay")
            warnings.warn(
                f"supersample={ss} is ignored with a {reason}; rendering at "
                "native resolution", RuntimeWarning, stacklevel=3)
        elif ss > 1:
            h, w = self.resolution
            cfg, dyn = self._prepare(resolution=(h * ss, w * ss))
            out, zbuf, tid, stencil = render_ssaa_jit(cfg, dyn, ss)
            self.last_zbuf, self.last_tid, self.last_stencil = \
                zbuf, tid, stencil
            return _readback(out)[0]
        cfg, dyn = self._prepare()
        if self.shader in DEBUG_SHADERS:
            return self._render_debug_shader(cfg, dyn)
        if self.debug_camera is not None and self.debug_overlay:
            out, zbuf, tid, stencil = self._render_overlay(cfg, dyn)
            self.last_zbuf, self.last_tid, self.last_stencil = \
                zbuf, tid, stencil
            return out
        out, zbuf, tid, stencil = render_frame_jit(cfg, dyn)
        self.last_zbuf, self.last_tid, self.last_stencil = zbuf, tid, stencil
        return _readback(out)[0]

    def _render_overlay(self, cfg, dyn, ops=None):
        """The pre-flip frame through ``render_core_jit`` (or, given
        ``ops``, the eager ``render_core`` through them: the plain path a
        test holds the frame to), then the debug camera's frustum over it.
        Returns (frame_u8 (H, W, 3) numpy, zbuf float64 as the overlay left
        it, tid, stencil), the buffers on the scene's device.

        Under ``tr.overlay``: the float64 casts of the frame and the
        z-buffer on their device (``tr.overlay_cast``); the drawing
        (``tr.overlay_draw``, around both cameras' float64 matrices,
        ``tr.overlay_matrices``, the segment table, ``tr.overlay_segments``,
        and on the card K11's call, ``tr.overlay_kernel``; its segments
        counted by ``profiling.count_overlay``, its line pixels on the
        device, ``profiling.overlay_counter``); the flip, gamma and uint8
        (``tr.overlay_quantize``); the copy of the uint8 frame to the host
        (``tr.readback``). On the card the host computes the segment table
        (ops/overlay.frustum_segments), and K11 draws it and K12 quantizes
        (``ops``, default ``raster_cuda.KERNELS``), eagerly after the
        replay. On the CPU ``draw_view_frustum`` draws on the buffers'
        memory in numpy, and K12's plain version quantizes."""
        frame, zbuf, tid, stencil = (render_core_jit(cfg, dyn) if ops is None
                                     else render_core(cfg, dyn, ops))
        ops = ops or rc.KERNELS
        with span("overlay"):
            with span("overlay_cast"):
                frame, zb = frame.to(torch.float64), zbuf.to(torch.float64)
            with span("overlay_draw"):
                with span("overlay_matrices"):
                    cams = (self.camera._matrices(torch.float64),
                            self.debug_camera._matrices(torch.float64),
                            self.camera.position, self.camera.near,
                            self.camera.far, self.resolution)
                counter = profiling.overlay_counter(zb.device)
                if zb.is_cuda:
                    table = frustum_segments(*cams)
                    with span("overlay_kernel"):
                        ops.overlay(torch.from_numpy(table), frame, zb,
                                    self.system, counter)
                    segments = len(table)
                else:
                    segments, pixels = draw_view_frustum(
                        frame.numpy(), *cams, zb.numpy(), self.system)
                    counter += pixels
            profiling.count_overlay(segments)
            with span("overlay_quantize"):
                out = ops.overlay_quantize(frame)
            out = _readback(out)[0]
        return out, zb, tid, stencil

    def _render_debug_shader(self, cfg, dyn) -> np.ndarray:
        """Wireframe / points shaders (reference triangular.py:269-283):
        K6 line coverage or the scatter-max point splat
        (pipeline.render_debug_frame_jit)."""
        out, zbuf, tid, stencil = render_debug_frame_jit(cfg, dyn,
                                                         self.shader)
        self.last_zbuf, self.last_tid, self.last_stencil = zbuf, tid, stencil
        return _readback(out)[0]

    def _render_debug_shader_host(self, cfg, dyn) -> np.ndarray:
        """Host-loop wireframe / points shaders (scene.py:900-951 of the
        JAX package), in float64 numpy: the oracle the device path (K6 and
        the scatter-max splat) is held to. The gouraud path still resolves
        the z-buffer through ``render_core_jit``."""
        _, zbuf, tid, stencil = render_core_jit(
            dataclasses.replace(cfg, shader=SHADER_GOURAUD), dyn)
        zb = zbuf.cpu().numpy().astype(np.float64)
        self.last_zbuf, self.last_tid, self.last_stencil = \
            torch.from_numpy(zb), tid, stencil

        h, w = self.resolution
        frame = pl._background(cfg, dyn, pl._stage(cfg, dyn), h, w)
        frame = frame.cpu().numpy().astype(np.float64)

        mvp = np.asarray(self.camera.MVP, np.float64)
        vp = np.asarray(self.camera.viewport, np.float64)
        near, far = self.camera.near, self.camera.far
        tris, normals = [], []
        for m in self.models:
            v = m.vertices.astype(np.float64) @ mvp
            v = v / v[:, [3]]
            v = v @ vp
            # The reference linearizes vertex z before its wireframe and
            # points shaders run (triangular.py:96, then :269/:277): the z
            # test compares against the linearized z-buffer.
            v[:, 2] = (2 * near * far) / (far + near - v[:, 2] * (far - near))
            fv = m.face_array[:, :, 0]
            tris.append(v[fv][:, :, :3])
            world = m.vertices[:, :3].astype(np.float64)
            n = np.cross(world[fv[:, 1]] - world[fv[:, 0]],
                         world[fv[:, 2]] - world[fv[:, 0]])
            norm = np.linalg.norm(n, axis=1, keepdims=True)
            normals.append(n / np.where(norm == 0, 1, norm))
        tris = np.concatenate(tris)
        normals = np.concatenate(normals)

        if self.shader == "wireframe":
            draw_wireframe(frame, zb, tris)
        else:
            draw_points(frame, tris, self.camera.position, normals)
        return (np.clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8)

    def stats(self):
        """Per-model render statistics from the last render()
        (scene.py:856-887 of the JAX package; the reference's per-face
        Errors printout, core.py:634-636): a list of dicts of ints, each
        with ``by_error``, the discard counters keyed by :class:`Errors`.

        It packs the scene again and reruns the vertex stage against the
        cached ``last_tid`` (``pipeline.face_statistics_jit``), at the scene's
        own resolution also after a supersampled render, whose ``last_tid``
        has the scaled size, as the JAX package does. A debug helper, not
        for a render loop. Raises RuntimeError before any render.
        """
        if self.last_tid is None:
            raise RuntimeError("render() must run before stats()")
        cfg, dyn = self._prepare()
        raw = face_statistics_jit(cfg, dyn, torch.as_tensor(
            self.last_tid, device=self.device))
        if not raw:
            return []
        keys = list(raw[0])
        # One host sync for every counter of every model.
        values = torch.stack([s[k] for s in raw for k in keys]).tolist()
        out = []
        for i in range(len(raw)):
            d = dict(zip(keys, values[i * len(keys):(i + 1) * len(keys)]))
            d["by_error"] = {
                Errors.BACK_FACE_CULLING: d["backface_culled"],
                Errors.EMPTY_B: d["degenerate"],
                Errors.WRONG_MIN_MAX: d["offscreen"],
                # Fragment-level discards collapse in the batched pipeline.
                Errors.CLIPPED | Errors.EMPTY_Z: d["occluded_or_clipped"],
            }
            out.append(d)
        return out
