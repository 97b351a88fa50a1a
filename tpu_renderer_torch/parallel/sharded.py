"""Multi-rank rendering over a ``(rows, tris)`` mesh with torch.distributed.

Counterpart of ``tpu_renderer/parallel/sharded.py``. Each rank rasterizes
a contiguous block of frame rows (the ``rows`` axis) for its shard of the
face batch (the ``tris`` axis); partial buffers merge with collectives
(ops/pipeline.py ``render_core``):

- z-buffer: MIN over ``tris`` (depth resolve is an associative min);
- winning face ids: a claim against the merged z (K7) + MAX (shard-major
  global ids, so the highest is the last face in order);
- silhouette parity and last light-facing incidence: SUM and MAX, so
  every rank sees the global silhouette-first order and count, and K8
  prepares the rank's contiguous stretch of those rows
  (``shadow.prepare_quads``);
- G-buffer, texture samples and stencil: SUM of partial buffers (each
  G-buffer pixel is written by the one shard that owns its winner, zero on
  the others; signed stencil counts commute);
- the frame: an all_gather of the quantized row blocks over ``rows``.

Every rank calls :func:`render_frame_sharded` with the whole scene's
``dyn`` on its own device and gets the whole frame back.
"""
from __future__ import annotations

import dataclasses

import torch

from tpu_renderer_torch.ops import raster_cuda as rc
from tpu_renderer_torch.ops.pipeline import (SHADER_GENERAL, SLIM_SHADERS,
                                             SceneConfig, _quantize,
                                             render_core)
from tpu_renderer_torch.parallel.mesh import (ROWS_AXIS, TRIS_AXIS,
                                              all_gather_rows)

__all__ = ["render_frame_sharded", "pad_models_for_tris", "shard_dyn",
           "shard_config"]

#: Per-model packet keys sharded along the face axis (the JAX package's
#: list without its sampler-window keys).
_FACE_KEYS = ("vid", "pad_valid", "uv", "kd", "ks", "ns", "pm", "pr", "ka",
              "kd_slot", "ks_slot", "norm_slot", "kd_shape", "ks_shape",
              "norm_shape", "norm_tangent", "vn")
#: Incidence tensors sharded along the (3 * faces) axis.
_INC_KEYS = ("inc_edge", "inc_dir", "inc_valid")


def _with_models(dyn, models):
    """``dyn`` over ``models``, without the face tables of its own models
    (``dyn["faces"]``, pipeline.face_tables): ``render_core``'s entry
    builds the new models' own (pipeline.with_face_tables)."""
    return dict({k: v for k, v in dyn.items() if k != "faces"}, models=models)


def _pad(a, n):
    return torch.cat([a, a.new_zeros((n,) + tuple(a.shape[1:]))])


def pad_models_for_tris(dyn, n_tris: int, chunk: int = 8):
    """Pad each model's face tensors with zeros (invalid faces) so that
    every shard holds the same multiple of ``chunk`` faces of it — the JAX
    package's padding, so global ids match its ids on the same mesh."""
    if n_tris == 1:
        return dyn
    models = []
    for md in dyn["models"]:
        pad = (-md["vid"].shape[0]) % (n_tris * chunk)
        md = dict(md)
        if pad:
            for k in _FACE_KEYS:
                if k in md:
                    md[k] = _pad(md[k], pad)
            for k in _INC_KEYS:
                md[k] = _pad(md[k], 3 * pad)
        models.append(md)
    return _with_models(dyn, models)


def shard_dyn(dyn, n_tris: int, tris_idx: int):
    """Shard ``tris_idx`` of a padded ``dyn``: an even slice of each
    model's face and incidence tensors; vertices, textures, camera and light
    are whole on every shard (the JAX package's ``dyn_partition_specs``)."""
    models = []
    for md in dyn["models"]:
        md = dict(md)
        for k in _FACE_KEYS + _INC_KEYS:
            if k in md:
                n = md[k].shape[0] // n_tris
                md[k] = md[k][tris_idx * n:(tris_idx + 1) * n]
        models.append(md)
    return _with_models(dyn, models)


def shard_config(cfg: SceneConfig, dyn):
    """``cfg`` with each model's ``num_faces`` its rows in ``dyn`` (a
    shard of :func:`shard_dyn`), the rows a body slices per model."""
    return dataclasses.replace(cfg, models=tuple(
        dataclasses.replace(mc, num_faces=md["vid"].shape[0])
        for mc, md in zip(cfg.models, dyn["models"])))


def render_frame_sharded(cfg: SceneConfig, dyn, mesh, ops=rc.KERNELS):
    """Render one frame across ``mesh`` (parallel.mesh.make_render_mesh);
    every rank of it calls this with the whole scene's ``dyn``.

    Returns (frame_u8 (H, W, 3), zbuf, tid, stencil), each the whole frame
    on every rank. tid holds shard-major global ids: face index within the
    shard's slice of each model, shards padded as :func:`pad_models_for_tris`.
    Serves the general, flat, gouraud and pbr shaders. With a debug camera
    (``cfg.has_debug_camera``, ``dyn["debug_camera"]`` on every rank), K1's
    z-only mode and K7 clip in its space too; no overlay is drawn, as in
    the JAX package's sharded frame.
    """
    if cfg.shader not in (SHADER_GENERAL,) + SLIM_SHADERS:
        raise NotImplementedError(f"sharded {cfg.shader!r} frames are not "
                                  "ported (general, flat, gouraud, pbr)")
    n_rows = mesh.size(mesh.mesh_dim_names.index(ROWS_AXIS))
    n_tris = mesh.size(mesh.mesh_dim_names.index(TRIS_AXIS))
    height, width = cfg.resolution
    if height % n_rows:
        raise ValueError(f"height {height} not divisible by rows={n_rows}")
    local_h = height // n_rows
    row_idx = mesh.get_local_rank(ROWS_AXIS)
    tris_idx = mesh.get_local_rank(TRIS_AXIS)
    group = None
    if n_tris > 1:
        dyn = shard_dyn(pad_models_for_tris(dyn, n_tris), n_tris, tris_idx)
        cfg = shard_config(cfg, dyn)
        group = mesh.get_group(TRIS_AXIS)
    frame, zbuf, tid, stencil = render_core(
        cfg, dyn, ops, local_height=local_h, row0=row_idx * local_h,
        tris_group=group, tris_idx=tris_idx)
    # _quantize flips its block; the flipped frame is the flipped blocks in
    # reverse order, so the gather of the frame runs over reversed blocks.
    out = _quantize(frame)
    if n_rows > 1:
        rows = mesh.get_group(ROWS_AXIS)
        blocks = all_gather_rows(out, rows).reshape(
            n_rows, local_h, width, 3)
        out = torch.flip(blocks, [0]).reshape(height, width, 3)
        zbuf, tid, stencil = (all_gather_rows(t, rows)
                              for t in (zbuf, tid, stencil))
    return out, zbuf, tid, stencil
