"""The render mesh of ranks and the collectives that merge their buffers.

Counterpart of ``tpu_renderer/parallel/mesh.py``. The scaling axes of a
rasterizer are pixels and primitives: the frame splits into blocks of rows
over the ``rows`` axis, and the face batch into shards over the ``tris``
axis, whose partial z, id, G-buffer and stencil buffers merge with
``torch.distributed`` collectives (MIN, MAX, SUM: depth and signed stencil
counts are associative reductions, and each G-buffer pixel has one owner).

The backend is the caller's: ``init_process_group`` is called before
:func:`make_render_mesh`. gloo serves the CPU, and several ranks that share
one card; NCCL serves ranks with a card each.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from tpu_renderer_torch.utils.profiling import span

__all__ = ["make_render_mesh", "all_reduce", "all_gather_rows", "ROWS_AXIS",
           "TRIS_AXIS"]

ROWS_AXIS = "rows"
TRIS_AXIS = "tris"

_OPS = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
        "max": dist.ReduceOp.MAX}


def make_render_mesh(n_tris: int = 1, device_type: str = "cuda"):
    """A ``(rows, tris)`` DeviceMesh over every rank of the default process
    group: ``n_tris`` ranks share each block of rows, one triangle shard
    each; the rest of the ranks split the frame's rows. Rank r sits at
    (r // n_tris, r % n_tris)."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if world % n_tris:
        raise ValueError(f"{world} ranks not divisible by n_tris={n_tris}")
    return init_device_mesh(device_type, (world // n_tris, n_tris),
                            mesh_dim_names=(ROWS_AXIS, TRIS_AXIS))


def _staged(t, group):
    """The tensor a collective of ``group`` runs on. torch.distributed's
    backend table gives gloo CUDA tensors for broadcast and all_reduce only,
    not all_gather, and gloo copies a CUDA tensor through host memory
    itself; so for a gloo group every CUDA tensor is staged through host
    memory here, for every collective alike. Any other backend runs on
    ``t`` as it lies."""
    if t.is_cuda and dist.get_backend(group) == dist.Backend.GLOO:
        return t.cpu()
    return t


def all_reduce(t, op, group, what):
    """``t`` reduced with ``op`` ("sum", "min" or "max") over ``group``, in
    place, under a ``tr.merge_<what>`` profiler range; ``t`` unchanged when
    ``group`` is None (one shard). Every rank of the group must call it in
    the same order."""
    if group is None:
        return t
    with span(f"merge_{what}"):
        staged = _staged(t, group)
        dist.all_reduce(staged, op=_OPS[op], group=group)
        if staged is not t:
            t.copy_(staged)
        return t


def all_gather_rows(t, group):
    """Every rank's ``t`` concatenated along dim 0 in the group's rank
    order, under a ``tr.merge_frame`` range."""
    with span("merge_frame"):
        staged = _staged(t.contiguous(), group)
        parts = [torch.empty_like(staged)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, staged, group=group)
        return torch.cat(parts).to(t.device)
