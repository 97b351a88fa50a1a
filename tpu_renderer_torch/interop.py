"""Carry a packed scene from the JAX package into the port.

``tpu_renderer``'s ``Scene._prepare()`` returns (config, dyn); with every
leaf of dyn converted to numpy (``jax.tree_util.tree_map(np.asarray, dyn)``)
:func:`dyn_from_numpy` turns it into the port's dict of tensors. This module
imports neither JAX nor ``tpu_renderer``: it reads plain numpy.

Feeding both packages the same packed scene separates a pipeline mismatch
from a packing mismatch in the tests.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["dyn_from_numpy"]

#: Per-model leaves the port's render path reads; the sampler window/grid
#: leaves (win_*, win2_*, windows) are dropped.
_MODEL_KEYS = ("verts", "vid", "pad_valid", "uv", "kd", "ks", "ns", "pm",
               "pr", "ka", "vn", "inc_edge", "inc_dir", "inc_valid",
               "norm_tangent")
_KINDS = ("kd", "ks", "norm")
_INDEX_KEYS = ("vid", "inc_edge", "inc_dir")


def _tensor(a, device, key):
    a = np.array(a)              # a writable copy (JAX hands out read-only)
    if key.endswith("_stack") or key == "packed":
        # uint32 RGB texels use at most 24 bits (scene.py:89-91 and
        # cubemap.py:66-73 of the JAX package): the same bits as int32.
        a = a.astype(np.uint32).view(np.int32)
    elif key in _INDEX_KEYS:
        a = a.astype(np.int64)
    return torch.as_tensor(a, device=device)


def dyn_from_numpy(dyn_np, device):
    """The JAX package's prepared dyn (numpy leaves) -> the port's dyn.

    Camera parameters, the debug camera's too, stay float32 tensors on the
    CPU (the port composes the per-frame matrices on the host); everything
    else lands on ``device``.
    A cubemap background arrives as ``skybox`` (its ``packed`` texels)
    instead of ``background_color``.
    """
    device = torch.device(device)
    models = []
    for md in dyn_np["models"]:
        out = {k: _tensor(md[k], device, k) for k in _MODEL_KEYS if k in md}
        for kind in _KINDS:
            for suffix in ("slot", "shape", "stack", "scale_off"):
                key = f"{kind}_{suffix}"
                if key in md:
                    out[key] = _tensor(md[key], device, key)
        models.append(out)
    f32 = lambda a, dev=device: torch.as_tensor(
        np.array(a, np.float32), device=dev)
    dyn = {
        "models": models,
        "camera": {k: f32(v, "cpu") for k, v in dyn_np["camera"].items()},
        "light": {k: f32(v) for k, v in dyn_np["light"].items()},
    }
    if "debug_camera" in dyn_np:
        dyn["debug_camera"] = {k: f32(v, "cpu") for k, v in
                               dyn_np["debug_camera"].items()}
    if "skybox" in dyn_np:
        dyn["skybox"] = {"packed": _tensor(dyn_np["skybox"]["packed"],
                                           device, "packed")}
    else:
        dyn["background_color"] = f32(dyn_np["background_color"])
    return dyn
