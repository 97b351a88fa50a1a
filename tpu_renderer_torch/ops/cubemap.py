"""Cubemap skyboxes: host-side texture assembly + per-pixel sampling, in
PyTorch.

Counterpart of ``tpu_renderer/ops/cubemap.py`` (reference
``obj/cube_map.py``): the six textures get the same per-face
flip/rotate/transpose fixups (:25-43), the screen is two NDC-corner
triangles (:45-54), direction vectors map to (face, u, v) by major-axis
selection (:63-80), and the frame fill interpolates rays from the NDC
corners through the inverse rotation-only view-projection (:83-101).

The 4x4 inverse, the corner rays and the screen triangles' scalars are
composed on the host in float32, like the camera matrices
(pipeline.frame_inputs stages them with those: :func:`skybox_inputs`), so
a frame rendered on the card and its plain-path twin read the same rays.
The fill (:func:`fill_skybox`) then reads them as tensors on the device,
so a frame captured into a CUDA graph replays with each frame's camera.
The per-pixel ray sums are written out term by term, so they round the
same way on the CPU and on the card.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_renderer_torch.ops.transforms import matmul

__all__ = ["CubeMap", "cubemap_index", "sample_cubemap",
           "sample_cubemap_packed", "fill_frame_from_skybox",
           "skybox_inputs", "fill_skybox", "NDC_FACES"]

#: Two triangles covering the NDC square (reference cube_map.py:45-54).
NDC_FACES = np.array([
    [[-1, 1, 1, 1], [1, 1, 1, 1], [-1, -1, 1, 1]],
    [[1, 1, 1, 1], [1, -1, 1, 1], [-1, -1, 1, 1]],
], dtype=np.float32)


class CubeMap:
    """Six-face environment map (reference cube_map.py:8-61).

    Each face is an (T, T, 3) float array in [0, 1] or an image path; paths
    are opened with Pillow, which is imported only then. Face order in the
    stacked texture array: +X, -X, +Y, -Y, +Z, -Z (sides = (amplitude < 0)
    + 2 * major_axis).
    """

    def __init__(self, left, right, top, bottom, front, back,
                 normalize_input=True):
        load = self.load_texture
        if normalize_input:
            textures = [
                np.flip(load(right), axis=(0, 1)),
                np.rot90(load(left).transpose((1, 0, 2)), -1),
                load(top).transpose((1, 0, 2)),
                np.rot90(load(bottom)),
                np.rot90(load(front), -1),
                load(back).transpose((1, 0, 2)),
            ]
        else:
            textures = [load(right), load(left), load(top), load(bottom),
                        load(front), load(back)]
        self.textures = np.array(textures, dtype=np.float32)
        self.faces = NDC_FACES.copy()
        self._device_arrays = {}

    @staticmethod
    def load_texture(face):
        """An (T, T, >=3) array as float32 RGB, or an image file's RGB / 255."""
        if isinstance(face, np.ndarray):
            return np.asarray(face, np.float32)[..., :3]
        from PIL import Image

        return np.asarray(Image.open(face), dtype=np.float32)[..., :3] / 255.0

    def __getitem__(self, vectors):
        """Direction -> texel lookup (reference cube_map.py:63-80)."""
        return sample_cubemap(torch.from_numpy(self.textures),
                              torch.as_tensor(np.asarray(vectors, np.float32))
                              ).numpy()

    def as_device_arrays(self, device):
        """``packed``: (6, T, T) int32 RGB texels (8 bits each, the bits of
        the JAX package's u32; the faces are 8-bit images, so this is
        exact), on ``device``, uploaded once per device."""
        device = torch.device(device)
        arrays = self._device_arrays.get(device)
        if arrays is None:
            q = np.round(self.textures * 255).astype(np.int32)
            packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
            arrays = {"packed": torch.from_numpy(packed).to(device)}
            self._device_arrays[device] = arrays
        return arrays


def cubemap_index(t, vectors):
    """Direction -> (side, iu, iv) cubemap texel index (int64).

    Major-axis face selection (the first of equal maxima, as ``argmax`` in
    both frameworks), the reference's ``* T - 1`` index scale with a
    truncating cast and the ``-1 -> T - 1`` wrap. Indices are then clamped
    into [0, T - 1]; that changes nothing for a finite direction and keeps
    the gather in bounds for a zero or NaN one, where XLA's gather clamps.
    """
    ax, ay, az = vectors[..., 0], vectors[..., 1], vectors[..., 2]
    major = torch.argmax(torch.abs(vectors), dim=-1)
    amp = torch.where(major == 0, ax, torch.where(major == 1, ay, az))
    # The non-major components in original order: major 0 -> (y, z);
    # 1 -> (x, z); 2 -> (x, y).
    u = torch.where(major == 0, ay, ax)
    v = torch.where(major == 2, ay, az)

    nu = (u / amp + 1) / 2
    nv = (v / amp + 1) / 2
    side = (amp < 0).to(torch.int64) + major * 2
    iu = (nu * t - 1).to(torch.int32)
    iv = (nv * t - 1).to(torch.int32)
    iu = torch.where(iu < 0, iu + t, iu)
    iv = torch.where(iv < 0, iv + t, iv)
    iu = torch.clamp(iu, 0, t - 1).to(torch.int64)
    iv = torch.clamp(iv, 0, t - 1).to(torch.int64)
    return side, iu, iv


def sample_cubemap(textures, vectors):
    """Sample a (6, T, T, 3) cubemap with (..., 3) direction vectors."""
    side, iu, iv = cubemap_index(textures.shape[1], vectors)
    return textures[side, iu, iv]


def sample_cubemap_packed(packed, vectors):
    """Sample a (6, T, T) int32-packed cubemap: one gather + unpack."""
    t = packed.shape[1]
    side, iu, iv = cubemap_index(t, vectors)
    texel = packed.reshape(-1)[(side * t + iu) * t + iv]
    r = (texel & 0xFF).to(torch.float32)
    g = ((texel >> 8) & 0xFF).to(torch.float32)
    b = ((texel >> 16) & 0xFF).to(torch.float32)
    return torch.stack([r, g, b], dim=-1) / 255.0


def _triangle_scalars(corners_xy):
    """The scalars of cube_map.py:89's ``barycentric(*test[XY].astype(int),
    p)`` for an NDC triangle's screen corners (3, 2) float32: the corners
    cast to int, then each product and sum in float32 on the host (numpy
    rounds each op). Returns a (10,) float32 CPU tensor: ax, ay, v0x, v0y,
    v1x, v1y, d00, d01, d11, 1 / denominator."""
    ax, ay, bx, by, cx, cy = corners_xy.to(torch.int32).to(
        torch.float32).reshape(-1).numpy()
    v0x, v0y = bx - ax, by - ay
    v1x, v1y = cx - ax, cy - ay
    d00 = v0x * v0x + v0y * v0y
    d01 = v0x * v1x + v0y * v1y
    d11 = v1x * v1x + v1y * v1y
    inv_denom = np.float32(1.0) / (d00 * d11 - d01 * d01)
    return torch.from_numpy(np.array(
        [ax, ay, v0x, v0y, v1x, v1y, d00, d01, d11, inv_denom], np.float32))


def skybox_inputs(cam_host):
    """The host half of the skybox fill (reference cube_map.py:83-101):
    the corner rays of the two NDC triangles through the inverse
    rotation-only view-projection, and their screen triangles' scalars.

    cam_host: the camera matrices (``lookat``, ``projection``,
    ``viewport``, float32 CPU tensors). Returns (rays (2, 3, 3), tri (2,
    10)) float32 CPU tensors, each triangle's scalars as
    :func:`_triangle_scalars` orders them.
    """
    # Rotation-only view (the reference zeroes lookat's translation row).
    view_rot = cam_host["lookat"].clone()
    view_rot[3, :3] = 0.0
    inv_vp = torch.linalg.inv(matmul(view_rot, cam_host["projection"]))
    rays, tris = [], []
    for i in range(2):
        face = torch.from_numpy(NDC_FACES[i])
        screen = matmul(face, cam_host["viewport"])
        tris.append(_triangle_scalars(screen[:, :2]))
        r = matmul(face, inv_vp)
        rays.append((r / r[:, 3:4])[:, :3])
    return torch.stack(rays), torch.stack(tris)


def _corner_barycentric(tri, height, width, row0=0):
    """Screen barycentric of every pixel of the ``height`` frame rows from
    ``row0`` w.r.t. a triangle given by its scalars ``tri`` (10,) float32
    on the device (:func:`skybox_inputs`). Returns (bar (H, W, 3),
    cover (H, W) bool)."""
    ax, ay, v0x, v0y, v1x, v1y, d00, d01, d11, inv_denom = tri.unbind()
    device = tri.device
    cols = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    rows = torch.arange(row0, row0 + height, dtype=torch.float32,
                        device=device)[:, None]
    v2x = cols - ax
    v2y = rows - ay
    d20 = v2x * v0x + v2y * v0y
    d21 = v2x * v1x + v2y * v1y
    v = (d11 * d20 - d01 * d21) * inv_denom
    w = (d00 * d21 - d01 * d20) * inv_denom
    u = 1.0 - v - w
    bar = torch.stack([u, v, w], dim=-1)
    return bar, (bar >= 0).all(dim=-1)


def fill_skybox(packed, rays, tri, resolution, row0=0):
    """The device half of the skybox fill: each pixel's ray from its NDC
    triangle's corner rays, then one cubemap sample. ``packed`` (6, T, T)
    int32 texels, ``rays`` and ``tri`` from :func:`skybox_inputs`, all on
    one device; the ``resolution[0]`` frame rows from ``row0``. Returns
    (H, W, 3) float32; pixels outside both NDC triangles are 0."""
    height, width = resolution
    # The two NDC triangles partition the frame: pick each pixel's ray first
    # (the second triangle wins on the shared diagonal, like the reference's
    # sequential overwrite), then sample the cubemap once.
    dirs, covers = [], []
    for i in range(2):
        bar, cover = _corner_barycentric(tri[i], height, width, row0)
        r = rays[i]
        dirs.append(bar[..., 0:1] * r[0] + bar[..., 1:2] * r[1]
                    + bar[..., 2:3] * r[2])
        covers.append(cover)
    ray_dirs = torch.where(covers[1][..., None], dirs[1], dirs[0])
    covered = covers[0] | covers[1]

    sampled = sample_cubemap_packed(packed, ray_dirs)
    return torch.where(covered[..., None], sampled,
                       torch.zeros_like(sampled))


def fill_frame_from_skybox(skybox, cam_host, resolution, device, row0=0):
    """Full-frame skybox background (reference cube_map.py:83-101), or the
    block of ``resolution[0]`` frame rows from ``row0``: the host's
    :func:`skybox_inputs`, moved to ``device``, then :func:`fill_skybox`.

    skybox: dict with ``packed`` (6, T, T) int32 texels on ``device``;
    cam_host: the camera matrices on the host
    (``lookat``, ``projection``, ``viewport``, float32 CPU tensors).
    Returns (H, W, 3) float32 on ``device``.
    """
    rays, tri = (t.to(device) for t in skybox_inputs(cam_host))
    return fill_skybox(skybox["packed"], rays, tri, resolution, row0)
