"""Plain PyTorch visibility rasterizer: the port's oracle for kernel K1.

Counterpart of ``tpu_renderer/ops/raster_xla.py``. The frame is resolved as a
**visibility buffer** (per pixel, the id of the winning triangle) in two
passes over the packed face table (``raster_cuda.pack_faces``):

- *z pass* (reference pass 1's depth writes, triangular.py:96-118): for every
  z-writing face, coverage ∧ sign-aware depth test. The sequential update
  ``zb >= z·sign -> zb = z·sign`` in face order is a running minimum, so it
  is computed as a min-reduction over chunks of faces.
- *id pass* (reference pass 3's re-test against the final z-buffer,
  triangular.py:99-109): every face claims pixels where coverage ∧ final-z
  test pass; later faces overwrite, i.e. the claiming face with the highest
  id wins — a max-reduction.

Both reductions are exact, so the result equals the JAX package's in-order
scan; only the evaluation is vectorized over ``chunk`` faces at a time.
For sharded rendering the frame is a block of rows starting at ``row0``
(pixel math in global coordinates), and the id pass can write ``gid0`` +
the local face index (a triangle shard's shard-major global ids). With a
debug camera, ``fdbg`` (raster_cuda.pack_debug_planes) holds each face's
pre-scaled planes of the debug camera's clip space, which the per-pixel
clip test checks after the camera's own.
Brute force O(F·H·W): it exists for CPU tests and as the reference the
CUDA kernel is held to on the card.
"""
from __future__ import annotations

import torch

__all__ = ["face_fragments", "zbuffer_pass", "visibility_pass",
           "render_visibility", "F_AFF", "F_INV_W", "F_BBOX", "F_CLIP",
           "F_COLS", "DBG_COLS", "FLAG_VALID", "FLAG_CLIP", "FLAG_ZWRITE",
           "FLAG_PPC"]

# Packed face table layout (raster_cuda.pack_faces, the layout of
# raster_pallas.pack_faces without its 128-lane padding):
F_AFF = 0      # [0:9]   av bv cv aw bw cw az bz cz
F_INV_W = 9    # [9:12]  per-vertex 1/w
F_BBOX = 12    # [12:16] ceil'd clamped bbox x0 x1 y0 y1 as float
F_CLIP = 16    # [16:34] e[i, j] = inv_w[i] * cond_j(clip_i) at 16 + 6*i + j
F_COLS = 34
# The debug camera's planes (raster_cuda.pack_debug_planes), a table of
# their own: e_dbg[i, j] at 6*i + j, pre-scaled as F_CLIP's.
DBG_COLS = 18

# Face flag word (raster_cuda.face_flags).
FLAG_VALID = 1
FLAG_CLIP = 2
FLAG_ZWRITE = 4
FLAG_PPC = 8     # clip-enabled and not wholly inside: per-pixel clip test


def _grid(height, width, device, row0=0):
    """Pixel rows (H, 1) from ``row0`` and columns (1, W), as float32."""
    rows = torch.arange(row0, row0 + height, dtype=torch.float32,
                        device=device)[:, None]
    cols = torch.arange(width, dtype=torch.float32, device=device)[None, :]
    return rows, cols


def face_fragments(fdata, flags, rows, cols, fdbg=None):
    """Coverage and interpolated depth for a chunk of C packed faces.

    fdata: (C, F_COLS) float32; flags: (C,) int32; rows (H, 1), cols (1, W)
    pixel coordinates (integers, no +0.5, like raster_xla.py:111-112);
    fdbg: (C, DBG_COLS) float32 or None (no debug camera).
    Returns (cov (C, H, W) bool, z (C, H, W) float32).
    """
    co = lambda c: fdata[:, c, None, None]
    v = co(0) * cols + co(1) * rows + co(2)
    w = co(3) * cols + co(4) * rows + co(5)
    u = 1.0 - v - w
    cov = (u >= 0) & (v >= 0) & (w >= 0)
    cov &= ((cols >= co(F_BBOX)) & (cols < co(F_BBOX + 1))
            & (rows >= co(F_BBOX + 2)) & (rows < co(F_BBOX + 3)))
    cov &= ((flags & FLAG_VALID) > 0)[:, None, None]

    # Linearized perspective-corrected clip test (raster_pallas.py:304-315):
    # q_j / S > 0  <=>  (q_j > 0) == (S > 0), S != 0 — evaluated for faces
    # with FLAG_PPC, over the camera's six planes, then the debug camera's
    # six (raster_pallas._face_tile_cov's spaces in order); a face wholly
    # inside every clip plane of both passes it at every interior pixel by
    # convexity, and clip=False faces skip it.
    ppc = (flags & FLAG_PPC) > 0
    if bool(ppc.any()):
        s = u * co(F_INV_W) + v * co(F_INV_W + 1) + w * co(F_INV_W + 2)
        ok = s != 0
        s_pos = s > 0
        spaces = [lambda c: co(F_CLIP + c)]
        if fdbg is not None:
            spaces.append(lambda c: fdbg[:, c, None, None])
        for e in spaces:
            for j in range(6):
                q = u * e(j) + v * e(6 + j) + w * e(12 + j)
                ok &= (q > 0) == s_pos
        cov &= ok | ~ppc[:, None, None]

    z = co(6) * cols + co(7) * rows + co(8)
    return cov, z


def _chunk(fdbg, c0, chunk):
    return None if fdbg is None else fdbg[c0:c0 + chunk]


def zbuffer_pass(fdata, flags, height, width, sign, chunk=16, row0=0,
                 fdbg=None):
    """Final z-buffer in sign space (z * sign, min-combine) over z-writing
    faces (reference triangular.py:117-118)."""
    rows, cols = _grid(height, width, fdata.device, row0)
    zb = torch.full((height, width), float("inf"), dtype=torch.float32,
                    device=fdata.device)
    inf = torch.tensor(float("inf"), device=fdata.device)
    for c0 in range(0, fdata.shape[0], chunk):
        fd, fl = fdata[c0:c0 + chunk], flags[c0:c0 + chunk]
        cov, z = face_fragments(fd, fl, rows, cols, _chunk(fdbg, c0, chunk))
        zs = z * sign
        upd = cov & ((fl & FLAG_ZWRITE) > 0)[:, None, None] & ~torch.isnan(zs)
        zb = torch.minimum(zb, torch.where(upd, zs, inf).amin(0))
    return zb


def visibility_pass(fdata, flags, zb_sign, height, width, sign, chunk=16,
                    row0=0, gid0=0, fdbg=None):
    """Winning face id per pixel against the FINAL z-buffer: ``gid0`` + the
    highest face index that covers the pixel and passes ``zb >= z * sign``;
    -1 where no face claims it."""
    rows, cols = _grid(height, width, fdata.device, row0)
    tid = torch.full((height, width), -1, dtype=torch.int32,
                     device=fdata.device)
    none = torch.tensor(-1, dtype=torch.int32, device=fdata.device)
    for c0 in range(0, fdata.shape[0], chunk):
        fd, fl = fdata[c0:c0 + chunk], flags[c0:c0 + chunk]
        cov, z = face_fragments(fd, fl, rows, cols, _chunk(fdbg, c0, chunk))
        claim = cov & (zb_sign >= z * sign)
        gid = torch.arange(gid0 + c0, gid0 + c0 + fd.shape[0],
                           dtype=torch.int32,
                           device=fdata.device)[:, None, None]
        tid = torch.maximum(tid, torch.where(claim, gid, none).amax(0))
    return tid


def render_visibility(fdata, flags, height, width, sign, chunk=16, row0=0,
                      want_tid=True, fdbg=None):
    """Full visibility resolve: (z-buffer in sign space, tid), or
    (z-buffer, None) with ``want_tid=False``."""
    zb_sign = zbuffer_pass(fdata, flags, height, width, sign, chunk, row0,
                           fdbg)
    if not want_tid:
        return zb_sign, None
    return zb_sign, visibility_pass(fdata, flags, zb_sign, height, width,
                                    sign, chunk, row0, fdbg=fdbg)
