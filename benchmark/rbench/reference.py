"""The plain reference renderer that decides ``correct``.

It renders a :class:`scenes.SceneSpec` with plain PyTorch operations, from
the spec's raw arrays, the frame's camera position and light position:
packing, texture quantization, the silhouette edge table, the vertex
stage, visibility, the G-buffer, texture sampling, shadow volumes, shading
and quantization are all worked out again here. It imports torch and numpy
only: nothing of the system under test, nothing of JAX.

It is a frozen copy of the semantics of the port's plain path
(``tpu_renderer_torch``'s ``raster_plain``, the ``*_plain`` functions of
``raster_cuda``, ``pipeline._core``, ``vertex``, ``shadow``, ``shading``,
``models/camera``) for the general shader over a color background,
expression for expression, so that on one device the two agree bit for
bit. Two parts are evaluated differently, with the same per-element
arithmetic: visibility enumerates each face's fragments inside its
bounding box (the plain path scans the whole frame per face; coverage
includes the box test, so the fragments are the same) and resolves z and
ids by scatter min and max (the plain path's running min and max, both
exact); texture sampling gathers from the reference's own texel pool.

``tf32=True`` is the control: every matrix product (the camera's
matrices, the vertex and shadow-quad transforms) takes its operands
rounded to TensorFloat-32, as a GPU matrix product with TF32 on does. The
configurations state float32 with TF32 off. ``dtype=torch.float64`` is a
second witness of sound arithmetic: the same frame, every operation
rounded otherwise, which shows how far sound arithmetic of another order
may move the numbers compared.

``counts`` of a render are what the roofline shares count
(``roofline.py``): faces that survive culling and the screen, covered
(face, pixel) fragments, silhouette quads, and (quad, foreground pixel)
fragments inside a quad.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["Reference", "Output", "tf32_round"]

_F32 = torch.float32
#: Faces are numbered in the frame's face batch with each model's first
#: face at a multiple of this; ``render`` gives each winner's number in the
#: spec's order instead.
FACE_PAD = 8
#: Padded vertex capacity of a clipped shadow quad (4 + 6 planes).
QUAD_PMAX = 12
LH = -1
#: Background colour where no face wins.
BACKGROUND = (64 / 255, 0.5, 198 / 255)
#: Material defaults (the MTL defaults of the reference renderer).
KD = (0.8, 0.8, 0.8)
KS = (1.0, 1.0, 1.0)
NS = 64.0
#: Texture kinds in the order of their sample-mask bits.
KINDS = ("kd", "norm", "ks")
#: G-buffer channels (the system's layout; the rest are texture slots and
#: shapes, which the general shader does not read).
GB_WORLD, GB_IU, GB_IV, GB_N, GB_TAN, GB_BIT = 0, 3, 4, 5, 8, 11
GB_KD, GB_KS, GB_NS, GB_TANGENT, GB_MODEL = 14, 17, 20, 27, 31
GB_CHANNELS = 32
#: Elements of one visibility chunk and of one stencil chunk.
FRAG_CHUNK = 1 << 24
QUAD_CHUNK = 32


def tf32_round(x):
    """float32 ``x`` with its mantissa rounded to TF32's 10 bits (to
    nearest, ties away from zero)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & -0x2000).view(_F32)


@dataclasses.dataclass
class Output:
    frame: torch.Tensor      # (H, W, 3) uint8
    zbuf: torch.Tensor       # (H, W) float32
    tid: torch.Tensor        # (H, W) int64: the winner's face number in
                             # the spec's order of models and faces, -1 none
    stencil: torch.Tensor    # (H, W) int32
    counts: dict


def normalize(a):
    l2 = torch.linalg.vector_norm(a, ord=2, dim=-1, keepdim=True)
    l2 = torch.where(l2 == 0, torch.ones_like(l2), l2)
    return a / l2


def _cross(a, b):
    return torch.stack([a[..., 1] * b[..., 2] - a[..., 2] * b[..., 1],
                        a[..., 2] * b[..., 0] - a[..., 0] * b[..., 2],
                        a[..., 0] * b[..., 1] - a[..., 1] * b[..., 0]], dim=-1)


def _dot3(a, b):
    return (a[..., 0] * b[..., 0] + a[..., 1] * b[..., 1]) + a[..., 2] * b[..., 2]


def _dot4(a, p):
    return ((a[..., 0] * p[0] + a[..., 1] * p[1]) + a[..., 2] * p[2]) \
        + a[..., 3] * p[3]


class Reference:
    """The plain renderer of one scene spec on ``device``, in ``dtype``
    (float32, as the configurations state; float64 is a second witness of
    sound arithmetic), with the operands of its matrix products rounded to
    TF32 where ``tf32``."""

    #: The settings (``scenes.SETTINGS``) this reference renders.
    SUPPORTS = {"system": "LH", "subsystem": "OPENGL",
                "projection": "perspective", "light_type": "point",
                "shader": "general", "supersample": 1}

    def __init__(self, spec, device, tf32=False, dtype=torch.float32):
        for key, want in self.SUPPORTS.items():
            if spec.settings[key] != want:
                raise ValueError(f"{key} {spec.settings[key]!r}: this "
                                 f"reference renders {want!r} only")
        self.spec = spec
        self.device = torch.device(device)
        self.tf32 = tf32
        self.dt = dtype
        self.height, self.width = spec.resolution
        self._models = []
        self._pool, self._slots, self._changed = [], {}, set()
        offset = 0
        for i, m in enumerate(spec.models):
            self._models.append(self._pack(i, m, offset))
            offset += max(FACE_PAD, -(-m.num_faces // FACE_PAD) * FACE_PAD)
        self.n_ids = offset
        dev = self.device
        self.pool = (torch.cat(self._pool) if self._pool
                     else torch.zeros(1, dtype=torch.int32)).to(dev)
        self.background = torch.as_tensor(np.asarray(BACKGROUND, np.float32),
                                          device=dev).to(dtype)
        self._id_tables()
        # The spec's face number of each id (-1 for padding ids).
        first = 0
        numbers = torch.full((self.n_ids + 1,), -1, dtype=torch.int64)
        for p in self._models:
            numbers[p["offset"]:p["offset"] + p["F"]] = \
                torch.arange(p["F"]) + first
            first += p["F"]
        self.face_numbers = numbers.to(dev)

    # --------------------------------------------------------- packing

    def _texture(self, src, kind, tangent):
        """(global slot, TH, TW, scale, offset) of a map, quantized to 8 bits
        per channel and RGB-packed into the reference's pool once per
        distinct array."""
        key = (id(src), kind)
        if key not in self._slots:
            packed, scale, offset = _quantize(src)
            start = sum(p.numel() for p in self._pool)
            self._pool.append(packed)
            self._slots[key] = (start, src.shape[0], src.shape[1], scale,
                                offset, tangent, src)
        return self._slots[key]

    def _set_maps(self, maps):
        """Give the models' maps the values ``maps`` ({model: {kind:
        array}}) names, every other map its own, in the pool and in the
        packets of every model that shares the map."""
        want = {self._models[k][kind][0]: array
                for k, kinds in (maps or {}).items()
                for kind, array in kinds.items()}
        done = {}
        for p in self._models:
            for kind in KINDS:
                if p[kind] is None:
                    continue
                start, th, tw, _, _, tangent, src = p[kind]
                if start not in want and start not in self._changed:
                    continue
                if start not in done:
                    tex = want.get(start, src)
                    if np.shape(tex)[:2] != (th, tw):
                        raise ValueError(f"a {kind} map of {th}x{tw} texels "
                                         f"cannot take {np.shape(tex)}")
                    packed, scale, offset = _quantize(tex)
                    self.pool[start:start + th * tw] = packed.to(self.device)
                    done[start] = (start, th, tw, scale, offset, tangent, src)
                p[kind] = done[start]
        self._changed = set(want)

    def _pack(self, index, m, offset):
        dev = self.device
        faces = np.asarray(m.faces)
        F = len(faces)
        t = lambda a, dtype=None: torch.as_tensor(a, dtype=dtype, device=dev)
        packet = {
            "index": index, "offset": offset, "F": F,
            "shadowing": m.shadowing,
            "verts": t(m.world_vertices(), self.dt),
            "vid": t(faces[:, :, 0].astype(np.int64)),
            "uv": t(m.uv[faces[:, :, 1]][..., :2].astype(np.float32)),
            "vn": t(m.normals[faces[:, :, 2]].astype(np.float32)),
        }
        for kind, src, tangent in (("kd", m.map_kd, False),
                                   ("norm", m.norm, m.norm_tangent),
                                   ("ks", None, False)):
            packet[kind] = (None if src is None
                            else self._texture(src, kind, tangent))
        # Unique undirected edges and each face-edge incidence's edge id and
        # directed vertex pair, face-major.
        fv = faces[:, :, 0].astype(np.int64)
        a, b = fv, np.roll(fv, -1, axis=1)
        keys = np.minimum(a, b).ravel() << 32 | np.maximum(a, b).ravel()
        _, edge_ids = np.unique(keys, return_inverse=True)
        packet["num_edges"] = int(edge_ids.max()) + 1 if edge_ids.size else 0
        packet["inc_edge"] = t(edge_ids.reshape(-1).astype(np.int64))
        packet["inc_dir"] = t(np.stack([a.ravel(), b.ravel()], axis=1))
        return packet

    def _id_tables(self):
        """Per face id: its model, texture slots and shapes, material and
        tangent flag (padding ids are never won)."""
        dev = self.device
        G = self.n_ids
        model_id = torch.zeros(G, dtype=self.dt, device=dev)
        kd = torch.zeros((G, 3), dtype=self.dt, device=dev)
        ks = torch.zeros((G, 3), dtype=self.dt, device=dev)
        ns = torch.zeros(G, dtype=self.dt, device=dev)
        tangent = torch.zeros(G, dtype=self.dt, device=dev)
        # Per kind: pool offset of the face's map (-1: none), its height,
        # width and row stride.
        ftex = torch.zeros((G, len(KINDS), 4), dtype=torch.int64, device=dev)
        ftex[..., 0] = -1
        ftex[..., 1:3] = 1
        for p in self._models:
            s = slice(p["offset"], p["offset"] + p["F"])
            model_id[s] = float(p["index"])
            kd[s] = torch.tensor(np.asarray(KD, np.float32), device=dev)
            ks[s] = torch.tensor(np.asarray(KS, np.float32), device=dev)
            ns[s] = float(np.float32(NS))
            for k, kind in enumerate(KINDS):
                tex = p[kind]
                if tex is not None:
                    ftex[s, k] = torch.tensor([tex[0], tex[1], tex[2],
                                               tex[2]], device=dev)
                    if kind == "norm" and tex[5]:
                        tangent[s] = 1.0
        self.ids = {"model_id": model_id, "kd": kd, "ks": ks, "ns": ns,
                    "tangent": tangent, "ftex": ftex}

    # --------------------------------------------------------- camera

    def _mm(self, a, b):
        if self.tf32:
            a, b = tf32_round(a), tf32_round(b)
        return torch.matmul(a, b)

    def _rowvec(self, v, m):
        if self.tf32:
            v, m = tf32_round(v), tf32_round(m)
        return (((v[..., 0:1] * m[0] + v[..., 1:2] * m[1])
                 + v[..., 2:3] * m[2]) + v[..., 3:4] * m[3])

    def camera_matrices(self, position):
        """MVP, viewport, frustum planes, near and far of the camera at
        ``position`` (float32 on the CPU, then moved): LH look-at built with
        (center, position) as the reference does, OpenGL LH perspective,
        MVP = translate @ rotate @ projection."""
        cam = self.spec.camera
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32)).to(dt)
        _t = lambda x: (x.to(dt) if isinstance(x, torch.Tensor)
                        else torch.tensor(np.asarray(x), dtype=dt))
        dt = self.dt
        position, center = f32(position), f32(cam["center"])
        up, fovy = f32((0, 1, 0)), f32(cam["fovy"])
        near, far = f32(cam["near"]), f32(cam["far"])
        # look_at_rotate_lh(eye=center, center=position, up)
        forward = normalize(_t(position) - _t(center)).reshape(-1)
        right = normalize(_cross(_t(up), forward)).reshape(-1)
        new_up = _cross(forward, right)
        rot = torch.eye(4, dtype=self.dt)
        rot[:3, :3] = torch.stack((right, new_up, -1.0 * forward), dim=1)
        trans = torch.eye(4, dtype=self.dt)
        trans[3, :3] = -_t(position)
        h, w = self.spec.resolution
        aspect = w / h
        n, fr = _t(near), _t(far)
        f = 1.0 / torch.tan(torch.deg2rad(_t(fovy)) / 2.0)
        proj = torch.zeros((4, 4), dtype=self.dt)
        proj[0, 0] = f / aspect
        proj[1, 1] = f
        proj[2, 2] = _t(-(fr + n) / (fr - n))
        proj[2, 3] = _t(1.0)
        proj[3, 2] = _t(2.0 * fr * n / (fr - n))
        mvp = self._mm(self._mm(trans, rot), proj)
        hw, hh = _t(w) / 2, _t(h) / 2
        hd = (_t(far) - _t(near)) / 2
        vp = torch.zeros((4, 4), dtype=self.dt)
        vp[0, 0], vp[1, 1], vp[2, 2] = hw, hh, hd
        vp[3, 0], vp[3, 1], vp[3, 2], vp[3, 3] = hw + 0, hh + 0, hd, 1.0
        col = lambda i: mvp[..., i]
        planes = torch.stack([col(3) + col(0), col(3) - col(0),
                              col(3) + col(1), col(3) - col(1),
                              col(3) + col(2), col(3) - col(2)])
        planes = planes / torch.linalg.vector_norm(planes, dim=-1,
                                                   keepdim=True)
        out = {"MVP": mvp, "viewport": vp, "frustum_planes": planes,
               "near": torch.as_tensor(near, dtype=self.dt).reshape(()),
               "far": torch.as_tensor(far, dtype=self.dt).reshape(())}
        zc = (float(2.0 * out["near"] * out["far"]),
              float(out["far"] + out["near"]),
              float(out["far"] - out["near"]))
        out = {k: v.to(self.device) for k, v in out.items()}
        out["position"] = position.to(self.device)
        out["zc"] = zc
        return out

    # --------------------------------------------------------- vertex

    def _faces(self, p, cam):
        """The vertex stage of one model: per-face screen geometry and
        validity (backface culling, degenerate, off screen)."""
        wv = p["verts"]
        clip = self._rowvec(wv, cam["MVP"])
        inv_w = 1.0 / clip[:, 3]
        ndc = clip * inv_w[:, None]
        screen = self._rowvec(ndc, cam["viewport"])
        near, far = cam["near"], cam["far"]
        zlin = (2 * near * far) / (far + near - screen[:, 2] * (far - near))
        packed = torch.cat([screen, clip, inv_w[:, None], zlin[:, None],
                            wv[:, :3]], dim=1)[p["vid"]]
        screen, clip = packed[..., 0:4], packed[..., 4:8]
        inv_w, zlin = packed[..., 8], packed[..., 9]
        sx, sy, sz = screen[..., 0], screen[..., 1], screen[..., 2]
        valid = torch.ones(p["F"], dtype=torch.bool, device=self.device)
        if self.spec.backface_culling:
            abx, aby = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
            acx, acy = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
            valid &= ~((abx * acy - aby * acx) < 0)
        v0x, v0y = sx[:, 1] - sx[:, 0], sy[:, 1] - sy[:, 0]
        v1x, v1y = sx[:, 2] - sx[:, 0], sy[:, 2] - sy[:, 0]
        d00 = v0x * v0x + v0y * v0y
        d01 = v0x * v1x + v0y * v1y
        d11 = v1x * v1x + v1y * v1y
        denom = d00 * d11 - d01 * d01
        valid &= denom != 0
        ax, ay = sx[:, 0], sy[:, 0]
        inv_denom = 1.0 / torch.where(denom == 0, torch.ones_like(denom),
                                      denom)
        av = (d11 * v0x - d01 * v1x) * inv_denom
        bv = (d11 * v0y - d01 * v1y) * inv_denom
        cv = -(ax * av + ay * bv)
        aw = (d00 * v1x - d01 * v0x) * inv_denom
        bw = (d00 * v1y - d01 * v0y) * inv_denom
        cw = -(ax * aw + ay * bw)
        z10, z20 = zlin[:, 1] - zlin[:, 0], zlin[:, 2] - zlin[:, 0]
        az = av * z10 + aw * z20
        bz = bv * z10 + bw * z20
        cz = zlin[:, 0] + cv * z10 + cw * z20
        aff = torch.stack([av, bv, cv, aw, bw, cw, az, bz, cz], dim=-1)
        h, w = self.height, self.width
        min_x = torch.clamp(sx.amin(-1), min=0)
        max_x = torch.clamp(sx.amax(-1), max=w)
        min_y = torch.clamp(sy.amin(-1), min=0)
        max_y = torch.clamp(sy.amax(-1), max=h)
        valid &= ~((min_x > max_x) | (min_y > max_y))
        bbox = torch.ceil(torch.stack([min_x, max_x, min_y, max_y], -1))
        bbox = bbox.to(torch.int32).to(torch.int64)
        x, y, z, cw_ = clip[..., 0], clip[..., 1], clip[..., 2], clip[..., 3]
        conds = torch.stack([x + cw_, cw_ - x, y + cw_, cw_ - y, z + cw_,
                             cw_ - z], dim=-1)
        e_cam = conds * inv_w[..., None]                        # (F, 3, 6)
        ppc = ~(e_cam > 0).all(dim=2).all(dim=1)                # clip on
        world = packed[..., 10:13]
        return {"aff": aff, "inv_w": inv_w, "e": e_cam.reshape(-1, 18),
                "bbox": bbox, "valid": valid, "ppc": ppc, "world": world}

    # --------------------------------------------------------- visibility

    def _coverage(self, f, idx, xs, ys):
        """Coverage and depth of faces ``idx`` at pixel coordinates ``xs``,
        ``ys`` (C, h, w) int64: the plain rasterizer's per-fragment
        arithmetic, the box test included."""
        co = lambda name, c: f[name][idx, c][:, None, None]
        cols, rows = xs.to(self.dt), ys.to(self.dt)
        v = co("aff", 0) * cols + co("aff", 1) * rows + co("aff", 2)
        w = co("aff", 3) * cols + co("aff", 4) * rows + co("aff", 5)
        u = 1.0 - v - w
        cov = (u >= 0) & (v >= 0) & (w >= 0)
        b = f["bbox"][idx][:, :, None, None]
        cov &= (xs >= b[:, 0]) & (xs < b[:, 1]) & (ys >= b[:, 2]) \
            & (ys < b[:, 3])
        cov &= f["valid"][idx][:, None, None]
        ppc = f["ppc"][idx]
        if bool(ppc.any()):
            s = u * co("inv_w", 0) + v * co("inv_w", 1) + w * co("inv_w", 2)
            ok = s != 0
            s_pos = s > 0
            for j in range(6):
                q = u * co("e", j) + v * co("e", 6 + j) + w * co("e", 12 + j)
                ok &= (q > 0) == s_pos
            cov &= ok | ~ppc[:, None, None]
        z = co("aff", 6) * cols + co("aff", 7) * rows + co("aff", 8)
        return cov, z

    def _fragments(self, f):
        """Every covered (face, pixel) fragment: (pixel index, depth, face
        id), each face walked over its bounding box."""
        dev = self.device
        W = self.width
        box = f["bbox"]
        live = f["valid"] & (box[:, 1] > box[:, 0]) & (box[:, 3] > box[:, 2])
        ids = torch.nonzero(live).flatten()
        if ids.numel() == 0:
            e = torch.zeros(0, dtype=torch.int64, device=dev)
            return e, torch.zeros(0, dtype=self.dt, device=dev), e
        bw = (box[ids, 1] - box[ids, 0]).cpu().numpy()
        bh = (box[ids, 3] - box[ids, 2]).cpu().numpy()
        pw = 1 << np.ceil(np.log2(bw)).astype(np.int64)
        ph = 1 << np.ceil(np.log2(bh)).astype(np.int64)
        pix, zs, gid = [], [], []
        for kw, kh in sorted(set(zip(pw.tolist(), ph.tolist()))):
            group = ids[torch.from_numpy(np.nonzero((pw == kw) & (ph == kh))[0]
                                         ).to(dev)]
            step = max(1, FRAG_CHUNK // (kw * kh))
            for c0 in range(0, group.numel(), step):
                idx = group[c0:c0 + step]
                xs = box[idx, 0][:, None, None] + torch.arange(
                    kw, device=dev)[None, None, :]
                ys = box[idx, 2][:, None, None] + torch.arange(
                    kh, device=dev)[None, :, None]
                xs, ys = torch.broadcast_tensors(xs, ys)
                cov, z = self._coverage(f, idx, xs, ys)
                keep = torch.nonzero(cov, as_tuple=True)
                pix.append(ys[keep] * W + xs[keep])
                zs.append(z[keep] * LH)
                gid.append(idx[keep[0]])
        return torch.cat(pix), torch.cat(zs), torch.cat(gid)

    def _visibility(self, f):
        """(sign-space z-buffer, winning face ids, covered fragments): z is
        the min over z-writing fragments, the winner the highest id whose
        fragment passes zb >= z * sign."""
        dev = self.device
        n = self.height * self.width
        pix, zs, gid = self._fragments(f)
        zb = torch.full((n,), float("inf"), dtype=self.dt, device=dev)
        upd = ~torch.isnan(zs)
        zb.scatter_reduce_(0, pix[upd], zs[upd], reduce="amin")
        claim = zb[pix] >= zs
        tid = torch.full((n,), -1, dtype=torch.int64, device=dev)
        tid.scatter_reduce_(0, pix[claim], gid[claim], reduce="amax")
        shape = (self.height, self.width)
        return zb.view(shape), tid.to(torch.int32).view(shape), pix.numel()

    # --------------------------------------------------------- G-buffer

    def _gbuffer(self, f, attrs, tid):
        """The (32, H, W) G-buffer in the system's channel layout,
        interpolated perspective-correctly from the winning face, zero
        where no face wins; the channels the general shader does not read
        (texture slots and shapes) stay zero."""
        h, w = tid.shape
        own = tid >= 0
        fid = torch.where(own, tid, torch.zeros_like(tid)).long()
        rows = torch.arange(h, dtype=self.dt, device=self.device)[:, None]
        cols = torch.arange(w, dtype=self.dt, device=self.device)[None, :]
        aff, inv_w = f["aff"][fid], f["inv_w"][fid]
        a = attrs[fid]
        at = lambda c: a[..., c]
        v = aff[..., 0] * cols + aff[..., 1] * rows + aff[..., 2]
        ww = aff[..., 3] * cols + aff[..., 4] * rows + aff[..., 5]
        u = 1.0 - v - ww
        su, sv, sw = u * inv_w[..., 0], v * inv_w[..., 1], ww * inv_w[..., 2]
        inv_s = 1.0 / (su + sv + sw)
        pb0, pb1, pb2 = su * inv_s, sv * inv_s, sw * inv_s

        def interp(c0, c1, c2):
            return pb0 * c0 + pb1 * c1 + pb2 * c2

        out = [None] * GB_CHANNELS
        wx = [at(i) for i in range(9)]
        for c in range(3):
            out[GB_WORLD + c] = interp(wx[c], wx[3 + c], wx[6 + c])
        u0, u1, u2 = at(9), at(10), at(11)
        vv0, vv1, vv2 = at(12), at(13), at(14)
        out[GB_IU] = interp(u0, u1, u2)
        out[GB_IV] = interp(vv0, vv1, vv2)
        nv = [at(15 + i) for i in range(9)]
        n = [interp(nv[c], nv[3 + c], nv[6 + c]) for c in range(3)]
        for c in range(3):
            out[GB_N + c] = n[c]
        e1 = [wx[3] - wx[0], wx[4] - wx[1], wx[5] - wx[2]]
        e2 = [wx[6] - wx[0], wx[7] - wx[1], wx[8] - wx[2]]
        c0 = [e2[1] * n[2] - e2[2] * n[1], e2[2] * n[0] - e2[0] * n[2],
              e2[0] * n[1] - e2[1] * n[0]]
        c1 = [n[1] * e1[2] - n[2] * e1[1], n[2] * e1[0] - n[0] * e1[2],
              n[0] * e1[1] - n[1] * e1[0]]
        det = e1[0] * c0[0] + e1[1] * c0[1] + e1[2] * c0[2]
        inv_det = 1.0 / det
        du0, du1 = u1 - u0, u2 - u0
        dv0, dv1 = vv1 - vv0, vv2 - vv0
        for c in range(3):
            out[GB_TAN + c] = (c0[c] * du0 + c1[c] * du1) * inv_det
            out[GB_BIT + c] = (c0[c] * dv0 + c1[c] * dv1) * inv_det
        ids = self.ids
        for c in range(3):
            out[GB_KD + c] = ids["kd"][fid][..., c]
            out[GB_KS + c] = ids["ks"][fid][..., c]
        out[GB_NS] = ids["ns"][fid]
        out[GB_TANGENT] = ids["tangent"][fid]
        out[GB_MODEL] = ids["model_id"][fid]
        zero = torch.zeros_like(out[GB_NS])
        gb = torch.stack([zero if c is None else c for c in out])
        return torch.where(own[None], gb, torch.zeros_like(gb))

    def _sample(self, tid, iu, iv):
        """Per kind, the nearest texel at the reference's UV mapping (u and v
        clipped at 1 from above, truncated, floor-mod wrapped, clamped):
        (samples (K, H, W) int32, hit (K, H, W) bool)."""
        own = tid >= 0
        fid = torch.where(own, tid, torch.zeros_like(tid)).long()
        ciu, civ = torch.clamp(iu, max=1.0), torch.clamp(iv, max=1.0)

        def wrap(x, dim):
            i = torch.trunc(x)
            wrapped = i - dim * torch.floor(i / dim)
            wrapped = torch.where(wrapped >= 0, wrapped,
                                  torch.zeros_like(wrapped))
            wrapped = torch.where(wrapped <= dim - 1.0, wrapped, dim - 1.0)
            return wrapped.to(torch.int64)

        samp, hits = [], []
        for k in range(len(KINDS)):
            ft = self.ids["ftex"][:, k][fid]                 # (H, W, 4)
            th, tw = ft[..., 1].to(self.dt), ft[..., 2].to(self.dt)
            col = wrap(ciu * (tw - 1.0), tw)
            row = wrap((1.0 - civ) * (th - 1.0), th)
            hit = own & (ft[..., 0] >= 0)
            idx = ft[..., 0] + row * ft[..., 3] + col
            hit &= (idx >= 0) & (idx < self.pool.numel())
            idx = torch.where(hit, idx, torch.zeros_like(idx))
            samp.append(torch.where(hit, self.pool[idx],
                                    torch.zeros_like(tid)))
            hits.append(hit)
        return torch.stack(samp), torch.stack(hits)

    # --------------------------------------------------------- shadows

    def _quads(self, cam, light_pos):
        """Every silhouette edge's shadow quad of the shadowing models,
        clipped by the frustum, projected and set up for the stencil test:
        (A, B, K (Q, 12) edge half-planes, zx, zy, zd (Q,) plane depth, ok,
        front (Q,) bool)."""
        dev = self.device
        quads = []
        for p in self._models:
            if not p["shadowing"] or p["num_edges"] == 0:
                continue
            verts = p["verts"]
            world = verts[p["vid"]][..., :3]
            n = _cross(world[:, 1] - world[:, 0], world[:, 2] - world[:, 0])
            facing = _dot3(n, light_pos) > 0
            inc = facing[:, None].expand(-1, 3).reshape(-1)
            edge = p["inc_edge"]
            parity = torch.zeros(p["num_edges"], dtype=torch.int32,
                                 device=dev)
            parity.index_add_(0, edge, inc.to(torch.int32))
            order = torch.where(inc, torch.arange(inc.shape[0], device=dev),
                                torch.full_like(edge, -1))
            last = torch.full((p["num_edges"],), -1, dtype=torch.int64,
                              device=dev)
            last.scatter_reduce_(0, edge, order, reduce="amax",
                                 include_self=True)
            sil = (parity & 1) == 1
            ab = p["inc_dir"][torch.clamp(last, 0, inc.shape[0] - 1)][sil]
            A, B = verts[ab[:, 0]], verts[ab[:, 1]]
            lp = torch.cat([light_pos, torch.ones(1, dtype=self.dt,
                                                  device=dev)])
            C = A + 1000.0 * normalize(A - lp)
            D = B + 1000.0 * normalize(B - lp)
            quads.append(torch.stack([A, B, D, C], dim=1))
        if not quads:
            return None
        quad = torch.cat(quads)
        padded = torch.zeros((quad.shape[0], QUAD_PMAX, 4), dtype=self.dt,
                             device=dev)
        padded[:, :4] = quad
        counts = torch.full((quad.shape[0],), 4, dtype=torch.int64,
                            device=dev)
        verts = padded
        for k in range(6):
            verts, counts = self._clip_plane(verts, counts,
                                             cam["frustum_planes"][k])
        keep = (torch.arange(QUAD_PMAX, device=dev) < counts[:, None])[..., None]
        verts = torch.where(keep, verts, torch.zeros_like(verts))
        ndc = self._rowvec(verts, cam["MVP"])
        screen = self._rowvec(ndc / ndc[..., 3:4], cam["viewport"])
        return self._quad_setup(screen, counts)

    @staticmethod
    def _clip_plane(verts, count, plane):
        """One Sutherland-Hodgman pass over padded polygons, in the
        reference clipper's append order."""
        n = verts.shape[-2]
        idx = torch.arange(n, device=verts.device)
        active = idx < count[..., None]
        wrap = (idx + 1 >= count[..., None])[..., None]
        nxt = torch.where(wrap, verts[..., 0:1, :],
                          torch.roll(verts, -1, dims=-2))
        dist_cur, dist_nxt = _dot4(verts, plane), _dot4(nxt, plane)
        cur_vis, nxt_vis = dist_cur >= 0, dist_nxt >= 0
        direction = verts - nxt
        denom = _dot4(direction, plane)
        parallel = denom.abs() < 1e-10
        weight = -dist_nxt / torch.where(parallel, torch.ones_like(denom),
                                         denom)
        ip = nxt + weight[..., None] * direction
        ip_valid = (~parallel) & (weight >= 0) & (weight <= 1)
        emit_cur = active & cur_vis
        emit_ip = active & (cur_vis ^ nxt_vis) & ip_valid
        lead = verts.shape[:-2]
        cand = torch.stack([verts, ip], dim=-2).reshape(*lead, 2 * n, 4)
        flags = torch.stack([emit_cur, emit_ip], dim=-1).reshape(*lead,
                                                                 2 * n)
        pos = torch.cumsum(flags.to(torch.int64), dim=-1) - 1
        out_count = flags.sum(-1)
        dest = torch.where(flags, pos, torch.full_like(pos, 2 * n))
        out = torch.zeros(*lead, 2 * n + 1, 4, dtype=verts.dtype,
                          device=verts.device)
        out.scatter_(-2, dest[..., None].expand(*lead, 2 * n, 4), cand)
        return out[..., :n, :], out_count

    def _quad_setup(self, screen, counts):
        sx, sy = screen[..., 0], screen[..., 1]
        a = screen[:, 0, :3]
        nrm = _cross(a - screen[:, 1, :3], a - screen[:, 2, :3])
        d_coef = -_dot3(a, nrm)
        front = nrm[:, 2] < 0
        dev = self.device
        active = torch.arange(QUAD_PMAX, device=dev)[None, :] < counts[:, None]
        inf = float("inf")
        min_x = torch.clamp(torch.where(active, sx, inf).amin(1), min=0)
        max_x = torch.clamp(torch.where(active, sx, -inf).amax(1),
                            max=self.width)
        min_y = torch.clamp(torch.where(active, sy, inf).amin(1), min=0)
        max_y = torch.clamp(torch.where(active, sy, -inf).amax(1),
                            max=self.height)
        box_valid = ~((min_x > max_x) | (min_y > max_y))
        sx = torch.nan_to_num(sx, nan=0.0, posinf=3e38, neginf=-3e38)
        sy = torch.nan_to_num(sy, nan=0.0, posinf=3e38, neginf=-3e38)
        fs = torch.where(front, 1.0, -1.0).to(self.dt)[..., None]
        slots = torch.arange(QUAD_PMAX, device=dev)
        c32 = counts.to(torch.int32)
        wrap = slots + 1 >= c32[..., None]
        px1 = torch.where(wrap, sx[..., 0:1], torch.roll(sx, -1, dims=-1))
        py1 = torch.where(wrap, sy[..., 0:1], torch.roll(sy, -1, dims=-1))
        A = (py1 - sy) * fs
        B = -(px1 - sx) * fs
        K = -(sx * A + sy * B)
        on = slots < c32[..., None]
        A = torch.where(on, A, torch.zeros_like(A))
        B = torch.where(on, B, torch.zeros_like(B))
        K = torch.where(on, K, torch.ones_like(K))
        czs = torch.where(nrm[:, 2] == 0, torch.ones_like(nrm[:, 2]),
                          nrm[:, 2])
        return {"A": A, "B": B, "K": K, "zx": -nrm[:, 0] / czs,
                "zy": -nrm[:, 1] / czs, "zd": -d_coef / czs,
                "ok": (counts >= 3) & box_valid, "front": front}

    def _stencil(self, q, zb, zc):
        """The signed stencil: +1 per front quad, -1 per back quad over the
        geometry pixels inside it whose depth passes the multiply-compare
        test; and the count of (quad, geometry pixel) fragments inside a
        quad."""
        dev = self.device
        h, w = zb.shape
        st = torch.zeros((h, w), dtype=torch.int32, device=dev)
        if q is None:
            return st, 0
        nf2, fpn, fmn = zc
        rows = torch.arange(h, dtype=self.dt, device=dev)[:, None]
        cols = torch.arange(w, dtype=self.dt, device=dev)[None, :]
        keep = torch.nonzero(q["ok"]).flatten()
        fg = zb < 3e38
        tests = 0
        for q0 in range(0, keep.numel(), QUAD_CHUNK):
            sel = keep[q0:q0 + QUAD_CHUNK]
            co = lambda name, i=None: (q[name][sel] if i is None
                                       else q[name][sel, i])[:, None, None]
            m = None
            for i in range(QUAD_PMAX):
                e = co("A", i) * cols + co("B", i) * rows + co("K", i)
                m = e if m is None else torch.minimum(m, e)
            zraw = co("zx") * cols + co("zy") * rows + co("zd")
            qden = fpn - zraw * fmn
            pass_z = ((zb * qden - LH * nf2 >= 0) == (qden > 0)) & fg
            inside = m > 0
            tests += int((inside & fg).sum())
            contrib = torch.where(co("front"), 1, -1).to(torch.int32)
            st += torch.where(inside & pass_z, contrib, 0).sum(
                0, dtype=torch.int32)
        return st, tests

    # --------------------------------------------------------- shading

    def _shade(self, gb, samp, hit, stencil, tid, cam, light):
        """Deferred Blinn-Phong over the background: each model's sampled
        diffuse and normal maps replace the material colour and the
        interpolated normal where they hit."""
        vec = lambda c: torch.movedim(gb[c:c + 3], 0, -1)
        frag_world = vec(GB_WORLD)
        model_id = gb[GB_MODEL]

        def sampled(p, k):
            tex = p[KINDS[k]]
            scale_off = torch.tensor(np.asarray(tex[3:5], np.float32),
                                     device=self.device)
            packed = samp[k]
            r = (packed & 0xFF).to(self.dt)
            g = ((packed >> 8) & 0xFF).to(self.dt)
            b = ((packed >> 16) & 0xFF).to(self.dt)
            rgb = torch.stack([r, g, b], dim=-1) / 255.0
            rgb = rgb * scale_off[0] + scale_off[1]
            return rgb, (model_id == p["index"]) & hit[k]

        color = vec(GB_KD)
        for p in self._models:
            if p["kd"] is not None:
                rgb, mask = sampled(p, 0)
                color = torch.where(mask[..., None], rgb, color)
        n_base = normalize(vec(GB_N))
        normal = n_base
        for p in self._models:
            if p["norm"] is None:
                continue
            s, mask = sampled(p, 1)
            tangent_n = (normalize(vec(GB_TAN)) * s[..., 0:1]
                         + normalize(vec(GB_BIT)) * s[..., 1:2]
                         + n_base * s[..., 2:3])
            is_tangent = gb[GB_TANGENT] > 0.5
            mapped = torch.where(is_tangent[..., None], tangent_n, s)
            normal = torch.where(mask[..., None], normalize(mapped), normal)
        specular_light = vec(GB_KS) * 255.0
        for p in self._models:
            if p["ks"] is not None:
                rgb, mask = sampled(p, 2)
                specular_light = torch.where(mask[..., None],
                                             rgb[..., 0:1] * 255.0,
                                             specular_light)
        rgb = _shade_general(color, normal, frag_world, specular_light,
                             gb[GB_NS][..., None], light, cam["position"],
                             (stencil != 0) if self.spec.shadows else None)
        bg = self.background.expand(self.height, self.width, 3)
        return torch.where((tid < 0)[..., None], bg, rgb)

    # --------------------------------------------------------- frame

    def light(self, position):
        lt = self.spec.light
        f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32),
                                        device=self.device).to(self.dt)
        color = np.asarray((1.0, 1.0, 1.0), np.float32)
        out = {"position": f32(position), "center": f32(lt["center"]),
               "color": f32(color),
               "ambient": f32(np.asarray(lt["ambient_strength"] * color,
                                         np.float32)),
               "specular_strength": f32(lt["specular_strength"]),
               "constant": f32(1), "linear": f32(lt["linear"]),
               "quadratic": f32(lt["quadratic"])}
        return out

    def render(self, camera, light, maps=None) -> Output:
        """The frame with the camera at ``camera`` and the light at
        ``light`` (float32 (3,) positions), the maps that ``maps`` ({model
        index: {"kd" or "norm": array}}) names changed."""
        dev = self.device
        self._set_maps(maps)
        cam = self.camera_matrices(camera)
        light = self.light(light)
        G = self.n_ids
        f = {"aff": torch.zeros((G, 9), dtype=self.dt, device=dev),
             "inv_w": torch.zeros((G, 3), dtype=self.dt, device=dev),
             "e": torch.zeros((G, 18), dtype=self.dt, device=dev),
             "bbox": torch.zeros((G, 4), dtype=torch.int64, device=dev),
             "valid": torch.zeros(G, dtype=torch.bool, device=dev),
             "ppc": torch.zeros(G, dtype=torch.bool, device=dev)}
        attrs = torch.zeros((G, 24), dtype=self.dt, device=dev)
        for p in self._models:
            faces = self._faces(p, cam)
            s = slice(p["offset"], p["offset"] + p["F"])
            for k in f:
                f[k][s] = faces[k]
            attrs[s] = torch.cat([faces["world"].reshape(-1, 9),
                                  p["uv"][..., 0], p["uv"][..., 1],
                                  p["vn"].reshape(-1, 9)], dim=1)
        zb, tid, fragments = self._visibility(f)
        gb = self._gbuffer(f, attrs, tid)
        samp, hit = self._sample(tid, gb[GB_IU], gb[GB_IV])
        q = (self._quads(cam, light["position"]) if self.spec.shadows
             else None)
        stencil, tests = self._stencil(q, zb, cam["zc"])
        frame = self._shade(gb, samp, hit, stencil, tid, cam, light)
        out = torch.clamp(torch.flip(frame, [0]) ** 0.8, 0.0, 1.0) * 255
        counts = {"faces": int(f["valid"].sum()), "fragments": fragments,
                  "quads": 0 if q is None else int(q["ok"].sum()),
                  "quad_tests": tests,
                  "pixels": self.height * self.width}
        numbered = self.face_numbers[torch.where(tid < 0, self.n_ids,
                                                 tid).long()]
        return Output(frame=out.to(torch.uint8), zbuf=zb * LH, tid=numbered,
                      stencil=stencil, counts=counts)



def _quantize(src):
    """(packed (TH * TW,) int32 tensor, scale, offset) of a map: 8 bits per
    channel, RGB-packed, of (texel - offset) / scale, the offset -1 and the
    scale 2 where the map holds a negative value."""
    tex = np.asarray(src, np.float32)
    scale, offset = (2.0, -1.0) if float(tex.min()) < 0 else (1.0, 0.0)
    q = np.round(np.clip((tex[..., :3] - offset) / scale, 0, 1) * 255)
    q = q.astype(np.int32)
    packed = q[..., 0] | (q[..., 1] << 8) | (q[..., 2] << 16)
    return torch.from_numpy(packed.reshape(-1)), scale, offset


def _shade_general(color, normals, frag, specular_light, ns, light,
                   camera_position, shadows_mask):
    """Blinn-Phong with the reference renderer's quirks: attenuation on
    every light, diffuse not clamped at zero, the specular factor scaled by
    255, shadowed pixels ambient only, each clipped to [0.05, 1]. A point
    light."""
    distance = torch.linalg.vector_norm(light["position"] - frag, dim=-1)
    att = (1.0 / (light["constant"] + distance *
                  (light["linear"] + light["quadratic"] * distance)))[..., None]
    ambient_rgb = torch.clamp(att * light["ambient"] * color, 0.05, 1.0)
    light_dir = normalize(light["position"] - frag)
    view_dir = normalize(camera_position - frag)
    halfway = normalize(light_dir + view_dir)
    spec_reflection = torch.clamp(
        (normals * halfway).sum(-1), min=0)[..., None] ** ns
    specular = (light["color"] * spec_reflection *
                light["specular_strength"] * specular_light)
    intensity = (normals * light_dir).sum(-1)[..., None]
    diffuse = intensity * light["color"]
    lit_rgb = torch.clamp(att * color * (light["ambient"] + diffuse + specular),
                          0.05, 1.0)
    if shadows_mask is None:
        return lit_rgb
    return torch.where(shadows_mask[..., None], ambient_rgb, lit_rgb)
