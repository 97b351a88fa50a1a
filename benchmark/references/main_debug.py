"""The reference ``main_debug``: the reference renderer's own demo frame
(obj/main.py): the general (Blinn-Phong) shader under a directional
light, LH/OpenGL perspective, no supersampling, and a debug camera whose
clip space clips every fragment and whose frustum is drawn over the
frame.

``render(camera, light, maps=None, debug=None)`` takes the debug camera
(a configuration's ``camera["debug"]``: ``position``, ``center``,
``fovy``, ``near``, ``far``) from the view; without one it renders the
frame with no debug clip and no overlay. Every stage of
``rbench.reference.Reference`` runs as it is but these, each noted where
it is overridden:

- **Directional light** (``light``, ``_shade``): the light direction is
  ``normalize(position - center)`` at every pixel; the attenuation still
  uses the light's position.
- **Shadow quads** (``_quads``): a silhouette edge's far points are the
  edge's points plus ``(-1000 * direction, 1)``, the reference renderer's
  directional branch, which leaves them with w = 2.
- **Debug clip** (``_faces``, ``_coverage``): each face also carries its
  vertices in the debug camera's clip space, each plane scaled by the
  vertex's 1/w of the main camera. A face wholly inside both frusta skips
  the per-pixel test; any other takes it, and a fragment counts only where
  the perspective-correct interpolation of every plane of both spaces has
  the sign of the interpolated 1/w. It applies where fragments are made:
  the z-buffer and the winners; the stencil then reads that z-buffer.
- **Frustum overlay** (``render``): the debug camera's NDC cube is carried
  to the world by the inverse of its float64 MVP, each face clipped
  against the main camera's float64 frustum planes (Sutherland-Hodgman),
  projected, and its edges walked by the reference renderer's DDA; back
  faces are dashed (odd runs of 13 pixels) while the main camera stands
  outside the debug frustum. A pixel whose linearized depth passes the
  z-buffer's test is written red, its four neighbours half blended, on
  the float64 pre-flip frame and z-buffer; the flip, gamma 0.8 and uint8
  follow in float64 numpy. ``zbuf`` is the z-buffer as the overlay leaves
  it (float64), and ``counts["overlay_pixels"]`` the line pixels written.
  The float64 host matrices are built with numpy's arithmetic
  (:func:`host_matrices`).

Plain PyTorch and numpy, float32 with TF32 off as the configuration
states (the base's ``tf32`` and ``dtype`` give the control and the
float64 witness; the overlay is float64 in every case); it imports
nothing of the system under test and nothing of JAX.
"""
import dataclasses

import numpy as np
import torch

from rbench.reference import (GB_BIT, GB_KD, GB_KS, GB_MODEL, GB_N, GB_NS,
                              GB_TAN, GB_TANGENT, GB_WORLD, KINDS, LH,
                              QUAD_PMAX, Reference as General, _cross, _dot3,
                              normalize)

__all__ = ["Reference", "host_matrices", "draw_frustum", "clip_polygon",
           "dda"]

#: The NDC cube's corners and its six faces (the reference renderer's
#: frustums.py:7-43).
CUBE = np.array([[-1.0, -1.0, 1.0, 1.0], [1.0, -1.0, 1.0, 1.0],
                 [-1.0, 1.0, 1.0, 1.0], [1.0, 1.0, 1.0, 1.0],
                 [-1.0, 1.0, -1.0, 1.0], [1.0, 1.0, -1.0, 1.0],
                 [-1.0, -1.0, -1.0, 1.0], [1.0, -1.0, -1.0, 1.0]])
CUBE_FACES = np.array([(2, 4, 5, 3), (0, 1, 7, 6), (0, 2, 3, 1),
                       (5, 4, 6, 7), (3, 5, 7, 1), (4, 2, 0, 6)])
#: The overlay's colour and its dash length.
RED = np.array((1.0, 0.0, 0.0))
DASH = 13


def host_matrices(cam, position, resolution):
    """{MVP, viewport, planes} (float64 numpy) of a camera (``cam``: a
    configuration's camera object; ``position``: where it stands, rounded
    to float32 as the system keeps it), LH/OpenGL perspective: the look-at
    from (center, position) as the reference renderer builds it, MVP =
    translate @ rotate @ projection, the six planes from MVP's columns,
    each of unit norm. ``fovy``, ``near`` and ``far`` are taken as given,
    not rounded to float32."""
    h, w = resolution
    eye = np.asarray(np.asarray(position, np.float32), np.float64)
    center = np.asarray(np.asarray(cam["center"], np.float32), np.float64)
    unit = lambda v: v / (np.linalg.norm(v) or 1.0)
    forward = unit(eye - center)
    right = unit(np.cross([0.0, 1.0, 0.0], forward))
    rotate = np.eye(4)
    rotate[:3, :3] = np.stack([right, np.cross(forward, right), -forward],
                              axis=1)
    translate = np.eye(4)
    translate[3, :3] = -eye
    near, far = float(cam["near"]), float(cam["far"])
    f = 1.0 / np.tan(np.deg2rad(float(cam["fovy"])) / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = f / (w / h), f
    proj[2, 2] = -(far + near) / (far - near)
    proj[2, 3] = 1.0
    proj[3, 2] = 2.0 * far * near / (far - near)
    mvp = translate @ rotate @ proj
    vp = np.zeros((4, 4))
    vp[0, 0], vp[1, 1], vp[2, 2] = w / 2, h / 2, (far - near) / 2
    vp[3] = (w / 2, h / 2, (far - near) / 2, 1.0)
    planes = np.stack([mvp[:, 3] + mvp[:, 0], mvp[:, 3] - mvp[:, 0],
                       mvp[:, 3] + mvp[:, 1], mvp[:, 3] - mvp[:, 1],
                       mvp[:, 3] + mvp[:, 2], mvp[:, 3] - mvp[:, 2]])
    planes /= np.linalg.norm(planes, axis=-1, keepdims=True)
    return {"MVP": mvp, "viewport": vp, "planes": planes}


def clip_polygon(points, planes):
    """Sutherland-Hodgman in float64: the (N, 4) polygon ``points`` kept
    where ``plane @ p >= 0`` for every plane, a crossing edge adding the
    point from the next vertex towards the current one, none where the
    edge lies parallel to the plane (|denominator| < 1e-10) or the weight
    falls outside [0, 1]. Returns (M, 4)."""
    poly = list(points)
    for plane in planes:
        out = []
        for i, cur in enumerate(poly):
            nxt = poly[(i + 1) % len(poly)]
            cur_in, nxt_in = plane @ cur >= 0, plane @ nxt >= 0
            if cur_in:
                out.append(cur)
            if cur_in != nxt_in:
                d = cur - nxt
                denom = plane @ d
                if abs(denom) >= 1e-10:
                    t = -(plane @ nxt) / denom
                    if 0 <= t <= 1:
                        out.append(nxt + t * d)
        poly = out
    return np.array(poly)


def dda(a, b):
    """The reference renderer's line walk (line.py:6-16): uniform steps
    along the larger of the x and y spans, from the endpoint with the
    larger x; the last point is left out, and a line of no span is its
    first point."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    if b[0] - a[0] > 0:
        a, b = b, a
    delta = b - a
    steps = np.max(np.abs(delta[:2]))
    if steps == 0:
        return a[None]
    return a + np.arange(int(steps))[:, None] * (delta / steps)


def draw_frustum(frame, zbuf, main, debug, eye, near, far):
    """The debug camera's frustum on the float64 pre-flip ``frame`` (H, W,
    3) and ``zbuf`` (H, W), in place (see the module's docstring).
    ``main``/``debug``: :func:`host_matrices`; ``eye``, ``near``, ``far``:
    the main camera's. Returns the line pixels written."""
    h, w = zbuf.shape
    world = CUBE @ np.linalg.inv(debug["MVP"])
    world = world / world[:, 3:4]
    e = np.append(np.asarray(eye, np.float64), 1.0) @ debug["MVP"]
    outside = not all(-e[3] < e[k] < e[3] for k in range(3))
    written = 0
    for face in world[CUBE_FACES]:
        face = clip_polygon(face, main["planes"])
        if len(face) < 3:
            continue
        face = face @ main["MVP"]
        face = face / face[:, 3:4]
        face = face @ main["viewport"]
        back = np.cross(face[1, :3] - face[0, :3],
                        face[2, :3] - face[0, :3])[2] > 0
        face[:, 2] = 2 * near * far / (far + near - face[:, 2] * (far - near))
        for i in range(len(face)):
            pts = dda(face[i], face[(i + 1) % len(face)])
            if back and outside:
                pts = pts[(np.arange(len(pts)) // DASH) % 2 == 1]
            if not len(pts):
                continue
            rows = pts[:, 1].astype(np.int32) - 1
            cols = pts[:, 0].astype(np.int32) - 1
            z = pts[:, 2]
            keep = (zbuf[rows, cols] - z) * LH >= 0
            rows, cols, z = rows[keep], cols[keep], z[keep]
            written += len(rows)
            zbuf[rows, cols] = z
            frame[rows, cols] = RED
            for off in (-1, 1):
                r = np.clip(rows + off, 0, h - 1)
                c = np.clip(cols + off, 0, w - 1)
                zbuf[r, cols] = z
                zbuf[rows, c] = z
                frame[r, cols] = frame[r, cols] * 0.5 + RED / 2
                frame[rows, c] = frame[rows, c] * 0.5 + RED / 2
    return written


def _shade_directional(color, normals, frag, specular_light, ns, light,
                       camera_position, shadows_mask):
    """``rbench.reference._shade_general`` with the directional light's
    one difference: the light direction is the light's ``direction`` at
    every pixel, not the direction from the fragment to its position."""
    distance = torch.linalg.vector_norm(light["position"] - frag, dim=-1)
    att = (1.0 / (light["constant"] + distance *
                  (light["linear"] + light["quadratic"] * distance)))[..., None]
    ambient_rgb = torch.clamp(att * light["ambient"] * color, 0.05, 1.0)
    light_dir = light["direction"].expand(frag.shape)
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


class Reference(General):
    """``rbench.reference.Reference`` under a directional light, with the
    view's debug camera clipping the fragments and its frustum drawn."""

    SUPPORTS = {**General.SUPPORTS, "light_type": "directional"}

    # ------------------------------------------------- light and shadows

    def light(self, position):
        out = super().light(position)
        out["direction"] = normalize(out["position"]
                                     - out["center"]).reshape(-1)
        return out

    def _quads(self, cam, light_pos):
        """The base's shadow quads but for the extrusion: directional (see
        the module's docstring)."""
        dev = self.device
        center = torch.as_tensor(np.asarray(
            self.spec.light["center"], np.float32), device=dev).to(self.dt)
        direction = normalize(light_pos - center).reshape(-1)
        one = torch.ones(1, dtype=self.dt, device=dev)
        ext = torch.cat([direction * -1000.0, one])
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
            quads.append(torch.stack([A, B, B + ext, A + ext], dim=1))
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

    # ------------------------------------------------- debug clip

    def _debug_mvp(self, debug):
        """The debug camera's float32 MVP, as the base composes the main
        camera's."""
        main = self.spec
        self.spec = dataclasses.replace(main, camera=debug)
        try:
            return self.camera_matrices(debug["position"])["MVP"]
        finally:
            self.spec = main

    def _faces(self, p, cam):
        f = super()._faces(p, cam)
        if self._debug is None:
            return f
        clip = self._rowvec(p["verts"], self._debug["MVP"])[p["vid"]]
        x, y, z, w = clip.unbind(-1)
        conds = torch.stack([x + w, w - x, y + w, w - y, z + w, w - z], -1)
        e = conds * f["inv_w"][..., None]                       # (F, 3, 6)
        f["ppc"] = f["ppc"] | ~(e > 0).all(dim=2).all(dim=1)
        self._debug["e"][p["offset"]:p["offset"] + p["F"]] = e.reshape(-1, 18)
        return f

    def _coverage(self, f, idx, xs, ys):
        cov, z = super()._coverage(f, idx, xs, ys)
        ppc = f["ppc"][idx]
        if self._debug is None or not bool(ppc.any()):
            return cov, z
        co = lambda name, c: f[name][idx, c][:, None, None]
        e = lambda c: self._debug["e"][idx, c][:, None, None]
        cols, rows = xs.to(self.dt), ys.to(self.dt)
        v = co("aff", 0) * cols + co("aff", 1) * rows + co("aff", 2)
        w = co("aff", 3) * cols + co("aff", 4) * rows + co("aff", 5)
        u = 1.0 - v - w
        s = u * co("inv_w", 0) + v * co("inv_w", 1) + w * co("inv_w", 2)
        ok = s != 0
        s_pos = s > 0
        for j in range(6):
            q = u * e(j) + v * e(6 + j) + w * e(12 + j)
            ok &= (q > 0) == s_pos
        return cov & (ok | ~ppc[:, None, None]), z

    def _visibility(self, f):
        zb, tid, fragments = super()._visibility(f)
        self._zb = zb
        return zb, tid, fragments

    # ------------------------------------------------- shading, frame

    def _shade(self, gb, samp, hit, stencil, tid, cam, light):
        """The base's shading but for the light (``_shade_directional``);
        the float frame is kept for the overlay."""
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
        rgb = _shade_directional(color, normal, frag_world, specular_light,
                                 gb[GB_NS][..., None], light, cam["position"],
                                 (stencil != 0) if self.spec.shadows else None)
        bg = self.background.expand(self.height, self.width, 3)
        self._frame = torch.where((tid < 0)[..., None], bg, rgb)
        return self._frame

    def render(self, camera, light, maps=None, debug=None):
        """The base's frame, clipped by the ``debug`` camera (a
        configuration's ``camera["debug"]``) and its frustum drawn over
        it; without one, neither."""
        self._debug = None
        if debug is not None:
            self._debug = {"MVP": self._debug_mvp(debug), "e": torch.zeros(
                (self.n_ids, 18), dtype=self.dt, device=self.device)}
        out = super().render(camera, light, maps)
        out.counts["overlay_pixels"] = 0
        if debug is None:
            return out
        res = (self.height, self.width)
        frame = self._frame.to(torch.float64).cpu().numpy()
        zbuf = (self._zb * LH).to(torch.float64).cpu().numpy()
        cam = self.spec.camera
        out.counts["overlay_pixels"] = draw_frustum(
            frame, zbuf, host_matrices(cam, camera, res),
            host_matrices(debug, debug["position"], res), np.asarray(
                camera, np.float32), float(cam["near"]), float(cam["far"]))
        out.frame = torch.from_numpy(
            (np.clip(frame[::-1] ** 0.8, 0, 1) * 255).astype(np.uint8))
        out.zbuf = torch.from_numpy(zbuf)
        return out
