"""Scene-graph objects: PositionedObject, Camera, Light, in PyTorch.

Counterpart of ``tpu_renderer/models/camera.py``, with the same constructor
surface as the reference (core.py:355-524) and its fixed quirks: no
``cached_property`` on lookat/MVP (core.py:415-421), no shared mutable
default Camera/Light arguments.
"""
from __future__ import annotations

import numpy as np
import torch

from tpu_renderer_torch.constants import PROJECTION_TYPE, SYSTEM
from tpu_renderer_torch.ops import transforms as T
from tpu_renderer_torch.ops.frustum import (extract_frustum_planes,
                                            extract_frustum_planes_host)
from tpu_renderer_torch.ops.lightning import Lightning

__all__ = ["PositionedObject", "Camera", "Light", "camera_matrices"]


def camera_matrices(position, center, up, fovy, near, far, *,
                    projection_type, system, subsystem, resolution,
                    x_offset=0, y_offset=0, host=False, dtype=torch.float32):
    """All view/projection matrices for a camera-like object.

    Replicates the reference mixin's composition (core.py:394-429): the
    look-at *rotate* part is built with arguments (center, position)
    (core.py:406-409, so forward = normalize(position - center)); MVP =
    translate @ rotate @ projection; aspect = width / height.

    Returns a dict of float32 CPU tensors: lookat, projection, MVP, viewport,
    frustum_planes. ``host=True`` returns numpy arrays of ``dtype`` (float32
    or float64) instead, the JAX package's host form
    (tpu_renderer/models/camera.py:25-73): the builders run in ``dtype``,
    and lookat = translate @ rotate, MVP = lookat @ projection and the
    planes are computed with numpy. In float64 they equal that package's
    host matrices under ``jax.enable_x64`` bit for bit. The debug overlay
    draws with them: when the debug camera equals the main one, the
    frustum-cube corners lie exactly on the clip planes, where another
    summation order (a torch float64 matmul's, say) can flip a sign.
    """
    height, width = resolution
    aspect = width / height
    rotate_fn = (T.look_at_rotate_lh if system == SYSTEM.LH
                 else T.look_at_rotate_rh)
    proj_fn = T.perspectives[subsystem][projection_type][system]
    if host:
        rot = rotate_fn(center, position, up, dtype=dtype).numpy()
        projection = proj_fn(fovy, aspect, near, far, dtype=dtype).numpy()
        lookat = T.looka_at_translate(position, dtype=dtype).numpy() @ rot
        mvp = lookat @ projection
        return {
            "lookat": lookat,
            "projection": projection,
            "MVP": mvp,
            "viewport": T.ViewPort(resolution, far, near, x_offset=x_offset,
                                   y_offset=y_offset, dtype=dtype).numpy(),
            "frustum_planes": extract_frustum_planes_host(mvp),
        }
    rot = rotate_fn(center, position, up)
    projection = proj_fn(fovy, aspect, near, far)
    lookat = T.matmul(T.looka_at_translate(position), rot)
    mvp = T.matmul(lookat, projection)
    return {
        "lookat": lookat,
        "projection": projection,
        "MVP": mvp,
        "viewport": T.ViewPort(resolution, far, near, x_offset=x_offset,
                               y_offset=y_offset),
        "frustum_planes": extract_frustum_planes(mvp),
    }


class PositionedObject:
    """Anything with a position and a look-at center (reference core.py:355-370)."""

    def __init__(self, position, center=(0, 0, 0)):
        self.scene = None
        self.position = np.asarray(position, dtype=np.float32)
        self.center = np.asarray(center, dtype=np.float32)

    @property
    def direction(self):
        return T.normalize(self.position - self.center).reshape(-1).numpy()

    def direction_to(self, other):
        return T.normalize(self.direction - np.asarray(other)).numpy()

    def set_position(self, new_position):
        self.position = np.asarray(new_position, dtype=np.float32)
        return self


class _TransformMixin:
    """View/projection properties shared by Camera and Light
    (reference TransformationMatrixMixin, core.py:373-429)."""

    def _init_transform(self, x_offset=0, y_offset=0,
                        projection_type=PROJECTION_TYPE.PERSPECTIVE,
                        up=(0, 1, 0), near=0.001, far=6, fovy=90):
        self.up = np.asarray(up, dtype=np.float32)
        self.projection_type = projection_type
        # ORTHOGRAPHIC forces near = |position| (reference core.py:387),
        # normed in float64 like the reference's position.
        self.near = (float(np.linalg.norm(
                         np.asarray(self.position, np.float64)))
                     if projection_type == PROJECTION_TYPE.ORTHOGRAPHIC
                     else near)
        self.far = far
        self.fovy = fovy
        self.x_offset = x_offset
        self.y_offset = y_offset

    def _matrices(self, dtype=torch.float32):
        """The host form of :func:`camera_matrices` (numpy, ``dtype``) for
        the bound scene's resolution and systems: the properties below, the
        gizmos and the debug overlay (float64) read it; the render path
        composes its own (ops/pipeline.py ``frame_inputs``).

        The float64 form, which the overlay asks for every frame, is kept
        with the state it was built from and built again only when that
        state changes (a debug camera usually stands still); its arrays
        are read-only."""
        scene = self.scene
        if scene is None:
            raise RuntimeError("object is not bound to a Scene")
        state = (dtype, np.asarray(self.position).tolist(),
                 np.asarray(self.center).tolist(),
                 np.asarray(self.up).tolist(), self.fovy, self.near, self.far,
                 self.projection_type, self.x_offset, self.y_offset,
                 scene.system, scene.subsystem, tuple(scene.resolution))
        kept = getattr(self, "_host64", None)
        if kept is not None and kept[0] == state:
            return kept[1]
        m = camera_matrices(
            self.position, self.center, self.up, self.fovy, self.near, self.far,
            projection_type=self.projection_type, system=scene.system,
            subsystem=scene.subsystem, resolution=scene.resolution,
            x_offset=self.x_offset, y_offset=self.y_offset, host=True,
            dtype=dtype)
        if dtype == torch.float64:
            for v in m.values():
                v.flags.writeable = False
            self._host64 = (state, m)
        return m

    @property
    def projection(self):
        return self._matrices()["projection"]

    @property
    def rotate(self):
        fn = (T.look_at_rotate_lh if self.scene.system == SYSTEM.LH
              else T.look_at_rotate_rh)
        return fn(self.center, self.position, self.up).numpy()

    @property
    def translate(self):
        return T.looka_at_translate(self.position).numpy()

    @property
    def lookat(self):
        return self._matrices()["lookat"]

    @property
    def MVP(self):
        return self._matrices()["MVP"]

    @property
    def frustum_planes(self):
        return self._matrices()["frustum_planes"]

    @property
    def viewport(self):
        return self._matrices()["viewport"]


class Camera(PositionedObject, _TransformMixin):
    """Reference-compatible camera (core.py:432-441)."""

    def __init__(self, position, center=(0, 0, 0), show=False,
                 backface_culling=True, **kwargs):
        super().__init__(position, center)
        self._init_transform(**kwargs)
        self.show = show
        self.backface_culling = backface_culling


class Light(PositionedObject, _TransformMixin):
    """Point / directional / spot light (reference core.py:444-524)."""

    def __init__(self, position, light_type=Lightning.POINT_LIGHTNING,
                 center=(0, 0, 0), color=(1.0, 1.0, 1.0), ambient_strength=0,
                 diffuse=1, specular_strength=0.5, show=False,
                 constant=1, linear=0.14, quadratic=0.07, **kwargs):
        super().__init__(position, center)
        self.color = np.asarray(color, dtype=np.float32)
        self.light_type = light_type
        self.ambient = np.asarray(ambient_strength * self.color, np.float32)
        self.show = show
        self.diffuse = diffuse
        self.specular_strength = specular_strength
        self.constant = constant
        self.linear = linear
        self.quadratic = quadratic
        self._init_transform(**kwargs)

    @staticmethod
    def reflect(I, N):  # noqa: E741 — reference naming (core.py:493-495)
        """Unit reflection of the rows of ``I`` about the normals ``N``."""
        I, N = T._t(I), T._t(N)
        return T.normalize(I - 2.0 * (N * I).sum(1)[..., None] * N)

    @staticmethod
    def smoothstep(edge0, edge1, x_array):
        """Hermite smoothstep (reference core.py:497-515), for spot cones."""
        x = torch.clamp((T._t(x_array) - edge0) / (edge1 - edge0), 0.0, 1.0)
        return x * x * (3 - 2 * x)

    def attenuation(self, fragment_position):
        """1 / (c + d*(l + q*d)) point-light falloff (reference
        core.py:517-524); fragment_position: (N, 3). Returns (N, 1)."""
        distance = torch.linalg.vector_norm(
            T._t(self.position) - T._t(fragment_position), dim=1)
        denom = self.constant + distance * (self.linear
                                            + self.quadratic * distance)
        return (1.0 / denom)[..., None]
