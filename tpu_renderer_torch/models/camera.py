"""Scene-graph objects: PositionedObject, Camera, Light, in PyTorch.

Counterpart of ``tpu_renderer/models/camera.py``, with the same constructor
surface as the reference (core.py:355-524) and its fixed quirks: no
``cached_property`` on lookat/MVP (core.py:415-421), no shared mutable
default Camera/Light arguments.
"""
from __future__ import annotations

import numpy as np

from tpu_renderer_torch.constants import PROJECTION_TYPE, SYSTEM
from tpu_renderer_torch.ops import transforms as T
from tpu_renderer_torch.ops.frustum import extract_frustum_planes
from tpu_renderer_torch.ops.lightning import Lightning

__all__ = ["PositionedObject", "Camera", "Light", "camera_matrices"]


def camera_matrices(position, center, up, fovy, near, far, *,
                    projection_type, system, subsystem, resolution,
                    x_offset=0, y_offset=0):
    """All view/projection matrices for a camera-like object.

    Replicates the reference mixin's composition (core.py:394-429): the
    look-at *rotate* part is built with arguments (center, position)
    (core.py:406-409, so forward = normalize(position - center)); MVP =
    translate @ rotate @ projection; aspect = width / height.

    Returns a dict of float32 CPU tensors: lookat, projection, MVP, viewport,
    frustum_planes.
    """
    height, width = resolution
    aspect = width / height
    rotate_fn = (T.look_at_rotate_lh if system == SYSTEM.LH
                 else T.look_at_rotate_rh)
    rot = rotate_fn(center, position, up)
    proj_fn = T.perspectives[subsystem][projection_type][system]
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

    def _matrices(self):
        scene = self.scene
        if scene is None:
            raise RuntimeError("object is not bound to a Scene")
        return camera_matrices(
            self.position, self.center, self.up, self.fovy, self.near, self.far,
            projection_type=self.projection_type, system=scene.system,
            subsystem=scene.subsystem, resolution=scene.resolution,
            x_offset=self.x_offset, y_offset=self.y_offset)

    @property
    def projection(self):
        return self._matrices()["projection"].numpy()

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
        return self._matrices()["lookat"].numpy()

    @property
    def MVP(self):
        return self._matrices()["MVP"].numpy()

    @property
    def frustum_planes(self):
        return self._matrices()["frustum_planes"].numpy()

    @property
    def viewport(self):
        return self._matrices()["viewport"].numpy()


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
