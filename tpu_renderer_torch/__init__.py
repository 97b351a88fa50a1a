"""tpu_renderer_torch: the PyTorch + CUDA port of ``tpu_renderer``.

The JAX package ``tpu_renderer`` is the reference this port is held to.
This package imports torch and numpy, never JAX and never ``tpu_renderer``.
It renders textured, normal-mapped, shadowed scenes with the general
Blinn-Phong shader, the flat, gouraud, PBR, wireframe and points shaders,
over a color or a cubemap skybox (``CubeMap``), with an optional debug
camera (its clip space and its frustum overlay), camera/light gizmos,
supersampling (``Scene(supersample=N)``) and per-model statistics
(``Scene.stats()``). On a CUDA device (the default) it runs seven
hand-written CUDA kernels (``ops/raster_cuda.py``, sources in ``csrc/``,
built at first use); with ``device="cpu"`` it runs their plain PyTorch
versions. ``Scene.render()`` runs each frame as a compiled program, the
counterpart of the JAX package's jitted frame: on the card a CUDA graph
captured once per static key and replayed with each frame's camera,
light, vertices and textures (``render_frame_jit``, ``render_ssaa_jit``,
``render_core_jit``, ``render_debug_frame_jit``, ``face_statistics_jit``;
``clear_compiled()`` frees the programs). ``render_frame_sharded`` splits one frame over a ``(rows,
tris)`` mesh of torch.distributed ranks (``make_render_mesh``). The host
side matches the JAX package's too: ``Face``, the native OBJ loader
(``Model.load_model(use_native=...)``), the reference-style module aliases
and ``utils`` (frame IO, an OBJ writer, profiling).

    import tpu_renderer_torch as tr
    from tpu_renderer_torch.models.gizmos import make_floor

    floor = make_floor(2.0, y=-1.0)
    floor.materials["default"].map_Kd = texture      # (H, W, 3) float32
    scene = tr.Scene(tr.Camera((0.5, 3, 5), center=(0, 0, 0), near=1e-4,
                               far=400),
                     tr.Light((5, 5, 0)), shadows=True,
                     resolution=(1024, 1024), system=tr.SYSTEM.LH,
                     subsystem=tr.SUBSYSTEM.OPENGL)        # on the card
    scene.add_model(floor)
    frame = scene.render()          # (H, W, 3) uint8
    scene.supersample = 2           # 2048x2048 inside, box-filtered down
    frame = scene.render()
    stats = scene.stats()           # per-model face counters

Precision: geometry runs in float32 with TF32 off everywhere — the GPU form
of the JAX package's ``precision="highest"`` rule (ops/transforms.py:55-62
there). Importing the package sets the three switches below.
"""
import torch as _torch

_torch.backends.cuda.matmul.allow_tf32 = False
_torch.backends.cudnn.allow_tf32 = False
_torch.set_float32_matmul_precision("highest")

import sys as _sys  # noqa: E402

from tpu_renderer_torch import constants  # noqa: E402,F401
from tpu_renderer_torch.constants import (PROJECTION_TYPE, SUBSYSTEM,  # noqa: E402
                                          SYSTEM)
from tpu_renderer_torch.models.camera import Camera, Light  # noqa: E402
from tpu_renderer_torch.models.face import Face  # noqa: E402
from tpu_renderer_torch.models.model import Model  # noqa: E402
from tpu_renderer_torch.models.scene import Scene  # noqa: E402
from tpu_renderer_torch.ops.errors import Errors  # noqa: E402
from tpu_renderer_torch.ops.lightning import Lightning  # noqa: E402
from tpu_renderer_torch.ops.cubemap import CubeMap  # noqa: E402
from tpu_renderer_torch.ops.compiled import clear_compiled  # noqa: E402
from tpu_renderer_torch.ops.pipeline import (SHADER_FLAT,  # noqa: E402
                                             SHADER_GENERAL, SHADER_GOURAUD,
                                             SHADER_PBR, SHADER_POINTS,
                                             SHADER_WIREFRAME,
                                             face_statistics_jit,
                                             render_core_jit,
                                             render_debug_frame_jit,
                                             render_frame_jit,
                                             render_ssaa_jit)
from tpu_renderer_torch.ops.transforms import (rotate, rotate_xyz,  # noqa: E402
                                               scale, translation)
from tpu_renderer_torch.parallel.mesh import make_render_mesh  # noqa: E402
from tpu_renderer_torch.parallel.sharded import (  # noqa: E402
    render_frame_sharded)

# Reference-style module aliases: the reference is imported as
# ``from transformation import scale`` / ``from obj.lightning import
# Lightning`` (main.py:6-10); the same paths exist under this package.
from tpu_renderer_torch.ops import lightning  # noqa: E402,F401
from tpu_renderer_torch.ops import frustum as plane_intersection  # noqa: E402
from tpu_renderer_torch.ops import transforms as transformation  # noqa: E402

_sys.modules[__name__ + ".transformation"] = transformation
_sys.modules[__name__ + ".plane_intersection"] = plane_intersection

__all__ = [
    "Model", "Camera", "Light", "Scene", "CubeMap", "Lightning", "Face",
    "Errors", "scale", "translation", "rotate", "rotate_xyz",
    "SYSTEM", "SUBSYSTEM", "PROJECTION_TYPE", "SHADER_GENERAL", "SHADER_FLAT",
    "SHADER_GOURAUD", "SHADER_PBR", "SHADER_WIREFRAME", "SHADER_POINTS",
    "transformation", "plane_intersection", "constants", "lightning",
    "make_render_mesh", "render_frame_sharded", "render_frame_jit",
    "render_ssaa_jit", "render_core_jit", "render_debug_frame_jit",
    "face_statistics_jit", "clear_compiled",
]

__version__ = "0.1.0"
