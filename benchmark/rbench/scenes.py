"""The configurations' scenes, made from a seed, as plain numpy arrays.

A configuration file (``configs/<name>.json``) names its builder under
``"builder"``: ``builders/<builder>.py``, found by name, whose
``build(cfg, seed)`` returns a :class:`SceneSpec`: the raw seeded arrays
(vertices, faces, uv, normals, textures), the camera, the light and the
static settings. :func:`build` adds the settings the configuration states
for both sides (``SETTINGS``). Both sides take the same spec:
:func:`port_scene` makes the system's ``Scene`` of it as the settings say,
and the reference the configuration names renders it with plain PyTorch.

The helpers here (``sphere``, ``floor``, ``scale``, ``rotate_xyz``,
``translation``, ``mat``) are frozen copies of the port's procedural
meshes (``models/gizmos.py``) and model transforms (``ops/transforms.py``),
so that a change to those files leaves the benchmark's inputs as they are.
``benchmark/tests`` holds the builders to bench_torch.py's originals.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional, Tuple

import numpy as np
import torch

from rbench.registry import plugin

__all__ = ["MeshSpec", "SceneSpec", "Port", "build", "port_scene",
           "SETTINGS"]

#: Settings a configuration file states for the frame, with the value
#: taken where it states none: the system's enum names (``tr.SYSTEM``,
#: ``tr.SUBSYSTEM``, ``tr.PROJECTION_TYPE``, ``tr.Lightning`` without its
#: ``_LIGHTNING``), its shader, its supersampling factor, how the models
#: are submitted (``"models"``: each its own ``tr.Model``, instances as
#: ``base @ transform``; ``"merged"``: the instances of one mesh merged by
#: ``tr.Model.concat``), and the reference that judges the frame
#: (``references/<name>.py``).
SETTINGS = {"system": "LH", "subsystem": "OPENGL", "projection":
            "perspective", "light_type": "point", "shader": "general",
            "supersample": 1, "submission": "models", "reference": "general"}


@dataclasses.dataclass
class MeshSpec:
    """One model of a scene. Instances of one mesh share every array but
    ``transform``: their vertices are ``vertices @ transform`` (float64
    product, cast to float32), as ``Model.__matmul__`` makes them."""
    vertices: np.ndarray                  # (V, 4) float32
    uv: np.ndarray                        # (T, 3) float32
    normals: np.ndarray                   # (N, 3) float32
    faces: np.ndarray                     # (F, 3, 4) int32 [v, uv, n, mtl]
    shadowing: bool
    map_kd: Optional[np.ndarray] = None   # (TH, TW, 3) float32 in [0, 1]
    norm: Optional[np.ndarray] = None     # (TH, TW, 3) float32 in [-1, 1]
    norm_tangent: bool = False
    transform: Optional[np.ndarray] = None  # (4, 4) float64

    def world_vertices(self) -> np.ndarray:
        if self.transform is None:
            return self.vertices
        return np.asarray(self.vertices @ np.asarray(self.transform,
                                                     np.float64),
                          dtype=np.float32)

    @property
    def num_faces(self) -> int:
        return len(self.faces)


@dataclasses.dataclass
class SceneSpec:
    """A frame's static settings and its start camera and light."""
    resolution: Tuple[int, int]           # (height, width)
    shadows: bool
    backface_culling: bool
    camera: dict                          # position, center, fovy, near, far
    light: dict                           # position, center, ambient_strength,
                                          # specular_strength, linear, quadratic
    models: List[MeshSpec]
    settings: dict = dataclasses.field(default_factory=lambda: dict(
        SETTINGS))

    @property
    def num_faces(self) -> int:
        return sum(m.num_faces for m in self.models)


# ---------------------------------------------------------- frozen helpers

def _t32(x):
    if isinstance(x, torch.Tensor):
        return x.to(torch.float32)
    return torch.tensor(np.asarray(x), dtype=torch.float32)


def scale(factor):
    m = torch.eye(4, dtype=torch.float32)
    f = _t32(factor)
    m[0, 0] = f
    m[1, 1] = f
    m[2, 2] = f
    return m


def translation(vec):
    m = torch.eye(4, dtype=torch.float32)
    m[3, :3] = _t32(vec)
    return m


def _stack_rows(rows):
    return torch.stack([torch.stack([_t32(x) for x in r]) for r in rows])


def rotate_xyz(a):
    """Euler rotation from degrees, with the reference's angle wiring (the
    matrix labelled x uses the y angle and the other way round)."""
    a = torch.deg2rad(_t32(a))
    x, y, z = a[0], a[1], a[2]
    one = torch.ones((), dtype=torch.float32)
    zero = torch.zeros((), dtype=torch.float32)
    rot_x = _stack_rows([[one, zero, zero, zero],
                         [zero, torch.cos(y), -torch.sin(y), zero],
                         [zero, torch.sin(y), torch.cos(y), zero],
                         [zero, zero, zero, one]]).T
    rot_y = _stack_rows([[torch.cos(x), zero, torch.sin(x), zero],
                         [zero, one, zero, zero],
                         [-torch.sin(x), zero, torch.cos(x), zero],
                         [zero, zero, zero, one]]).T
    rot_z = _stack_rows([[torch.cos(z), torch.sin(z), zero, zero],
                         [-torch.sin(z), torch.cos(z), zero, zero],
                         [zero, zero, one, zero],
                         [zero, zero, zero, one]]).T
    return torch.matmul(torch.matmul(rot_z, rot_y), rot_x)


def mat(*transforms):
    out = np.eye(4)
    for t in transforms:
        out = out @ np.asarray(t, np.float64)
    return out


def sphere(subdiv_lat, subdiv_lon, radius=1.0):
    """(vertices, uv, normals, faces) of a UV sphere."""
    lats = np.linspace(0, np.pi, subdiv_lat + 1)
    lons = np.linspace(0, 2 * np.pi, subdiv_lon, endpoint=False)
    verts, norms, uvs = [], [], []
    for i, th in enumerate(lats):
        for j, ph in enumerate(lons):
            n = np.array([np.sin(th) * np.cos(ph), np.cos(th),
                          np.sin(th) * np.sin(ph)])
            verts.append([*(radius * n), 1.0])
            norms.append(n)
            uvs.append([j / subdiv_lon, 1 - i / subdiv_lat, 0])

    def vid(i, j):
        return i * subdiv_lon + (j % subdiv_lon)

    faces = []
    for i in range(subdiv_lat):
        for j in range(subdiv_lon):
            a, b = vid(i, j), vid(i, j + 1)
            c, d = vid(i + 1, j + 1), vid(i + 1, j)
            if i > 0:
                faces.append([[a, a, a, 0], [b, b, b, 0], [c, c, c, 0]])
            if i < subdiv_lat - 1:
                faces.append([[a, a, a, 0], [c, c, c, 0], [d, d, d, 0]])
    return (np.array(verts, np.float32), np.array(uvs, np.float32),
            np.array(norms, np.float32), np.array(faces, np.int32))


def floor(size, y):
    """(vertices, uv, normals, faces) of a two-triangle quad in the XZ
    plane, normals up."""
    s = float(size)
    vertices = np.array([[-s, y, -s, 1.0], [s, y, -s, 1.0], [s, y, s, 1.0],
                         [-s, y, s, 1.0]], dtype=np.float32)
    uv = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]],
                  dtype=np.float32)
    normals = np.array([[0, 1, 0]] * 4, dtype=np.float32)
    faces = np.array([[[0, 0, 0, 0], [2, 2, 2, 0], [1, 1, 1, 0]],
                      [[0, 0, 0, 0], [3, 3, 3, 0], [2, 2, 2, 0]]],
                     dtype=np.int32)
    return vertices, uv, normals, faces


def build(cfg: dict, seed: int) -> SceneSpec:
    """The scene of configuration ``cfg`` (a configs/<name>.json object)
    from ``seed``: its builder's arrays with its settings."""
    spec = plugin("builders", cfg["builder"]).build(cfg, seed)
    spec.settings = {k: cfg.get(k, v) for k, v in SETTINGS.items()}
    if spec.settings["submission"] not in ("models", "merged"):
        raise ValueError(f"submission {spec.settings['submission']!r}: "
                         "'models' or 'merged'")
    return spec


class Port:
    """The system's Scene of a spec (``scene``), and for each of its models
    the spec's models it holds, in order (``owners``)."""

    def __init__(self, scene, owners, spec):
        self.scene = scene
        self.owners = owners
        self.spec = spec

    def face_table(self):
        """(ids,) int64 CPU tensor: the spec's face number (the models'
        faces counted in spec order) of each face id of the system's
        ``last_tid``, -2 for an id that numbers no face. The system numbers
        model j's faces from the sum of the earlier models' padded counts
        (``ModelConfig.num_faces``), as its ``face_statistics`` reads
        them."""
        cfg, _ = self.scene._prepare()
        firsts = np.cumsum([0] + [m.num_faces for m in self.spec.models])
        parts = []
        for owned, mc in zip(self.owners, cfg.models):
            n = sum(self.spec.models[k].num_faces for k in owned)
            part = torch.full((mc.num_faces,), -2, dtype=torch.int64)
            part[:n] = torch.arange(n) + int(firsts[owned[0]])
            parts.append(part)
        return torch.cat(parts)

    def _model(self, k):
        return next(self.scene.models[j] for j, owned in
                    enumerate(self.owners) if k in owned)

    def set_map(self, k, kind, array):
        """Give spec model ``k``'s ``kind`` map ("kd" or "norm") the values
        ``array``, as a user changes a texture: on the material, then a
        version bump of every model that shares it."""
        mats = self._model(k).materials
        m = self.spec.models[k]
        if kind == "kd":
            mats["default"].map_Kd = array
        else:
            mats["default"].norm = np.asarray(array, dtype=np.dtype(
                np.float32, metadata={"tangent": m.norm_tangent}))
        for model in self.scene.models:
            if model.materials is mats:
                model.bump_version()


def port_scene(tr, spec: SceneSpec, device) -> Port:
    """The system's Scene of ``spec`` on ``device``, made as its users make
    one: ``tr.Model`` of the arrays with the maps on the default material,
    instances as ``base @ transform`` (they share their packing and texture
    stacks), each submitted alone or merged as ``spec.settings`` say, with
    its system, shader, light and supersampling. ``tr`` is the
    ``tpu_renderer_torch`` package."""
    cam, lt, st = spec.camera, spec.light, spec.settings
    camera = tr.Camera(cam["position"], center=cam["center"],
                       fovy=cam["fovy"], near=cam["near"], far=cam["far"],
                       backface_culling=spec.backface_culling,
                       projection_type=getattr(tr.PROJECTION_TYPE,
                                               st["projection"].upper()))
    light = tr.Light(lt["position"],
                     light_type=tr.Lightning[st["light_type"].upper()
                                            + "_LIGHTNING"],
                     center=lt["center"],
                     ambient_strength=lt["ambient_strength"],
                     specular_strength=lt["specular_strength"],
                     linear=lt["linear"], quadratic=lt["quadratic"])
    scene = tr.Scene(camera, light, shadows=spec.shadows,
                     resolution=spec.resolution,
                     system=getattr(tr.SYSTEM, st["system"]),
                     subsystem=getattr(tr.SUBSYSTEM, st["subsystem"]),
                     shader=st["shader"], supersample=st["supersample"],
                     device=device)
    bases = {}
    groups = []                       # [(base, [(k, model)])], spec order
    for k, m in enumerate(spec.models):
        base = bases.get(id(m.vertices))
        if base is None:
            base = tr.Model(m.vertices, m.uv, m.normals, m.faces,
                            shadowing=m.shadowing)
            mat = base.materials["default"]
            if m.map_kd is not None:
                mat.map_Kd = m.map_kd
            if m.norm is not None:
                mat.norm = np.asarray(m.norm, dtype=np.dtype(
                    np.float32, metadata={"tangent": m.norm_tangent}))
                base.normal_map_is_tangent = m.norm_tangent
            bases[id(m.vertices)] = base
        model = base if m.transform is None else base @ m.transform
        if (st["submission"] == "merged" and groups
                and groups[-1][0] is base):
            groups[-1][1].append((k, model))
        else:
            groups.append((base, [(k, model)]))
    owners = []
    for _, members in groups:
        models = [model for _, model in members]
        scene.add_model(models[0] if len(models) == 1
                        else tr.Model.concat(models))
        owners.append([k for k, _ in members])
    return Port(scene, owners, spec)
