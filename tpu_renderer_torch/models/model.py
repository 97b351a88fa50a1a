"""Wavefront OBJ models: loading, textures, transforms, and edge adjacency.

Host-side numpy asset pipeline (no torch needed here) with the reference's
public surface
(``Model.load_model`` core.py:257-318, ``Model.parse_mtl`` core.py:320-348,
``TextureMaps`` core.py:77-105, ``model @ scale(...) @ translation(...)``
core.py:350-352) producing struct-of-arrays ready to land on device.

Deviations from the reference (deliberate, SURVEY.md §2 quirks):
- ``__matmul__`` is **pure**: returns a new Model, does not mutate in place.
- No mutable ``silhouette`` set. Silhouette extraction is a batched tensor
  computation over the precomputed :class:`EdgeTable` (built once per mesh),
  replacing the per-face Python XOR loop (reference triangular.py:294-302).
- The ``tangent`` flag for normal maps is an explicit attribute
  (``Model.normal_map_is_tangent``) in addition to the reference's dtype
  metadata trick (core.py:94, read back at core.py:180).
"""
from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Dict, List, Optional

import numpy as np

from tpu_renderer_torch.models.material import Material

__all__ = ["Model", "TextureMaps", "EdgeTable", "triangulate_int", "load_texture"]


def triangulate_int(polygon):
    """Fan-triangulate a polygon's index rows (reference core.py:72-74)."""
    for i in range(len(polygon) - 2):
        yield np.array([polygon[0], *polygon[1 + i: 3 + i]], dtype=np.int32)


def load_texture(name):
    """Image file -> (H, W, 3) float32 RGB in [0, 1] (reference core.py:100-105).

    Pillow is imported here, only when a file is actually loaded: in-memory
    textures set on a :class:`Material` as numpy arrays need no image library.
    """
    from PIL import Image

    texture = Image.open(name).convert("RGB")
    return np.asarray(texture, dtype=np.float32) / 255.0


class TextureMaps:
    """Friendly-name texture registration (reference core.py:77-98).

    ``register('diffuse'|'ambient'|'specular'|'shininess'|'transparency'|'normals',
    path, normalize=, tangent=)`` loads the image and attaches it to the model's
    'default' material under the corresponding MTL key. ``normalize=True`` maps
    [0,1] -> [-1,1] (for normal maps); ``tangent=True`` marks a tangent-space
    normal map.
    """

    texture_map = {
        "diffuse": "map_Kd",
        "ambient": "map_Ka",
        "specular": "map_Ks",
        "shininess": "map_Ns",
        "transparency": "map_d",
        "normals": "norm",
    }

    def __init__(self, model: "Model"):
        self.model = model

    def register(self, attr_name: str, path, normalize=True, tangent=False):
        if attr_name not in self.texture_map:
            raise ValueError(
                f"{attr_name} not recognized.\nSupported: {self.texture_map.keys()}")
        texture = load_texture(path)
        if normalize:
            texture = texture * 2 - 1
        # Keep the reference's dtype-metadata channel (core.py:94) alongside the
        # explicit flag, for API compatibility.
        dt = np.dtype(np.float32, metadata={"tangent": tangent})
        setattr(self.model.materials["default"], self.texture_map[attr_name],
                np.asarray(texture, dtype=dt))
        if self.texture_map[attr_name] == "norm":
            self.model.normal_map_is_tangent = tangent
        # Invalidate cached device packets (models/scene.py _pack_model).
        self.model.bump_version()

    load_texture = staticmethod(load_texture)


@dataclass(frozen=True)
class EdgeTable:
    """Unique-edge / face-incidence table for batched silhouette extraction.

    The reference finds silhouette edges by XOR-ing the 3 edges of every
    light-facing face into a Python set (triangular.py:286-302): an edge
    survives iff an odd number of adjacent light-facing faces touch it, and the
    surviving ``Edge`` tuple keeps the vertex order of the *last* face that
    added it.

    Device equivalent: for each of the mesh's ``3F`` face-edge incidences we
    store the unique-edge id and the directed vertex pair; per frame a
    ``segment_sum`` of the light-facing mask over edge ids gives the parity
    (odd = silhouette) and a ``segment_max`` over incidence indices picks the
    last light-facing face's direction — O(1) per edge on device instead of
    Python set churn.
    """

    num_edges: int
    #: (3F,) int32 unique-edge id of each face-edge incidence, face-major order.
    incidence_edge: np.ndarray
    #: (3F, 2) int32 directed vertex ids (v[i], v[(i+1)%3]) per incidence.
    incidence_dir: np.ndarray

    @staticmethod
    def build(face_vertex_ids: np.ndarray) -> "EdgeTable":
        """face_vertex_ids: (F, 3) int32 vertex indices per triangle."""
        fv = np.asarray(face_vertex_ids, dtype=np.int64)
        a = fv                                  # (F, 3) edge starts
        b = np.roll(fv, -1, axis=1)             # (F, 3) edge ends
        lo = np.minimum(a, b).ravel()
        hi = np.maximum(a, b).ravel()
        keys = lo << 32 | hi                    # canonical undirected key
        _, edge_ids = np.unique(keys, return_inverse=True)
        directed = np.stack([a.ravel(), b.ravel()], axis=1).astype(np.int32)
        return EdgeTable(
            num_edges=int(edge_ids.max()) + 1 if edge_ids.size else 0,
            incidence_edge=edge_ids.astype(np.int32),
            incidence_dir=directed,
        )


class Model:
    """A loaded mesh: vertices (N, 4) f32, uv (T, 3), normals (M, 3), faces
    (F, 3, 4) int32 [vertex, uv, normal, material] per corner — the same array
    layout as the reference (core.py:231-318).

    ``model @ matrix`` returns a **new** Model with transformed vertices
    (chainable: ``model @ scale(s) @ translation(t) @ rotate_xyz(r)``).
    """

    def __init__(self, vertices, uv, normals, faces, shadowing: bool = False,
                 materials: Optional[Dict[str, Material]] = None,
                 material_group: Optional[List[str]] = None,
                 clip: bool = True, depth_test: bool = True):
        self.vertices = np.asarray(vertices, dtype=np.float32)
        self.uv = None if uv is None else np.asarray(uv, dtype=np.float32)
        self.normals = None if normals is None else np.asarray(normals, dtype=np.float32)
        self._faces = np.asarray(faces)
        self.shadowing = shadowing
        self.clip = clip
        self.depth_test = depth_test
        self.materials = materials or {"default": Material()}
        self.material_group = material_group or ["default"]
        self.textures = TextureMaps(self)
        self.normal_map_is_tangent = False
        self._edge_table: Optional[EdgeTable] = None
        #: Incremented on asset mutations (texture registration) so scenes
        #: can invalidate their cached device packets. Direct attribute
        #: mutation (e.g. ``model.normals = ...``) should call
        #: :meth:`bump_version` — or simply re-add the model.
        self._version = 0

    # ------------------------------------------------------------------ IO

    @classmethod
    def load_model(cls, name, shadowing: bool = True,
                   use_native: Optional[bool] = None) -> "Model":
        """Parse a Wavefront OBJ file (https://paulbourke.net/dataformats/obj/).

        Same grammar subset and index conventions as the reference
        (core.py:257-318): ``v`` padded to w=1, ``vt`` padded to 3 components,
        polygons fan-triangulated, the active material's group index appended
        as a 4th column per corner, 1-based indices shifted to 0-based with
        negative (relative) indices passed through.

        ``use_native``: True parses with the C++ loader (models/native.py)
        and raises RuntimeError when it does not build, False with the
        Python parser, None (default) with the C++ loader where it builds
        and the Python parser elsewhere; both give identical arrays.
        """
        if use_native is not False:
            from tpu_renderer_torch.models import native

            parsed = native.load_obj_native(name)
            if parsed is not None:
                vertices, uv, normals, faces, mtllib, groups = parsed
                materials = {"default": Material()}
                if mtllib:
                    mtl_path = os.path.join(os.path.dirname(name), mtllib)
                    if os.path.exists(mtl_path):
                        materials |= cls.parse_mtl(mtl_path)
                return cls(vertices, uv, normals, faces, shadowing,
                           materials=materials, material_group=groups)
            if use_native:
                raise RuntimeError("native OBJ loader unavailable: "
                                   f"{native.build_error()}")

        vertices, faces, normals, uv = [], [], [], []
        mtl = "default"
        mtl_group = ["default"]
        materials: Dict[str, Material] = {"default": Material()}
        with open(name) as file:
            for line in file:
                tokens = line.split()
                if not tokens:
                    continue
                tag = tokens[0]
                if tag == "mtllib":
                    mtl_path = os.path.join(os.path.dirname(name), tokens[1])
                    if os.path.exists(mtl_path):
                        materials |= cls.parse_mtl(mtl_path)
                elif tag == "usemtl":
                    mtl = tokens[1]
                    if mtl not in mtl_group:
                        mtl_group.append(mtl)
                elif tag == "v":
                    v = tokens[1:]
                    if len(v) == 3:
                        v.append(1)
                    vertices.append(v)
                elif tag == "f":
                    corners = []
                    for corner in tokens[1:]:
                        idx = [(-1 if part == "" else int(part))
                               for part in corner.split("/")]
                        idx += [-1] * (3 - len(idx))        # pad missing vt/vn
                        idx.append(mtl_group.index(mtl) + 1)
                        corners.append(idx)
                    faces.extend(triangulate_int(corners))
                elif tag == "vn":
                    normals.append(tokens[1:])
                elif tag == "vt":
                    t = tokens[1:]
                    if len(t) == 2:
                        t.append(0)
                    uv.append(t)

        vertices = np.array(vertices, dtype=np.float32)
        faces = np.array(faces, dtype=np.int32)
        faces = np.where(faces > 0, faces - 1, faces)
        normals = np.array(normals, dtype=np.float32) if normals else None
        uv = np.array(uv, dtype=np.float32) if uv else None
        return cls(vertices, uv, normals, faces, shadowing,
                   materials=materials, material_group=mtl_group)

    @staticmethod
    def parse_mtl(mtllib) -> Dict[str, Material]:
        """Parse an MTL library (reference core.py:320-348).

        ``map_*``/``disp`` entries load textures from disk relative to the MTL
        file; ``map_bump`` becomes ``norm`` with tangent-space metadata; missing
        texture files produce a warning, matching core.py:344.
        """
        mtl_lib: Dict[str, Material] = {}
        material = None
        with open(mtllib) as lib:
            for line in lib:
                if line.startswith("#") or not line.strip():
                    continue
                key, *val = line.split()
                if key == "newmtl":
                    material = Material()
                    mtl_lib[val[0]] = material
                    continue
                if material is None:
                    continue
                if key.startswith("map") or key == "disp":
                    path = os.path.join(os.path.dirname(mtllib), val[0])
                    if os.path.exists(path):
                        tangent = key == "map_bump"
                        if tangent:
                            key = "norm"
                        dt = np.dtype(np.float32, metadata={"tangent": tangent})
                        setattr(material, key,
                                np.asarray(load_texture(path), dtype=dt))
                    else:
                        print(f"{key} {path} is not found. Recommend manually "
                              f"assign texture by descriptor Model.texture.register")
                else:
                    setattr(material, key, val)
        return mtl_lib

    # ---------------------------------------------------------- transforms

    def bump_version(self):
        """Mark this model's packed device data stale (see Scene._pack_model)."""
        self._version += 1

    @classmethod
    def concat(cls, models: List["Model"]) -> "Model":
        """Merge instanced copies of ONE mesh into a single Model.

        One merged model runs one vertex stage and one silhouette
        reduction for every instance instead of one per model. Vertex ids
        are offset per instance; uv / normal / material indices stay valid
        because those arrays are SHARED by reference (``model @ transform``
        shallow-copies them, so instances alias one copy).

        All inputs must be transformed copies of the same base mesh (same
        faces / uv / normals / materials objects) — e.g.
        ``Model.concat([base @ t for t in transforms])``. The reference has
        no instancing; each of its models re-runs the full Python pipeline
        (core.py:592-614).
        """
        if not models:
            raise ValueError("Model.concat needs at least one model")
        m0 = models[0]
        for m in models[1:]:
            if (m._faces is not m0._faces or m.uv is not m0.uv
                    or m.normals is not m0.normals
                    or m.materials is not m0.materials):
                raise ValueError(
                    "Model.concat merges instanced copies of one mesh; "
                    "these models do not share faces/uv/normals/materials "
                    "(create instances with `base @ transform`)")
        verts = np.concatenate([m.vertices for m in models], axis=0)
        base = np.asarray(m0._faces)
        # Resolve OBJ relative (negative) vertex indices against the BASE
        # length first — after offsetting they would wrap into the wrong
        # instance's vertex range.
        vid = base[:, :, 0]
        base = base.copy()
        base[:, :, 0] = np.where(vid < 0, vid + len(m0.vertices), vid)
        faces = np.concatenate(
            [base + np.array([off, 0, 0, 0], base.dtype)
             for off in range(0, len(models) * len(m0.vertices),
                              len(m0.vertices))], axis=0)
        out = cls(verts, m0.uv, m0.normals, faces, m0.shadowing,
                  materials=m0.materials, material_group=m0.material_group,
                  clip=m0.clip, depth_test=m0.depth_test)
        out.normal_map_is_tangent = m0.normal_map_is_tangent
        return out

    def __matmul__(self, other) -> "Model":
        """Apply a 4x4 row-vector transform; returns a NEW Model (pure).

        The reference mutates in place (core.py:350-352); purity here keeps
        models reusable across scenes and plays well with traced pipelines.
        """
        out = self._shallow_copy()
        out.vertices = np.asarray(self.vertices @ np.asarray(other, np.float64),
                                  dtype=np.float32)
        return out

    def _shallow_copy(self) -> "Model":
        out = Model.__new__(Model)
        out.__dict__.update(self.__dict__)
        out.textures = TextureMaps(out)
        return out

    # ------------------------------------------------------------ geometry

    @property
    def faces(self):
        """Generator of per-triangle :class:`Face` views (reference
        core.py:253-255). The render path uses :attr:`face_array`."""
        from tpu_renderer_torch.models.face import Face

        return (Face(self, *face.T) for face in self._faces)

    @property
    def face_array(self) -> np.ndarray:
        """(F, 3, 4) int32 corner index array [vertex, uv, normal, material]."""
        return self._faces

    @property
    def num_faces(self) -> int:
        return len(self._faces)

    @property
    def edge_table(self) -> EdgeTable:
        """Unique-edge incidence table (built once, cached)."""
        if self._edge_table is None:
            self._edge_table = EdgeTable.build(self._faces[:, :, 0])
        return self._edge_table

    def face_material(self) -> np.ndarray:
        """(F,) int32 material-group index per face."""
        return self._faces[:, 0, 3].astype(np.int32)

    def default_material(self) -> Material:
        return self.materials["default"]

    def material_for_group(self, group_index: int) -> Material:
        """Material bound to a material-group index (reference core.py:125)."""
        name = self.material_group[group_index]
        return self.materials.get(name, self.materials["default"])

    def silhouette(self, light_position) -> set:
        """Silhouette edge set w.r.t. a light position — the reference's
        ``model.silhouette`` after its pass-1 XOR loop (triangular.py:294-302),
        computed from the EdgeTable parity in one vectorized pass (and without
        the reference's never-cleared-set bug, SURVEY.md §2 quirk 3).

        Returns a set of :class:`Edge` vertex-id pairs oriented like the last
        light-facing adjacent face."""
        fv = self._faces[:, :, 0]
        v = self.vertices[:, :3]
        n = np.cross(v[fv[:, 1]] - v[fv[:, 0]], v[fv[:, 2]] - v[fv[:, 0]])
        facing = n @ np.asarray(light_position, np.float32)[:3] > 0

        et = self.edge_table
        inc_lf = np.repeat(facing, 3)
        parity = np.zeros(et.num_edges, np.int64)
        np.add.at(parity, et.incidence_edge, inc_lf.astype(np.int64))
        last = np.full(et.num_edges, -1, np.int64)
        order = np.where(inc_lf, np.arange(len(inc_lf)), -1)
        np.maximum.at(last, et.incidence_edge, order)
        silhouette_mask = (parity % 2 == 1) & (last >= 0)
        return {Edge(tuple(et.incidence_dir[last[e]]))
                for e in np.nonzero(silhouette_mask)[0]}


class Edge(tuple):
    """Order-insensitive vertex-id pair (reference triangular.py:286-291)."""

    def __eq__(self, other):
        return ((other[0] == self[0] and other[1] == self[1]) or
                (other[0] == self[1] and other[1] == self[0]))

    def __ne__(self, other):
        return not self.__eq__(other)

    def __hash__(self):
        return hash(frozenset(self))
