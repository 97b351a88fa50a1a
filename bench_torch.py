"""bench.py's scenes, built for the PyTorch/CUDA port: the scene builders
that chip_smoke.py, kernel_times.py and the tests render.

The port's measurements are the benchmark's (``benchmark/run.py``, its
own frozen copy of these builders in ``benchmark/builders``); this module
times nothing.

bench.py opens assets that are not in the repository, so every scene uses
procedural stand-ins made from a seed (``SEED``): the diablo3_pose mesh
(5,022 faces) is ``make_sphere(40, 64)`` (4,992 faces) displaced by seeded
noise (``stand_in_mesh``); its diffuse and tangent normal maps, the floor's
maps and the handgrip texture are seeded noise quantized like 8-bit images;
the skybox is ``procedural_cubemap``; configuration 6's ten boxes are
built in memory as ``utils.objwrite.write_textured_box`` writes them (that
path needs an image file and Pillow).

The builders take ``pkg``, the package to build in (the port by default;
the tests pass the JAX package to build the same scene from the same numpy
arrays), and sizes that the tests shrink. Transforms are the port's
matrices as float64 numpy arrays in both packages, so instance vertices
are the same bits.
"""
from __future__ import annotations

import importlib

import numpy as np

RES = (1024, 1024)
SEED = 0
TEX = 1024
SKY = 512
#: Latitude and longitude bands of the stand-in mesh: 4,992 faces.
MESH = (40, 64)


def _port():
    import tpu_renderer_torch

    return tpu_renderer_torch


def _gizmos(pkg):
    return importlib.import_module(pkg.__name__ + ".models.gizmos")


def _mat(*transforms):
    """The product of the port's 4x4 row-vector transforms, as the float64
    numpy array both packages' ``Model @`` takes."""
    out = np.eye(4)
    for t in transforms:
        out = out @ np.asarray(t, np.float64)
    return out


def _smooth_noise(rng, shape, octaves=4):
    """Seeded smooth 2D noise in [0, 1]: a sum of random low-frequency
    sinusoids (no image files, no network)."""
    h, w = shape
    y, x = np.meshgrid(np.linspace(0, 1, h, dtype=np.float32),
                       np.linspace(0, 1, w, dtype=np.float32), indexing="ij")
    out = np.zeros(shape, np.float32)
    for o in range(octaves):
        f = 2.0 ** (o + 1)
        for _ in range(3):
            fx, fy = rng.integers(1, 4, 2) * f
            ph = rng.uniform(0, 2 * np.pi)
            out += np.sin(2 * np.pi * (fx * x + fy * y) + ph) / (o + 1)
    out -= out.min()
    return out / out.max()


def _vertex_normals(verts, faces):
    """Area-weighted vertex normals of a triangle mesh."""
    v = verts[:, :3].astype(np.float64)
    fv = faces[:, :, 0]
    n = np.cross(v[fv[:, 1]] - v[fv[:, 0]], v[fv[:, 2]] - v[fv[:, 0]])
    acc = np.zeros_like(v)
    for k in range(3):
        np.add.at(acc, fv[:, k], n)
    acc /= np.maximum(np.linalg.norm(acc, axis=1, keepdims=True), 1e-12)
    return acc.astype(np.float32)


def _tangent_normal_map(rng, tex):
    """A seeded (tex, tex, 3) tangent-space normal map, quantized like an
    8-bit image, then normalized *2-1 as
    ``TextureMaps.register('normals', tangent=True)`` does."""
    height = _smooth_noise(rng, (tex, tex)) * 8.0
    gy, gx = np.gradient(height)
    nm = np.stack([-gx, -gy, np.ones_like(gx)], axis=-1)
    nm /= np.linalg.norm(nm, axis=-1, keepdims=True)
    nm8 = np.round((nm * 0.5 + 0.5) * 255) / 255.0
    return np.asarray(nm8 * 2 - 1, dtype=np.dtype(
        np.float32, metadata={"tangent": True}))


def _floor_map(rng, tex):
    """The floor's seeded diffuse map: a checker under noise."""
    checker = ((np.indices((tex, tex)) // 64).sum(0) % 2).astype(np.float32)
    return np.stack(
        [0.35 + 0.4 * checker, 0.35 + 0.3 * _smooth_noise(rng, (tex, tex)),
         0.3 + 0.2 * checker], axis=-1).astype(np.float32)


def stand_in_mesh(pkg, rng, tex=TEX, diffuse=True, normals=True,
                  mesh=MESH):
    """The diablo3_pose stand-in: ``make_sphere(*mesh)`` displaced by seeded
    noise, with area-weighted vertex normals, shadowing (as
    ``Model.load_model`` makes a model); with a seeded (tex, tex) diffuse
    map and a tangent normal map where asked."""
    base = _gizmos(pkg).make_sphere(*mesh)
    n = base.vertices[:, :3]
    th = np.arccos(np.clip(n[:, 1], -1, 1))
    ph = np.arctan2(n[:, 2], n[:, 0])
    bump = np.zeros(len(n), np.float32)
    for _ in range(6):
        a, b = rng.integers(1, 5, 2)
        bump += rng.uniform(0.02, 0.06) * np.sin(a * th + rng.uniform(0, 6)) \
            * np.cos(b * ph + rng.uniform(0, 6))
    verts = base.vertices.copy()
    verts[:, :3] = n * (1.0 + bump)[:, None]
    faces = base.face_array
    model = pkg.Model(verts, base.uv, _vertex_normals(verts, faces), faces,
                      shadowing=True)
    mat = model.materials["default"]
    if diffuse:
        mat.map_Kd = np.stack([_smooth_noise(rng, (tex, tex))
                               for _ in range(3)], axis=-1)
    if normals:
        mat.norm = _tangent_normal_map(rng, tex)
        model.normal_map_is_tangent = True
    return model


def flagship_light(show=False, pkg=None):
    """bench.py's light; ``show=True`` adds its sphere gizmo to a scene."""
    tr = pkg or _port()
    return tr.Light((5, 5, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                    center=(0, 0.5, 0.5), ambient_strength=0.1,
                    specular_strength=0.1, linear=1e-9, quadratic=1e-10,
                    show=show)


def _scene(pkg, device, *args, **kw):
    """``pkg.Scene`` on ``device`` (the JAX package's Scene takes none)."""
    if device is not None:
        kw["device"] = device
    return pkg.Scene(*args, system=pkg.SYSTEM.LH,
                     subsystem=pkg.SUBSYSTEM.OPENGL, **kw)


def build_scene(device="cuda", resolution=RES, tex=TEX, seed=SEED,
                pkg=None):
    """The bench.py:25-49 frame: the stand-in mesh with its diffuse and
    tangent normal maps over a textured floor, bench.py's camera and point
    light, shadows, LH/OpenGL."""
    tr = pkg or _port()
    rng = np.random.default_rng(seed)
    mesh = stand_in_mesh(tr, rng, tex)
    floor = _gizmos(tr).make_floor(2.0, y=-1.0)
    floor.materials["default"].map_Kd = _floor_map(rng, tex)
    camera = tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=90, near=0.0001,
                       far=400, backface_culling=False)
    scene = _scene(tr, device, camera, flagship_light(pkg=tr), shadows=True,
                   resolution=resolution)
    scene.add_model(mesh)
    scene.add_model(floor)
    return scene


def cubemap_faces(size=SKY, seed=SEED):
    """Six seeded, 8-bit-quantized (size, size, 3) skybox faces by side, no
    image files."""
    rng = np.random.default_rng(seed + 1)
    faces = {}
    for side in ("left", "right", "top", "bottom", "front", "back"):
        rgb = np.stack([_smooth_noise(rng, (size, size), octaves=3)
                        for _ in range(3)], axis=-1)
        faces[side] = (np.round(rgb * 255) / 255).astype(np.float32)
    return faces


def procedural_cubemap(size=SKY, seed=SEED):
    """The port's CubeMap of :func:`cubemap_faces`."""
    return _port().CubeMap(**cubemap_faces(size, seed))


def orbit_position(t, radius=5.05, height=3.0):
    """bench.orbit_position's camera path."""
    return np.array([radius * np.sin(t) + 0.5, height, radius * np.cos(t)],
                    dtype=np.float32)


def build_highpoly_scene(n_instances=20, resolution=RES, shadows=True,
                         textured=True, merged=True, cull=True,
                         cam_height=4.5, device="cuda", tex=TEX, seed=SEED,
                         mesh=MESH, pkg=None):
    """bench.py:52-115: a grid of ``n_instances`` instances of the textured
    stand-in mesh (20 x 4,992 faces) with bench.py's scales and rotations,
    over a textured floor; ``merged`` adds them as one ``Model.concat``,
    else as separate models, which share their packing and texture stacks
    (``Scene._pack_model``)."""
    tr = pkg or _port()
    rng = np.random.default_rng(seed)
    base = stand_in_mesh(tr, rng, tex, diffuse=textured, normals=textured,
                         mesh=mesh)
    base.edge_table                 # built once, shared by the instances
    light = tr.Light((5, 8, 0), light_type=tr.Lightning.POINT_LIGHTNING,
                     center=(0, 0.5, 0.5), ambient_strength=0.1,
                     specular_strength=0.1, linear=1e-9, quadratic=1e-10)
    camera = tr.Camera((0.5, cam_height, 8.5), center=(0, 0, 0), fovy=90,
                       near=0.0001, far=400, backface_culling=cull)
    scene = _scene(tr, device, camera, light, shadows=shadows,
                   resolution=resolution)
    T = _port()
    side = int(np.ceil(np.sqrt(n_instances)))
    spacing = 2.2
    insts = []
    for i in range(n_instances):
        r, c = divmod(i, side)
        x = (c - (side - 1) / 2) * spacing
        z = (r - (side - 1) / 2) * spacing
        insts.append(base @ _mat(T.scale(0.9 + 0.2 * ((i * 7) % 5) / 4),
                                 T.rotate([0, (i * 37) % 360, 0]),
                                 T.translation([x, 0, z])))
    for m in ([tr.Model.concat(insts)] if merged else insts):
        scene.add_model(m)
    floor = _gizmos(tr).make_floor(1.2 * side * spacing, y=-1.0)
    floor.materials["default"].map_Kd = _floor_map(rng, tex)
    scene.add_model(floor)
    return scene


def _box(pkg, texture, size, center):
    """The model ``Model.load_model`` makes of
    ``write_textured_box(path, texture, size, center)``'s OBJ and MTL (six
    quads fan-triangulated, material "mat0": Ns 32, Ka 1, Kd 1, Ks 0.5,
    ``texture`` as map_Kd), built in memory."""
    s = size / 2.0
    corners = np.array([[x, y, z, 1.0] for x in (-s, s) for y in (-s, s)
                        for z in (-s, s)]) + [*center, 0.0]
    uv = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    normals = np.array([[-1, 0, 0], [1, 0, 0], [0, -1, 0], [0, 1, 0],
                        [0, 0, -1], [0, 0, 1]], np.float32)
    quads = [([0, 1, 3, 2], 0), ([4, 6, 7, 5], 1), ([0, 4, 5, 1], 2),
             ([2, 3, 7, 6], 3), ([0, 2, 6, 4], 4), ([1, 5, 7, 3], 5)]
    faces = [[(vids[0], 0, ni, 1), (vids[k], k, ni, 1),
              (vids[k + 1], k + 1, ni, 1)]
             for vids, ni in quads for k in (1, 2)]
    material = importlib.import_module(pkg.__name__
                                       + ".models.material").Material
    mat = material()
    mat.Ns, mat.Ka, mat.Kd, mat.Ks = 32.0, [1, 1, 1], [1, 1, 1], [.5, .5, .5]
    mat.map_Kd = texture
    materials = {"default": material(), "mat0": mat}
    return pkg.Model(corners.astype(np.float32), uv, normals,
                     np.array(faces, np.int32), True, materials=materials,
                     material_group=["default", "mat0"])


#: bench_all's configurations (bench.py:319-460) in the order it runs them.
CONFIGS = ("cfg1", "cfg2-persp", "cfg2-ortho", "cfg3", "cfg3-rh-shadows",
           "cfg4", "cfg5-merged", "cfg5-instances", "cfg6")


def build_config(name, device="cuda", resolution=None, tex=TEX, mesh=MESH,
                 seed=SEED, pkg=None, skymap=None):
    """One of ``CONFIGS`` as bench.py:330-460 builds it, with the stand-ins:

    - cfg1: the untextured mesh, gouraud, no shadows, 512²;
    - cfg2-persp, cfg2-ortho: the mesh with its diffuse map, backface
      culling, fovy 45, perspective or orthographic, 512²;
    - cfg3: a floor with a diffuse and a tangent normal map and a textured
      cube, spot light, 512²; cfg3-rh-shadows: the same under SYSTEM.RH
      and SUBSYSTEM.DIRECTX with shadows (the cube casts them);
    - cfg4: the skybox over the mesh and a cube placed by chained
      transforms, 512²;
    - cfg5-merged, cfg5-instances: ``build_highpoly_scene(20)`` (99,842
      faces, 1024², shadows, culling), one merged model or 20 models;
    - cfg6: ten distinct boxes with seeded 48² textures, shadows, 512².

    ``resolution`` replaces the configuration's own; ``skymap`` is cfg4's
    skybox (``procedural_cubemap()`` by default)."""
    tr = pkg or _port()
    gz = _gizmos(tr)
    T = _port()
    rng = np.random.default_rng(seed)
    res = lambda own: tuple(resolution or own)
    if name.startswith("cfg5"):
        return build_highpoly_scene(20, res((1024, 1024)),
                                    merged=name == "cfg5-merged",
                                    device=device, tex=tex, seed=seed,
                                    mesh=mesh, pkg=tr)
    if name == "cfg1":
        scene = _scene(tr, device,
                       tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=90,
                                 near=1e-4, far=400),
                       tr.Light((5, 5, 0)), resolution=res((512, 512)),
                       shader="gouraud")
        scene.add_model(stand_in_mesh(tr, rng, tex, diffuse=False,
                                      normals=False, mesh=mesh))
        return scene
    if name.startswith("cfg2"):
        proj = (tr.PROJECTION_TYPE.ORTHOGRAPHIC if name == "cfg2-ortho"
                else tr.PROJECTION_TYPE.PERSPECTIVE)
        scene = _scene(tr, device,
                       tr.Camera((0.5, 3, 5), center=(0, 0, 0), fovy=45,
                                 near=1e-4, far=400, backface_culling=True,
                                 projection_type=proj),
                       tr.Light((5, 5, 0), ambient_strength=0.1),
                       resolution=res((512, 512)))
        scene.add_model(stand_in_mesh(tr, rng, tex, normals=False,
                                      mesh=mesh))
        return scene
    if name.startswith("cfg3"):
        floor = gz.make_floor(2.0, y=-1.0)
        floor.materials["default"].map_Kd = _floor_map(rng, tex)
        floor.materials["default"].norm = _tangent_normal_map(rng, tex)
        floor.normal_map_is_tangent = True
        grip = gz.make_cube(1.0)
        grip.shadowing = True
        grip.materials["default"].map_Kd = (np.round(np.stack(
            [_smooth_noise(rng, (tex, tex)) for _ in range(3)], axis=-1)
            * 255) / 255).astype(np.float32)
        scene = _scene(tr, device,
                       tr.Camera((2, 2.5, 4), center=(0, 0, 0), fovy=60,
                                 near=0.01, far=50),
                       tr.Light((3, 4, 2),
                                light_type=tr.Lightning.SPOT_LIGHTNING,
                                ambient_strength=0.1),
                       resolution=res((512, 512)),
                       shadows=name == "cfg3-rh-shadows")
        if name == "cfg3-rh-shadows":
            scene.system, scene.subsystem = tr.SYSTEM.RH, tr.SUBSYSTEM.DIRECTX
        scene.add_model(floor)
        scene.add_model(grip)
        return scene
    if name == "cfg4":
        mesh4 = stand_in_mesh(tr, rng, tex, diffuse=False, normals=False,
                              mesh=mesh)
        mesh4 = mesh4 @ _mat(T.scale(0.8), T.translation([0.3, 0, 0]),
                             T.rotate([0, 20, 0]))
        cube = gz.make_cube(0.6) @ _mat(T.translation([-1, 0, 0.5]))
        scene = _scene(tr, device,
                       tr.Camera((1.5, 2, 3.5), center=(0, 0, 0), fovy=70,
                                 near=0.01, far=100),
                       tr.Light((4, 5, 1), ambient_strength=0.15),
                       resolution=res((512, 512)),
                       skymap=skymap or procedural_cubemap(seed=seed))
        scene.add_model(mesh4)
        scene.add_model(cube)
        return scene
    if name == "cfg6":
        scene = _scene(tr, device,
                       tr.Camera((0.1, 2.2, 3.6), center=(0, 0, -0.4),
                                 fovy=65, near=0.0001, far=400),
                       tr.Light((3, 5, 2), ambient_strength=0.15),
                       shadows=True, resolution=res((512, 512)))
        rng7 = np.random.default_rng(7)
        for i in range(10):
            color = np.array([(i * 53) % 256, (i * 97 + 80) % 256,
                              (255 - i * 23) % 256], np.float64)
            img = np.clip(color * (0.55 + 0.45 * rng7.random((48, 48, 1))),
                          0, 255).astype(np.uint8)
            r, c = divmod(i, 5)
            scene.add_model(_box(tr, img.astype(np.float32) / 255.0, 0.62,
                                 ((c - 2) * 0.8, 0.35 * r - 0.2, -0.6 * r)))
        return scene
    raise ValueError(f"unknown configuration {name!r}; one of {CONFIGS}")
