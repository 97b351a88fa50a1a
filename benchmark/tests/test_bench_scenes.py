"""The frozen scene builders give the same arrays as bench_torch.py's."""
import numpy as np


def _same_model(spec_model, port_model):
    np.testing.assert_array_equal(spec_model.world_vertices(),
                                  port_model.vertices)
    np.testing.assert_array_equal(spec_model.uv, port_model.uv)
    np.testing.assert_array_equal(spec_model.normals, port_model.normals)
    np.testing.assert_array_equal(spec_model.faces, port_model.face_array)
    assert spec_model.shadowing == port_model.shadowing
    mat = port_model.materials["default"]
    for attr, mine in (("map_Kd", spec_model.map_kd),
                       ("norm", spec_model.norm)):
        theirs = mat.__dict__.get(attr)
        if mine is None:
            assert theirs is None
        else:
            np.testing.assert_array_equal(mine, theirs)
    if spec_model.norm is not None:
        assert mat.norm.dtype.metadata["tangent"] == spec_model.norm_tangent


def _same_scene(spec, scene):
    assert len(spec.models) == len(scene.models)
    for a, b in zip(spec.models, scene.models):
        _same_model(a, b)
    cam, lt = scene.camera, scene.light
    np.testing.assert_array_equal(np.float32(spec.camera["position"]),
                                  cam.position)
    assert (spec.camera["fovy"], spec.camera["near"], spec.camera["far"]) \
        == (cam.fovy, cam.near, cam.far)
    assert spec.backface_culling == cam.backface_culling
    np.testing.assert_array_equal(np.float32(spec.light["position"]),
                                  lt.position)
    np.testing.assert_array_equal(np.float32(spec.light["center"]), lt.center)
    assert (spec.light["specular_strength"], spec.light["linear"],
            spec.light["quadratic"]) == (lt.specular_strength, lt.linear,
                                         lt.quadratic)
    assert spec.shadows == scene.shadows
    assert tuple(spec.resolution) == scene.resolution


def test_flagship_as_bench_torch(reg):
    import bench_torch
    from rbench import scenes

    cfg = {**reg.config(reg.cell("flagship-orbit")), "resolution": [48, 48],
           "texture_size": 16}
    spec = scenes.build(cfg, 3)
    scene = bench_torch.build_scene(device="cpu", resolution=(48, 48),
                                    tex=16, seed=3)
    _same_scene(spec, scene)


def test_crowd_as_bench_torch(reg):
    import bench_torch
    from rbench import scenes

    cfg = {**reg.config(reg.cell("crowd-instances-orbit")),
           "resolution": [48, 48], "texture_size": 16, "mesh_bands": [10, 14]}
    spec = scenes.build(cfg, 3)
    scene = bench_torch.build_highpoly_scene(
        20, resolution=(48, 48), merged=False, device="cpu", tex=16, seed=3,
        mesh=(10, 14))
    _same_scene(spec, scene)
    assert spec.num_faces == sum(m.num_faces for m in scene.models)


def test_port_scene_shares_instances(reg, small):
    import tpu_renderer_torch as tr
    from rbench import scenes

    spec = scenes.build({**reg.config(reg.cell("crowd-instances-orbit")),
                         **small}, 3)
    port = scenes.port_scene(tr, spec, "cpu")
    meshes = port.scene.models[:-1]
    assert len({id(m.face_array) for m in meshes}) == 1
    assert len({id(m.materials["default"].map_Kd) for m in meshes}) == 1
    assert port.owners == [[k] for k in range(21)]


def test_port_scene_merged_numbers_faces_as_the_spec(reg, small):
    """Submitted merged, the 20 instances are one model; either way each
    face id of the system maps to the face's number in the spec."""
    import tpu_renderer_torch as tr
    from rbench import scenes

    cfg = {**reg.config(reg.cell("crowd-instances-orbit")), **small}
    spec = scenes.build({**cfg, "submission": "merged"}, 3)
    merged = scenes.port_scene(tr, spec, "cpu")
    alone = scenes.port_scene(tr, scenes.build(cfg, 3), "cpu")
    assert merged.owners == [list(range(20)), [20]]
    assert len(merged.scene.models) == 2
    faces = spec.num_faces
    for port in (merged, alone):
        table = port.face_table()
        real = table[table >= 0]
        assert real.tolist() == list(range(faces))
        assert set(table[table < 0].tolist()) <= {-2}
