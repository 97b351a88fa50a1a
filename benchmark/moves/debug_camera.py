"""The move ``debug_camera``: the configuration's debug camera, still.

No parameters: the camera is the configuration's ``camera["debug"]``
(``position``, ``center``, ``fovy``, ``near``, ``far``,
``backface_culling``), perspective with the up vector (0, 1, 0). The
first ``apply`` (the runner's first, before the scene is packed) installs
it as the system's ``Scene.debug_camera``, as a user of the system passes
one; later calls leave it as it is, as the reference renderer's
``camera2`` stands still while the main camera moves. ``view`` hands the
reference the same camera under ``debug``.
"""


class Move:
    def __init__(self, params, spec, seed):
        self.debug = dict(spec.camera["debug"])

    def at(self, i, t):
        return self.debug

    def apply(self, port, value):
        if port.scene.debug_camera is not None:
            return
        import tpu_renderer_torch as tr

        port.scene.debug_camera = tr.Camera(
            value["position"], center=value["center"], fovy=value["fovy"],
            near=value["near"], far=value["far"],
            backface_culling=value["backface_culling"])

    def view(self, view, value):
        view["debug"] = value
