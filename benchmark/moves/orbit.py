"""The move ``orbit``: the camera or the light on a circle.

Parameters: ``target`` ("camera" or "light"); ``about``, ``sin`` and
``cos`` (3 numbers each): the object stands at ``about + sin(t) * sin +
cos(t) * cos``, computed in float64 and handed to both sides as the same
float32 (3,) array.
"""
import math

import numpy as np


class Move:
    def __init__(self, params, spec, seed):
        self.target = params["target"]
        if self.target not in ("camera", "light"):
            raise ValueError(f"orbit moves the camera or the light, not "
                             f"{self.target!r}")
        self.about, self.sin, self.cos = (
            np.asarray(params[k], np.float64) for k in ("about", "sin", "cos"))

    def at(self, i, t):
        return (self.about + math.sin(t) * self.sin
                + math.cos(t) * self.cos).astype(np.float32)

    def apply(self, port, value):
        getattr(port.scene, self.target).set_position(value)

    def view(self, view, value):
        view[self.target] = value
