"""The move ``paint``: one model's texture changed every frame.

Parameters: ``model`` (the index of a model of the configuration's scene),
``map`` ("kd", the diffuse map, or "norm", the normal map) and ``size``:
each frame paints a square of ``size`` by ``size`` texels of the map as the
builder made it, at a place and in a colour drawn from the seed and the
frame's index (a diffuse colour in [0, 1], or a unit normal facing out).
Every model that shares the map shows the paint. On the system the map is
set on the model's material and the models that share it are marked
changed (``Model.bump_version``), as a user of the system changes a
texture.
"""
import numpy as np

_ATTR = {"kd": "map_kd", "norm": "norm"}


class Move:
    def __init__(self, params, spec, seed):
        self.k = int(params["model"])
        self.kind = params["map"]
        self.size = int(params["size"])
        self.seed = int(seed)
        self.base = getattr(spec.models[self.k], _ATTR[self.kind])
        if self.base is None:
            raise ValueError(f"model {self.k} has no {self.kind!r} map")
        self._work = None
        self._last = None

    def at(self, i, t):
        """(row, column, colour) of frame ``i``'s square."""
        rng = np.random.default_rng([self.seed, 4, int(i < 0), abs(int(i))])
        th, tw = self.base.shape[:2]
        s = min(self.size, th, tw)
        y, x = (int(rng.integers(0, n - s + 1)) for n in (th, tw))
        if self.kind == "kd":
            colour = rng.uniform(0.0, 1.0, 3)
        else:
            v = np.array([*rng.uniform(-0.5, 0.5, 2), 1.0])
            colour = v / np.linalg.norm(v)
        return y, x, colour.astype(np.float32)

    def _square(self, y, x):
        s = min(self.size, *self.base.shape[:2])
        return slice(y, y + s), slice(x, x + s)

    def apply(self, port, value):
        if self._work is None:
            self._work = np.array(self.base, np.float32)
        if self._last is not None:
            sq = self._square(*self._last)
            self._work[sq] = self.base[sq]
        y, x, colour = value
        self._work[self._square(y, x)] = colour
        self._last = (y, x)
        port.set_map(self.k, self.kind, self._work)

    def view(self, view, value):
        y, x, colour = value
        out = np.array(self.base, np.float32)
        out[self._square(y, x)] = colour
        view["maps"].setdefault(self.k, {})[self.kind] = out
