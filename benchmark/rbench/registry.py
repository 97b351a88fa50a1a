"""BENCHMARK.json and the files it names, found by name.

- a cell's configuration: the ``file`` its configuration entry names (a
  JSON object of the scene's sizes and settings, ``scenes.build`` reads it);
  its builder ``benchmark/builders/<builder>.py`` and its reference
  ``benchmark/references/<reference>.py`` (:func:`plugin`);
- a traffic mix: ``benchmark/traffic/<traffic>.json`` (``traffic.Traffic``),
  each of its moves ``benchmark/moves/<kind>.py``;
- a metric's reader: ``benchmark/metrics/<name>.py``, or, where there is no
  such file, ``benchmark/metrics/<prefix>.py`` for a name
  ``<prefix>.<part>``; it defines ``read(run, part)``, which returns the
  metric's value or None where the run has nothing for it to read.
"""
from __future__ import annotations

import importlib.util
import json
import os

__all__ = ["Registry", "plugin"]

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PLUGINS = {}


def _load(path, module_name):
    if not os.path.exists(path):
        raise KeyError(f"no file {os.path.relpath(path, HERE)} in the "
                       "benchmark")
    spec = importlib.util.spec_from_file_location(module_name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def plugin(folder, name):
    """The module ``benchmark/<folder>/<name>.py`` (a builder, a reference,
    a traffic move), loaded once."""
    key = (folder, name)
    if key not in _PLUGINS:
        _PLUGINS[key] = _load(
            os.path.join(HERE, folder, name + ".py"),
            f"bench_{folder}_" + name.replace(".", "_").replace("-", "_"))
    return _PLUGINS[key]


class Registry:
    def __init__(self, root=None):
        self.root = root or os.path.dirname(HERE)
        with open(os.path.join(self.root, "BENCHMARK.json")) as f:
            self.bench = json.load(f)
        self._readers = {}

    def cell(self, name):
        for w in self.bench["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError(f"no workload {name!r} in BENCHMARK.json; one of "
                       f"{[w['name'] for w in self.bench['workloads']]}")

    def config(self, cell):
        """The cell's configuration file, as a dict."""
        for c in self.bench["configs"]:
            if c["name"] == cell["config"]:
                with open(os.path.join(self.root, c["file"])) as f:
                    return json.load(f)
        raise KeyError(f"no configuration {cell['config']!r}")

    def traffic(self, cell):
        path = os.path.join(HERE, "traffic", cell["traffic"] + ".json")
        with open(path) as f:
            return json.load(f)

    def metrics(self, cell, kind):
        """The ``kind`` ("end_to_end" or "per_layer") metrics the cell
        reports: those without a ``workloads`` list and those whose list
        names it."""
        return [m for m in self.bench[kind]
                if cell["name"] in m.get("workloads", [cell["name"]])]

    def reader(self, name):
        """(read function, part) of the metric ``name``."""
        if name not in self._readers:
            path = os.path.join(HERE, "metrics", name + ".py")
            part = None
            if not os.path.exists(path) and "." in name:
                prefix, part = name.rsplit(".", 1)
                path = os.path.join(HERE, "metrics", prefix + ".py")
            module = _load(path, "bench_metric_" + name.replace(
                ".", "_").replace("-", "_"))
            self._readers[name] = (module.read, part)
        return self._readers[name]
