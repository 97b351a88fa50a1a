"""BENCHMARK.json, and every cell, configuration, builder, reference,
traffic mix, traffic move and metric reader it names, load by name."""
import json
import os
import re

import pytest

from conftest import ROOT, SMALL

with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
    BENCH = json.load(f)
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/")
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert set(m.get("workloads", CELLS)) <= set(CELLS)
    names = [x["name"] for x in BENCH["configs"]] + CELLS + METRICS
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert all(m["unit"] == "%" for m in BENCH["per_layer"]
               if m["name"].endswith("_roofline"))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_loads_by_name(reg, cell, small):
    from rbench import scenes
    from rbench.registry import plugin
    from rbench.traffic import Traffic

    w = reg.cell(cell)
    cfg = reg.config(w)
    spec = scenes.build({**cfg, **small}, 7)
    assert spec.resolution == (40, 40) and spec.models
    assert spec.settings == {k: cfg.get(k, v)
                             for k, v in scenes.SETTINGS.items()}
    assert plugin("references", cfg["reference"]).Reference
    view = Traffic(reg.traffic(w), 7, spec).view(
        Traffic(reg.traffic(w), 7, spec).at(-3))
    for key in ("camera", "light"):
        assert view[key].shape == (3,) and view[key].dtype.name == "float32"
    e2e = [m["name"] for m in reg.metrics(w, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert reg.metrics(w, "per_layer")


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(reg, name):
    read, part = reg.reader(name)
    assert callable(read)
    assert part == (name.split(".", 1)[1] if name.startswith("stage_ms.")
                    else None)


def test_traffic_same_seed_same_moves(reg):
    from rbench import scenes
    from rbench.traffic import Traffic

    cell = reg.cell(CELLS[0])
    spec = scenes.build({**reg.config(cell), **SMALL}, 3)
    mix = reg.traffic(cell)
    a, b = Traffic(mix, 2**31 + 5, spec), Traffic(mix, 2**31 + 5, spec)
    for i in range(-3, 9):
        va, vb = a.view(a.at(i)), b.view(b.at(i))
        assert (va["camera"] == vb["camera"]).all()
        assert (va["light"] == vb["light"]).all()
    assert Traffic(mix, 1, spec).t0 != Traffic(mix, 2, spec).t0


def test_unknown_plugin_names_its_file():
    from rbench.registry import plugin

    with pytest.raises(KeyError, match="moves/no-such-kind.py"):
        plugin("moves", "no-such-kind")
