"""A whole run on the CPU at a small size: the result's shape, what it
loads, and the runs that must print no result."""
import json
import os
import shutil
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, SMALL

FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_renderer")


@pytest.mark.parametrize("cell", ["flagship-orbit", "crowd-instances-orbit"])
def test_result_line(cell, small, reg):
    from rbench import runner

    result, lines = runner.run(cell, 2**31 + 11, 0.5, False, root=ROOT,
                               device="cpu", config=small)
    assert list(result) == ["correct", "attempted", "failed", "metrics",
                            "device", "setup", "checks"]
    assert result["correct"] is True
    assert result["attempted"] >= 1 and result["failed"] == 0
    want = {m["name"]: m["unit"]
            for m in reg.metrics(reg.cell(cell), "end_to_end")}
    assert {k: v["unit"] for k, v in result["metrics"].items()} == want
    assert all(v["value"] > 0 for v in result["metrics"].values())
    assert set(result["device"]) == {"platform", "kind", "count",
                                     "memory_peak_bytes"}
    assert set(result["checks"]) == {"frame_ppm", "tid_ppm", "zbuf_ppm",
                                     "stencil_ppm"}
    assert set(result["setup"]["parts_s"]) == {
        "import", "library", "scene", "pack", "first_frame", "warm_frames"}
    assert sum(result["setup"]["parts_s"].values()) == pytest.approx(
        result["metrics"]["setup_s"]["value"])
    assert result["setup"]["built"] is False
    assert all(set(c) == {"value", "limit"}
               for c in result["checks"].values())
    assert len(lines) == len(result["checks"])
    json.dumps(result)


def test_traced_run_keeps_the_check(small):
    from rbench import runner

    result, _ = runner.run("flagship-orbit", 5, 0.5, True, root=ROOT,
                           device="cpu", config=small)
    assert result["correct"] is True
    assert result["attempted"] == runner.TRACE_FRAMES
    assert "checks" in result


def test_no_forbidden_module_is_loaded():
    code = (
        "import sys; sys.path[:0] = [%r, %r]\n"
        "from rbench import runner\n"
        "runner.run('flagship-orbit', 3, 0.2, False, root=%r, device='cpu',"
        " config=%r)\n"
        "print(sorted({m.split('.', 1)[0] for m in sys.modules}))\n"
        % (BENCH, ROOT, ROOT, SMALL))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    top = set(json.loads(out.stdout.strip().splitlines()[-1]
                         .replace("'", '"')))
    assert "tpu_renderer_torch" in top
    assert not top & set(FORBIDDEN)


def test_forbidden_names_compare_whole_top_level_names(monkeypatch):
    from rbench import runner

    monkeypatch.setitem(sys.modules, "tpu_renderer_torch_extra", sys)
    assert "tpu_renderer" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "tpu_renderer.ops", sys)
    assert "tpu_renderer" in runner.forbidden_modules()


def _no_result(out):
    last = (out.stdout.strip().splitlines() or [""])[-1]
    return out.returncode != 0 and not last.startswith("{")


def test_no_card_no_result(cuda_absent):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship-orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=ROOT)
    assert _no_result(out), out.stdout[-500:]
    assert "torch.cuda.is_available() is false" in out.stderr


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(BENCH, tmp_path / "benchmark",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", "flagship-orbit",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=300, cwd=tmp_path)
    assert _no_result(out)


@pytest.fixture
def cuda_absent():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present")
