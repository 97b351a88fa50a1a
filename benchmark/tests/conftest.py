"""Fixtures of the benchmark's own tests: the harness's modules on the
path, small configurations for the CPU, and ``cuda`` for tests that need a
card (decided here, at run time, never at import)."""
import os
import sys

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (ROOT, BENCH):
    if p not in sys.path:
        sys.path.insert(0, p)

#: Sizes at which the CPU runs a cell in seconds: every other setting is
#: the configuration's own.
SMALL = {"resolution": [40, 40], "texture_size": 16, "mesh_bands": [8, 12]}


@pytest.fixture
def small():
    return dict(SMALL)


@pytest.fixture
def cuda():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (torch.cuda.is_available() is false)")
    return "cuda"


@pytest.fixture(scope="session")
def reg():
    from rbench.registry import Registry

    return Registry(ROOT)
