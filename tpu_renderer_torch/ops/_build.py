"""Build and load the port's CUDA kernels (``tpu_renderer_torch/csrc/*.cu``).

The sources compile with ``nvcc`` into one shared library with a plain C
interface, loaded through ``ctypes`` — no PyTorch headers, so a build takes
seconds. The library is built at first use into ``tpu_renderer_torch/build/``
(listed in ``.gitignore``) under a name that hashes the sources and flags, so
an edited source rebuilds and an unchanged one is reused.

Flags: ``-fmad=false`` keeps nvcc from contracting ``a*b + c`` into a fused
multiply-add. The kernels then round every product and sum separately, as
the plain PyTorch versions' elementwise ops do, and the two agree bit for
bit. Division is IEEE (no ``--use_fast_math``; the sources write
``__fdiv_rn`` where it matters).
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

__all__ = ["nvcc_path", "build", "load", "NVCC_FLAGS"]

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "build")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-fmad=false", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
#: C signatures of the exported launchers (every one returns cudaError_t).
_SIGNATURES = {
    # fdata, flags, tile_off, tile_items, H, W, tiles_x, sign, zb_sign, tid,
    # stream
    "tr_visibility": [_P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    # fdata, adata, tid, H, W, gbuffer, stream
    "tr_gbuffer": [_P, _P, _P, _I, _I, _P, _P],
    # tid, iu, iv, ftex, slots, pool, n_kinds, n_slots, pool_size, H, W,
    # samp, mask, stream
    "tr_sample_textures": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                           _P, _P, _P],
    # qdata, qi, tile_off, tile_items, zb_sign, H, W, tiles_x, sign_nf2, fpn,
    # fmn, stencil, stream
    "tr_stencil": [_P, _P, _P, _P, _P, _I, _I, _I, _F, _F, _F, _P, _P],
    # fdata, sdata, tid, layout, H, W, gbuffer, stream
    "tr_gbuffer_slim": [_P, _P, _P, _I, _I, _I, _P, _P],
    # ldata, lbbox, tile_off, tile_items, zbuf, H, W, tiles_x, mask, stream
    "tr_lines": [_P, _P, _P, _P, _P, _I, _I, _I, _P, _P],
}

_lib = None
#: Seconds the last build took and the compiler's report (register counts).
last_build = {"seconds": None, "log": "", "path": None}


def nvcc_path():
    """The CUDA compiler: ``$CUDA_HOME/bin/nvcc``, then ``PATH``, then
    ``/usr/local/cuda/bin/nvcc``. Raises RuntimeError when none exists."""
    cands = []
    for var in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(var):
            cands.append(os.path.join(os.environ[var], "bin", "nvcc"))
    found = shutil.which("nvcc")
    if found:
        cands.append(found)
    cands.append("/usr/local/cuda/bin/nvcc")
    for c in cands:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "host with the CUDA toolkit")


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _digest():
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources() + sorted(glob.glob(os.path.join(CSRC, "*.cuh"))):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode())
            h.update(f.read())
    return h.hexdigest()[:16]


def build():
    """Compile the kernels unless an up-to-date library exists; returns its
    path. Writes to a temporary name first, so a cut build leaves nothing
    that looks complete."""
    out = os.path.join(BUILD_DIR, f"libtpu_renderer_kernels_{_digest()}.so")
    if os.path.exists(out):
        last_build.update(seconds=0.0, path=out)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *_sources()]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    log = proc.stdout + proc.stderr
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{log}")
    os.replace(tmp, out)
    last_build.update(seconds=time.perf_counter() - t0, log=log, path=out)
    with open(os.path.join(BUILD_DIR, "build.log"), "w") as f:
        f.write(" ".join(cmd) + "\n" + log)
    return out


def load():
    """The loaded kernel library (built on first call), with ``argtypes`` and
    ``restype`` declared for every launcher."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib
