"""Build and load the port's CUDA kernels (``tpu_renderer_torch/csrc/*.cu``).

Each source compiles with its own ``nvcc`` process, all started together,
and the objects link into one shared library with a plain C interface,
loaded through ``ctypes`` — no PyTorch headers, so a build takes seconds. The
library is built at first use into ``tpu_renderer_torch/build/`` (listed in
``.gitignore``) under a name that hashes the sources and flags, so an edited
source rebuilds and an unchanged one is reused.

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

_ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*_ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
              "-fmad=false", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
_F = ctypes.c_float
#: C signatures of the exported functions (every one returns cudaError_t).
_SIGNATURES = {
    # fdata, flags, fdbg (null: no debug camera), n_faces, bin_counts,
    # bin_items, H, W, row0, sign, want_tid, zb_sign, tid, stream
    "tr_visibility": [_P, _P, _P, _I, _P, _P, _I, _I, _I, _F, _I, _P, _P,
                      _P],
    # fdata, flags, fdbg (null: no debug camera), n_faces, bin_counts,
    # bin_items, zb_sign, H, W, row0, gid0, sign, tid, stream
    "tr_tidpass": [_P, _P, _P, _I, _P, _P, _P, _I, _I, _I, _I, _F, _P, _P],
    # fdata, adata, tid, H, W, row0, gid0, g_local, gbuffer, stream
    "tr_gbuffer": [_P, _P, _P, _I, _I, _I, _I, _I, _P, _P],
    # tid, iu, iv, ftex, slots, pool, n_kinds, n_slots, pool_size, H, W,
    # gid0, g_local, samp, mask, stream
    "tr_sample_textures": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _P, _P, _P],
    # qdata, qi, n_quads, n_rows (a count on the card; null: every row),
    # bin_counts, bin_items, zb_sign, H, W, row0, sign, zc (3 floats on the
    # card: nf2, fpn, fmn), stencil, stream
    "tr_stencil": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _I, _F, _P, _P, _P],
    # kind (0 faces, 1 quads), fdata, flags or qi, n, n_rows (null: n), H,
    # W, row0, bin_counts, bin_items, stream
    "tr_coarse_bins": [_I, _P, _P, _I, _P, _I, _I, _I, _P, _P, _P],
    # quad, order, cap, n_rows (a count on the card), planes, mvp,
    # viewport, H, W, qdata, qi, blocks (tr_quad_prep_blocks), stream
    "tr_quad_prep": [_P, _P, _I, _P, _P, _P, _P, _I, _I, _P, _P, _I, _P],
    # blocks (out): K8's persistent grid on the current device; no stream,
    # it launches nothing
    "tr_quad_prep_blocks": [ctypes.POINTER(_I)],
    # fdata, sdata, tid, layout, H, W, row0, gid0, g_local, gbuffer, stream
    "tr_gbuffer_slim": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    # ldata, lbbox, active, n_edges, zbuf, H, W, mask, stream
    "tr_lines": [_P, _P, _P, _I, _P, _I, _I, _P, _P],
    # tid, stencil (null: no shadows), gb, samp, samp_mask, scale_off (null:
    # no maps), n_models, light table, light type, background, sky plane,
    # spot edge0, spot scale, H, W, frame, stream
    "tr_shade": [_P, _P, _P, _P, _P, _P, _I, _P, _I, _P, _I, _F, _F, _I, _I,
                 _P, _P],
    # stamps (int64 slots the card can write), slot, stream
    "tr_stamp": [_P, _I, _P],
    # verts, vid, attr_consts, face_bits, mvp, viewport, near, far, dbg_mvp
    # (null: no debug camera), n_faces, H, W, culling, layout, fdata, flags,
    # fdbg (null without dbg_mvp), rows, world (null: general layout),
    # stream
    "tr_vertex": [_P] * 9 + [_I] * 5 + [_P] * 5 + [_P],
    # table, rows, frame, zbuf, H, W, sign, scratch, counter, stream
    "tr_overlay": [_P, _I, _P, _P, _I, _I, ctypes.c_double, _P, _P, _P],
    # frame, out, H, W, stream
    "tr_overlay_quantize": [_P, _P, _I, _I, _P],
}

_lib = None
#: Seconds the last build took and the compiler's report (register counts;
#: a library built before keeps its report beside it, ``<library>.log``).
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


def _run_all(cmds):
    """Run the commands at once; returns the log of all of them, and raises
    with it if one failed."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    log, failed = "", False
    for cmd, proc in procs:
        out, _ = proc.communicate()
        log += " ".join(cmd) + "\n" + out
        failed |= proc.returncode != 0
    if failed:
        raise RuntimeError(f"nvcc failed:\n{log}")
    return log


def build():
    """Compile the kernels unless an up-to-date library exists; returns its
    path. One nvcc per source runs at once, then one links the objects.
    Everything is written under names of this process first, so a cut build
    leaves nothing that looks complete."""
    out = os.path.join(BUILD_DIR, f"libtpu_renderer_kernels_{_digest()}.so")
    if os.path.exists(out):
        log = ""
        if os.path.exists(f"{out}.log"):
            with open(f"{out}.log") as f:
                log = f.read()
        last_build.update(seconds=0.0, log=log, path=out)
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tag = f"{os.getpid()}.tmp"
    nvcc = nvcc_path()
    objs = [os.path.join(BUILD_DIR, f"{os.path.basename(src)}.{tag}.o")
            for src in _sources()]
    t0 = time.perf_counter()
    try:
        log = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]
                        for src, obj in zip(_sources(), objs)])
        tmp = f"{out}.{tag}"
        log += _run_all([[nvcc, *_ARCH, "-shared", "-o", tmp, *objs]])
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    os.replace(tmp, out)
    last_build.update(seconds=time.perf_counter() - t0, log=log, path=out)
    for path in (os.path.join(BUILD_DIR, "build.log"), f"{out}.log"):
        with open(path, "w") as f:
            f.write(log)
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
