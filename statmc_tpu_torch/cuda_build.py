"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build runs at first use, into ``build/statmc_tpu_torch/`` under the
repository root, and is reused while the sources' hash is unchanged.
Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.abspath(__file__))
_CSRC = os.path.join(_PKG, "csrc")
_BUILD = os.path.join(os.path.dirname(_PKG), "build", "statmc_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_lib = None
build_seconds = None  # wall time of the build this process ran, if any

_vp, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # raye, rayp, t_max, edge, plane, n_rays, n_tiles, t_out, id_out, stream
    "statmc_fused_intersect": [_vp, _vp, _vp, _vp, _vp, _i, _i, _vp, _vp,
                               _vp],
    # mc, d2, fm, gb, valid, gb_factors, H, W, C, CF, G, radius, ds,
    # normalize, out, wsum, stream
    "statmc_stat_filter": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                           _i, ctypes.c_float, _i, _vp, _vp, _vp],
    # bounds, rays, n_blocks, nf, vote, stream
    "statmc_twolevel_cull": [_vp, _vp, _i, _i, _vp, _vp],
    # table, order, count, mask, n_words, feat, t_max, n_blocks, n_sub,
    # fsub, t_out, id_out, stream
    "statmc_twolevel_walk": [_vp, _vp, _vp, _vp, _i, _vp, _vp, _i, _i, _i,
                             _vp, _vp, _vp],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ on first use."""
    global _lib, build_seconds
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sources:
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(_BUILD, f"libstatmc_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        tmp = f"{so}.{os.getpid()}.tmp"
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *sources],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n"
                               f"{proc.stdout}\n{proc.stderr}")
        os.replace(tmp, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def check(rc: int, name: str) -> None:
    """Raise when a launch reported a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc} at launch")
