"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by ``nvcc`` for ``sm_90a`` (one
process per source, all started together) and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs
at first use, into ``build/statmc_tpu_torch/`` under the repository
root, and is reused while the hash of the sources (``*.cu`` and the
``*.cuh`` they include) is unchanged.  Nothing here runs at import time.
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
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-I", _CSRC)

_lib = None
build_seconds = None  # wall time of the build this process ran, if any
ptxas_log = None  # ptxas -v of that build: registers, shared memory, spills

_vp, _i = ctypes.c_void_p, ctypes.c_int
_SIGNATURES = {
    # raye, rayp, t_max, packed, n_rays, n_sub, n_tris, t_out, id_out,
    # stream
    "statmc_fused_intersect": [_vp, _vp, _vp, _vp, _i, _i, _i, _vp, _vp,
                               _vp],
    # mc, d2, fm, gb, valid, gb_factors (double), H, W, C, CF, G, radius,
    # ds, normalize, accept_expand, range_bf16, accept_bf16, gs, out, wsum,
    # stream
    "statmc_stat_filter": [_vp, _vp, _vp, _vp, _vp, _vp, _i, _i, _i, _i, _i,
                           _i, ctypes.c_float, _i, _i, _i, _i, _vp, _vp, _vp,
                           _vp],
    # bounds, rays, n_blocks, nf, vote, stream
    "statmc_twolevel_cull": [_vp, _vp, _i, _i, _vp, _vp],
    # packed, order, count, mask, n_words, feat, t_max, n_blocks, n_sub,
    # fsub, t_out, id_out, stream
    "statmc_twolevel_walk": [_vp, _vp, _vp, _vp, _i, _vp, _vp, _i, _i, _i,
                             _vp, _vp, _vp],
    # args (struct Args of threefry.cu, core/rng.py:_R1Args), stream
    "statmc_threefry": [_vp, _vp],
    # out[2] = {resident blocks per SM, registers per thread}
    "statmc_fused_intersect_occupancy": [ctypes.POINTER(ctypes.c_int)],
    "statmc_twolevel_walk_occupancy": [ctypes.POINTER(ctypes.c_int)],
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (PATH or /usr/local/cuda/bin)")
    return path


def _build(sources, so) -> str:
    """Compile each source in its own nvcc process, link them into `so`;
    returns the compilers' messages (ptxas -v)."""
    nvcc = _nvcc()
    tmp = f"{so}.{os.getpid()}"
    objs = [f"{tmp}.{i}.o" for i in range(len(sources))]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                              text=True)
             for src, obj in zip(sources, objs)]
    outs = [p.communicate()[0] for p in procs]
    try:
        for src, p, out in zip(sources, procs, outs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed ({p.returncode}) on "
                                   f"{os.path.basename(src)}:\n{out}")
        link = subprocess.run([nvcc, "-shared", "-o", f"{tmp}.tmp", *objs],
                              capture_output=True, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({link.returncode}):\n"
                               f"{link.stdout}\n{link.stderr}")
        os.replace(f"{tmp}.tmp", so)
    finally:
        for obj in objs:
            if os.path.exists(obj):
                os.remove(obj)
    return "".join(outs)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built from csrc/ on first use."""
    global _lib, build_seconds, ptxas_log
    if _lib is not None:
        return _lib
    sources = sorted(glob.glob(os.path.join(_CSRC, "*.cu")))
    headers = sorted(glob.glob(os.path.join(_CSRC, "*.cuh")))
    h = hashlib.sha256(" ".join(NVCC_FLAGS[:-1]).encode())
    for src in sources + headers:
        with open(src, "rb") as f:
            h.update(f.read())
    so = os.path.join(_BUILD, f"libstatmc_kernels_{h.hexdigest()[:16]}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD, exist_ok=True)
        t0 = time.perf_counter()
        ptxas_log = _build(sources, so)
        build_seconds = time.perf_counter() - t0
    lib = ctypes.CDLL(so)
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    _lib = lib
    return lib


def occupancy(kernel: str) -> tuple[int, int]:
    """(resident blocks per SM, registers per thread) that the CUDA
    runtime reports for `kernel` ("fused_intersect" or "twolevel_walk")."""
    out = (ctypes.c_int * 2)()
    check(getattr(library(), f"statmc_{kernel}_occupancy")(out),
          f"statmc_{kernel}_occupancy")
    return out[0], out[1]


def check(rc: int, name: str) -> None:
    """Raise when a call into the library reported a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA error {rc}")
