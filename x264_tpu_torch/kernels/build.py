"""Build and load the kernels' shared library.

The sources in ``x264_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` into one shared library with a plain C interface, at first
use, into ``x264_tpu_torch/build`` (git-ignored).  The library's name
carries a hash of the sources, so an edited source is rebuilt and a
current build is reused.  Loading goes through ``ctypes``: pointers and
the stream travel as ``c_void_p``, sizes as ``c_int``, and every entry
point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (see the extern "C" blocks in csrc/*.cu)
SIGNATURES = {
    "esa16_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "deblock_luma_launch": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P],
    "deblock_chroma_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _P],
}

_lib = None
build_info: dict = {}       # seconds, library path, compiler log


def _sources() -> list:
    return sorted(os.path.join(CSRC, f) for f in os.listdir(CSRC)
                  if f.endswith((".cu", ".cuh")))


def _nvcc() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", ""), "bin",
                              "nvcc"),
                 "/usr/local/cuda/bin/nvcc", shutil.which("nvcc") or ""):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                       "toolkit (CUDA_HOME or /usr/local/cuda)")


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = _sources()
    digest = hashlib.sha256()
    for s in srcs:
        with open(s, "rb") as f:
            digest.update(f.read())
    digest.update(" ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD, exist_ok=True)
    so = os.path.join(BUILD, f"libx264tpu_kernels_{digest.hexdigest()[:16]}"
                             ".so")
    t0 = time.perf_counter()
    log = ""
    with open(os.path.join(BUILD, "lock"), "w") as lockf:
        # parallel processes must not race the build
        fcntl.flock(lockf, fcntl.LOCK_EX)
        if not os.path.exists(so):
            cu = [s for s in srcs if s.endswith(".cu")]
            tmp = so + ".tmp"
            r = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, *cu],
                               capture_output=True, text=True)
            log = r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc failed:\n{log}")
            os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.x264tpu_cuda_error.argtypes = [ctypes.c_int]
    lib.x264tpu_cuda_error.restype = ctypes.c_char_p
    build_info.update(seconds=time.perf_counter() - t0, path=so, log=log)
    _lib = lib
    return lib


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        msg = library().x264tpu_cuda_error(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")
