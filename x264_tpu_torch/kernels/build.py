"""Build and load the kernels' shared library.

The sources in ``x264_tpu_torch/csrc`` are compiled with ``nvcc`` for
``sm_90a`` — one ``nvcc`` process per source, all started together —
and linked into one shared library with a plain C interface, at first
use, into ``x264_tpu_torch/build`` (git-ignored).  The library's name
carries a hash of the sources, so an edited source is rebuilt and a
current build is reused.  Loading goes through ``ctypes``: pointers and
the stream travel as ``c_void_p``, sizes as ``c_int``, and every entry
point returns ``cudaGetLastError()``.
"""

from __future__ import annotations

import collections
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD = os.path.join(_PKG, "build")
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# entry point -> argument types (see the extern "C" blocks in csrc/*.cu)
SIGNATURES = {
    "esa16_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    "esa_parts_launch": [_P] * 11 + [_I] * 5 + [_P],
    "esa_sad_probe_launch": [_P, _I, _I, _P],
    "esa_geom_query": [_I, _I, _I, _P],
    "deblock_launch": [_P] * 11 + [_I] * 4 + [_P],
    "deblock_chain_probe_launch": [_P, _P, _P, _P, _I, _I, _P],
    "trellis_launch": [_P, _P, _P, _P, _I, _I, _P],
    "trellis_launch_layout": [_P, _P, _P, _P, _I, _I, _I, _P],
    "trellis_auto_layout": [_I, _I],
    "trellis_params_len": [_I],
    "intra_nxn_launch": [_P] * 7 + [_I] * 6 + [_P],
    "cavlc_mb_launch": [_P] * 12 + [_I, _I, _P],
    "cavlc_table_len": [],
    "cavlc_smem_bytes": [],
    "bitpack_launch": [_P, _P, _I, _P, _P, _I] + [_P] * 4
                      + [_I, _P, _I, _I, _P],
    "bitplace_launch": [_P, _I, _I, _I, _P, _P, ctypes.c_longlong, _P],
    "bitplace_max_mbs": [],
    "bitplace_sum_mbs": [],
    "bitpack_max_words": [],
    "bitpack_max_slots": [],
    "bitpack_max_fields": [],
    "bitpack_smem_bytes": [_I, _I, _I],
    "pir_column_launch": [_P] * 23 + [_I] * 4 + [_P],
    "pir_column_geom": [_I] * 4 + [_P],
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
            objs = [so[:-3] + "_" + os.path.basename(s)[:-3] + ".o"
                    for s in cu]
            procs = [subprocess.Popen([_nvcc(), *NVCC_FLAGS, "-c", s, "-o", o],
                                      stdout=subprocess.PIPE,
                                      stderr=subprocess.STDOUT, text=True)
                     for s, o in zip(cu, objs)]
            failed = False
            for s, p in zip(cu, procs):
                out = p.communicate()[0]
                log += f"== {os.path.basename(s)}\n{out}"
                failed |= p.returncode != 0
            if failed:
                raise RuntimeError(f"nvcc failed:\n{log}")
            tmp = so + ".tmp"
            r = subprocess.run([_nvcc(), *ARCH, "-shared", "-o", tmp, *objs],
                               capture_output=True, text=True)
            log += r.stdout + r.stderr
            if r.returncode != 0:
                raise RuntimeError(f"nvcc link failed:\n{log}")
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


Resources = collections.namedtuple(
    "Resources", "registers spill_stores spill_loads smem stack")


def kernel_resources(log: str) -> dict:
    """ptxas's report in a build log (``-Xptxas -v``) -> {mangled kernel
    name: Resources}: registers, spill store and load bytes, static
    shared memory and stack frame bytes."""
    out, name = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function|Function properties "
                      r"for) '?([\w$.]+)'?", line)
        if m:
            name = m.group(1)
        spill = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill "
                          r"stores, (\d+) bytes spill loads", line)
        regs = re.search(r"Used (\d+) registers", line)
        if name and (spill or regs):
            r = out.setdefault(name, [0, 0, 0, 0, 0])
            if spill:
                r[4], r[1], r[2] = (int(x) for x in spill.groups())
            if regs:
                r[0] = int(regs.group(1))
                sm = re.search(r"(\d+) bytes smem", line)
                r[3] = int(sm.group(1)) if sm else 0
    return {k: Resources(*v) for k, v in out.items()}


def check(err: int, name: str) -> None:
    """Raise when a launch returned a CUDA error code."""
    if err != 0:
        msg = library().x264tpu_cuda_error(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err}: {msg}")


def check_tensors(kernel: str, device, specs) -> None:
    """Raise ValueError unless every (name, tensor, shape, dtype, aligned)
    of ``specs`` is a contiguous tensor of that shape and dtype on
    ``device``, 16-byte aligned where asked: the kernels convert nothing.
    One test a tensor on the path that passes (the wrappers run once per
    core), the reasons only when one fails."""
    for name, t, shape, dtype, aligned in specs:
        try:
            ok = (t.dtype is dtype and t.shape == shape
                  and t.device == device and t.is_contiguous()
                  and not (aligned and t.data_ptr() & 15))
        except AttributeError:
            raise ValueError(f"{kernel}: {name} is not a tensor") from None
        if not ok:
            bad = [f"shape {tuple(t.shape)} != {tuple(shape)}"
                   if t.shape != shape else "",
                   f"dtype {t.dtype} != {dtype}" if t.dtype is not dtype
                   else "",
                   f"device {t.device} != {device}" if t.device != device
                   else "",
                   "" if t.is_contiguous() else "not contiguous",
                   "not 16-byte aligned" if aligned and t.data_ptr() & 15
                   else ""]
            raise ValueError(f"{kernel}: {name}: "
                             + ", ".join(b for b in bad if b))
