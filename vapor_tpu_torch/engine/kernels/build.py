"""Builds the CUDA kernels with nvcc and binds them through ctypes.

Each source in csrc/ compiles on its own into a shared library with a
plain C entry point (no PyTorch headers, so a build takes seconds).  The
libraries land in BUILD_DIR under a name that carries a hash of the
sources and flags, so a changed source is rebuilt and an unchanged one is
reused.  Nothing here runs at import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
import time
from typing import Dict, Iterable

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = ("-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

_P, _I = ctypes.c_void_p, ctypes.c_int
_CODES = [_P] * 5 + [_I] * 5          # ch cf cd ms rlens, B H R lanes k
_TAIL = [_I, _P]                      # device index, stream
# kernel -> (C entry point, argtypes)
ENTRY_POINTS = {
    "hist": ("vt_hist", _CODES + [_I, _P, _P, _P] + _TAIL),
    "left_hist": ("vt_left_hist", _CODES + [_I, _P, _P] + _TAIL),
    "moment": ("vt_moment", _CODES + [_I, _P, _P, _I, _P] + _TAIL),
    "moment2": ("vt_moment2", _CODES + [_I, _P, _P, _P, _P, _P] + _TAIL),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): nvcc is "
                           "needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in (f"{name}.cu", "hits.cuh"):
        with open(os.path.join(CSRC, src), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(ENTRY_POINTS),
          extra_flags: Iterable[str] = ()) -> float:
    """Compiles every named kernel whose library is missing, one nvcc
    process per source, all started together.  Returns the seconds
    spent; raises with nvcc's output when any build fails."""
    t0 = time.perf_counter()
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
               os.path.join(CSRC, f"{name}.cu")]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    failed = []
    for name, out, tmp, proc in jobs:
        log = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            failed.append(f"{name}.cu:\n{log}")
        else:
            if log.strip():
                print(f"nvcc {name}.cu:\n{log}", flush=True)
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def entry_point(name: str):
    """The kernel's C launch function, building its library if needed."""
    with _lock:
        fn = _loaded.get(name)
        if fn is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            symbol, argtypes = ENTRY_POINTS[name]
            fn = getattr(ctypes.CDLL(path), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[name] = fn
    return fn
