"""Builds the CUDA kernels with nvcc and binds them through ctypes.

Each source in csrc/ compiles on its own into a shared library with a
plain C entry point (no PyTorch headers, so a build takes seconds).  The
libraries land in BUILD_DIR under a name that carries a hash of the
flags, the source and every header in csrc/, so a changed source or
header is rebuilt and an unchanged one is reused.  Nothing here runs at
import time.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Dict, Iterable, Tuple

from ...utils import trace

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
    "hist": ("vt_hist", _CODES + [_I, _P] + _TAIL),
    "left_hist": ("vt_left_hist", _CODES + [_I, _P, _P] + _TAIL),
    "kept_hist": ("vt_kept_hist", _CODES + [_I, _P, _P, _P] + _TAIL),
    "moment": ("vt_moment", _CODES + [_I, _P, _P, _I, _P] + _TAIL),
    "moment2": ("vt_moment2", _CODES + [_I, _P, _P, _P, _P, _P] + _TAIL),
    "rdd_moment": ("vt_rdd_moment", _CODES + [_I, _P, _P, _P, _P] + _TAIL),
}
# (kernel, route) -> (C entry point, argtypes) of a route that has an
# entry point of its own in its kernel's source
ROUTE_POINTS = {
    ("hist", "selfstats"): ("vt_hist_self", _CODES + [_P] + _TAIL),
}
# kernel (every one walks csrc/walk.cuh's on-chip walk) -> C function
# that reports its grid: (B, H, R, lanes, device index, int[5] out); a
# route of ROUTE_POINTS reports its own through <its entry point>_grid
GRID_POINTS = {name: f"vt_{name}_grid" for name in ENTRY_POINTS}
_LL = ctypes.c_longlong
# glue kernel (kernels.GLUE_NAMES; none walks walk.cuh, none has a grid
# query) -> (source in csrc/ without .cu, C entry point, argtypes)
GLUE_POINTS = {
    # haps reads rlens hap_index, U B H R lanes k, ch cf cd
    "row_codes": ("codes", "vt_row_codes",
                  [_P] * 4 + [_I] * 6 + [_P] * 3 + _TAIL),
    # out, 4 histograms, 4 thresholds, fallback bits, n B W gap
    "kept_tables": ("kept_table", "vt_kept_tables",
                    [_P] * 5 + [_LL] * 4 + [_I] * 5 + _TAIL),
    # h, B W H, z found
    "intercept_z": ("intercept", "vt_intercept_z",
                    [_P] + [_I] * 3 + [_P] * 2 + _TAIL),
}

_lock = threading.Lock()
_loaded: Dict[str, ctypes._CFuncPtr] = {}     # C symbol -> function


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME
    if CUDA_HOME is None:
        raise RuntimeError("no CUDA toolkit found (CUDA_HOME): nvcc is "
                           "needed to build the kernels")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def source(name: str) -> str:
    """The kernel's source file in csrc/."""
    return f"{GLUE_POINTS[name][0] if name in GLUE_POINTS else name}.cu"


def library_path(name: str) -> str:
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    headers = sorted(x for x in os.listdir(CSRC) if x.endswith(".cuh"))
    for src in (source(name), *headers):
        digest.update(src.encode())
        with open(os.path.join(CSRC, src), "rb") as fh:
            digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = (*ENTRY_POINTS, *GLUE_POINTS),
          extra_flags: Iterable[str] = ()) -> Dict[str, str]:
    """Compiles every named kernel whose library is missing, one nvcc
    process per source, all started together.  Returns nvcc's output of
    each build, by kernel; raises with it when any build fails."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [_nvcc(), *NVCC_FLAGS, *extra_flags, "-o", tmp,
               os.path.join(CSRC, source(name))]
        jobs.append((name, out, tmp, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    logs, failed = {}, []
    for name, out, tmp, proc in jobs:
        logs[name] = proc.communicate()[0].decode(errors="replace")
        if proc.returncode:
            failed.append(f"{source(name)}:\n{logs[name]}")
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return logs


def _function(name: str, symbol: str, argtypes):
    with _lock:
        fn = _loaded.get(symbol)
        if fn is None:
            path = library_path(name)
            if not os.path.exists(path):
                build([name])
            # the first CDLL of a library loads it; a later one of the
            # same path takes the same handle
            trace.memory(f"kernel.load.{name}.enter", once=True)
            lib = ctypes.CDLL(path)
            trace.memory(f"kernel.load.{name}.exit", once=True)
            fn = getattr(lib, symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _loaded[symbol] = fn
    return fn


def entry_point(name: str, route: str = "score"):
    """The C launch function of the kernel's route (route "glue" for a
    glue kernel), building its library if needed."""
    if route == "glue":
        return _function(name, *GLUE_POINTS[name][1:])
    return _function(name, *ROUTE_POINTS.get((name, route),
                                             ENTRY_POINTS[name]))


def grid_info(name: str, B: int, H: int, R: int, lanes: int,
              device: int = 0, route: str = "score"
              ) -> Tuple[int, int, int, int, int]:
    """(blocks, blocks resident per SM, SMs, hap rows a block, dynamic
    shared bytes a block) of the launch of a kernel's route on B rows of
    H x R cells on card `device`."""
    symbol = GRID_POINTS[name] if route == "score" else \
        f"{ROUTE_POINTS[name, route][0]}_grid"
    fn = _function(name, symbol, [_I] * 5 + [_P])
    out = (ctypes.c_int * 5)()
    err = fn(B, H, R, lanes, device, out)
    if err:
        raise RuntimeError(f"{name} grid query failed: CUDA error {err}")
    return tuple(out)
