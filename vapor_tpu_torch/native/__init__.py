"""ctypes loader for the native BAM codec (bamcodec.cpp).

The codec is built with g++ at first use into BUILD_DIR, under a name
that carries a hash of the flags and the source, so an edited source is
rebuilt and an unchanged one reused.  g++ writes a per-process temporary
file that ``os.replace`` moves into place: processes that build at once
(scatter shards, distributed ranks) never load a half-written library.
Nothing here runs at import time.  When the codec cannot be built or
loaded, ``load`` returns None and ``LOAD_ERROR`` says why; callers then
decode in Python (io/bam.py says which decoder a reader used).
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_HERE, "bamcodec.cpp")
BUILD_DIR = os.path.join(_HERE, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC")
LIBS = ("-lz",)

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
LOAD_ERROR: Optional[str] = None


def library_path() -> str:
    digest = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    with open(SRC, "rb") as fh:
        digest.update(fh.read())
    return os.path.join(BUILD_DIR, f"bamcodec-{digest.hexdigest()[:16]}.so")


def _build(out: str) -> None:
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(["g++", *CXX_FLAGS, SRC, "-o", tmp, *LIBS],
                          capture_output=True, text=True, timeout=120)
    if proc.returncode:
        raise RuntimeError(f"g++ exited {proc.returncode}:\n{proc.stderr}")
    os.replace(tmp, out)


def load() -> Optional[ctypes.CDLL]:
    """The compiled codec, built on demand; None if unavailable."""
    global _lib, LOAD_ERROR
    with _lock:
        if _lib is not None or LOAD_ERROR is not None:
            return _lib
        path = library_path()
        try:
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except (OSError, RuntimeError, subprocess.SubprocessError) as exc:
            LOAD_ERROR = f"{type(exc).__name__}: {exc}"
            return None
        lib.vapor_bgzf_decompress.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.vapor_bgzf_decompress.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t,
            ctypes.POINTER(ctypes.c_size_t)]
        lib.vapor_bam_query.restype = ctypes.c_void_p
        lib.vapor_bam_query.argtypes = [
            ctypes.c_char_p, ctypes.c_size_t, ctypes.c_size_t,
            ctypes.c_int32, ctypes.c_int64, ctypes.c_int64]
        lib.vapor_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def bgzf_decompress(data: bytes) -> Optional[bytes]:
    """The inflated payload of a whole BGZF file; None if the codec is
    unavailable or the data is not BGZF."""
    lib = load()
    if lib is None:
        return None
    out_len = ctypes.c_size_t()
    ptr = lib.vapor_bgzf_decompress(data, len(data), ctypes.byref(out_len))
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr, out_len.value)
    finally:
        lib.vapor_free(ptr)


def bam_query(decompressed: bytes, records_start: int, ref_id: int,
              beg0: int, end0: int) -> Optional[str]:
    """Records of ref_id overlapping [beg0, end0), one tab-separated line
    each (name, flag, pos0, mapq, cigar, seq), in file order; None if
    the codec is unavailable or the query failed."""
    lib = load()
    if lib is None:
        return None
    ptr = lib.vapor_bam_query(decompressed, len(decompressed),
                              records_start, ref_id, beg0, end0)
    if not ptr:
        return None
    try:
        return ctypes.string_at(ptr).decode("ascii")
    finally:
        lib.vapor_free(ptr)
