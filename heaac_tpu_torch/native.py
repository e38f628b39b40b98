"""The native C++ stream parser, built from the JAX package's sources.

The port does not import ``heaac_tpu.native`` (importing anything under
``heaac_tpu`` loads jax).  It compiles ``heaac_tpu/native/aac_host.cc``
by path, with the same g++ flags, into its own build directory and binds
the two entry points the qwire path calls.  The library is rebuilt when
``aac_host.cc`` or either file it includes is newer.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import time

from .tables import REPO

SRC_DIR = os.path.join(REPO, "heaac_tpu", "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SO = os.path.join(BUILD_DIR, "libaachost.so")
DEPS = ("aac_host.cc", "he_host.inc", "tables.inc")
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno",
            "-fPIC", "-shared", "-std=c++17"]
EDGE_MAX = 24   # AFTER_IMDCT coupling edges per stream (he_host.inc)


def compile_if_stale(so: str, deps, cmd) -> float:
    """Run ``cmd + ["-o", tmp]`` and move tmp to ``so`` if ``so`` is
    missing or older than any path in ``deps``; returns the seconds spent
    compiling (0 when it was current).  A file lock serialises concurrent
    compiles (test workers), and the rename means no process ever loads
    a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(so + ".lock", "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        if os.path.exists(so) and os.path.getmtime(so) >= max(
                os.path.getmtime(d) for d in deps):
            return 0.0
        t0 = time.perf_counter()
        tmp = f"{so}.{os.getpid()}.tmp"
        subprocess.run([*cmd, "-o", tmp], check=True)
        os.replace(tmp, so)
        return time.perf_counter() - t0


def build() -> float:
    """Compile the parser library if it is missing or stale."""
    return compile_if_stale(
        SO, [os.path.join(SRC_DIR, f) for f in DEPS],
        ["g++", *CXXFLAGS, os.path.join(SRC_DIR, "aac_host.cc")])


class Parser:
    """ctypes binding of ``hh_parse_he_stream_qwire`` (he_host.inc)."""

    def __init__(self):
        build()
        L = ctypes.CDLL(SO)
        i32p = ctypes.POINTER(ctypes.c_int32)
        L.ht_init.restype = ctypes.c_int
        L.hh_parse_he_stream_qwire.restype = ctypes.c_int
        L.hh_parse_he_stream_qwire.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int64), i32p, ctypes.c_int,
            ctypes.c_int64, ctypes.c_int64, i32p, i32p,
            ctypes.POINTER(ctypes.c_float), ctypes.c_int]
        L.ht_init()
        self.lib = L
        self.parse_qwire = L.hh_parse_he_stream_qwire
