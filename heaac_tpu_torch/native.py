"""The native C++ stream parser, built from the JAX package's sources.

The port does not import ``heaac_tpu.native`` (importing anything under
``heaac_tpu`` loads jax).  It compiles ``heaac_tpu/native/aac_host.cc``
by path, with the same g++ flags, into its own build directory and binds
the entry points the decoders call: the HE qwire parser (and the
two-frame probe ``decode_batch`` buckets by) and the whole-stream LC
parser (``heaac_tpu/native/__init__.py`` parse_stream, probe_he_stream).
The library is rebuilt when ``aac_host.cc`` or either file it includes
is newer.  The parser keeps static state: one native call at a time.
"""
from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import time

import numpy as np

from . import tables as TB
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
    """ctypes binding of ``hh_parse_he_stream_qwire`` (he_host.inc) and
    ``ht_parse_stream`` (aac_host.cc)."""

    def __init__(self):
        build()
        L = ctypes.CDLL(SO)
        i32p = ctypes.POINTER(ctypes.c_int32)
        L.ht_init.restype = ctypes.c_int
        L.ht_parse_stream.restype = ctypes.c_int
        L.ht_parse_stream.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, i32p,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float), i32p, ctypes.c_int]
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

    def probe(self, data: bytes, hdr):
        """Native parse of the first two frames (spectra length-walked,
        nothing kept) -> dict(lanes, sbr, is34), or None when the stream
        needs the Python prober (probe_he_stream)."""
        C = ctypes
        heap = np.zeros(1 << 16, np.uint8)
        recs = np.zeros((2, 8, 4), np.int32)
        info = np.zeros(8, np.int32)
        cur = C.c_int64(0)
        r = self.parse_qwire(
            data, min(len(data), 1 << 14), hdr.sampling_index,
            hdr.sample_rate, hdr.chan_config,
            heap.ctypes.data_as(C.POINTER(C.c_uint8)), heap.nbytes,
            C.byref(cur), recs.ctypes.data_as(C.POINTER(C.c_int32)), 2, 8,
            0, info.ctypes.data_as(C.POINTER(C.c_int32)), None, None, 0)
        if r < 0:
            return None
        return dict(lanes=int(info[0]), sbr=int(info[1]), is34=int(info[2]))

    def parse_stream(self, data: bytes, sampling_index: int, layout,
                     max_frames: int):
        """Whole-stream LC parse (ADTS framing, element loop, dequant,
        TNS) of a plain layout [(etype, tag), ...] in lane order ->
        (coeffs [T, lanes, 1024] f32, meta [T, lanes, 8] i32: ws, wsp,
        kbd, kbdp, ...), or None when the stream needs the Python
        planner (PCE / CCE / SSR)."""
        C = ctypes
        lane_base = np.full(128, -1, np.int32)
        n_lanes = 0
        for etype, tag in layout:
            lane_base[(etype << 4) | tag] = n_lanes
            n_lanes += 2 if etype == TB.TYPE_CPE else 1
        coeffs = np.zeros((max_frames, n_lanes, 1024), np.float32)
        meta = np.zeros((max_frames, n_lanes, 8), np.int32)
        r = self.lib.ht_parse_stream(
            data, len(data), sampling_index,
            lane_base.ctypes.data_as(C.POINTER(C.c_int32)), n_lanes,
            coeffs.ctypes.data_as(C.POINTER(C.c_float)),
            meta.ctypes.data_as(C.POINTER(C.c_int32)), max_frames)
        if r < 0:
            return None
        return coeffs[:r], meta[:r]
