"""The native C++ stream parser, built from the JAX package's sources.

The port does not import ``heaac_tpu.native`` (importing anything under
``heaac_tpu`` loads jax).  It compiles ``heaac_tpu/native/aac_host.cc``
by path, with the same g++ flags, into its own build directory and binds
the entry points the decoders call: the HE qwire parser (and the
two-frame probe ``decode_batch`` buckets by), the whole-stream LC
parser, the single-stream Decoder's per-element SCE / CPE parsers and
the HE plan-record parsers of the plan decoders (dense, compact and
compact strided; ``heaac_tpu/native/__init__.py`` parse_stream,
probe_he_stream, parse_sce, parse_cpe, parse_he_stream,
parse_he_stream_compact[_into], with _field_size and _unpack).  The
packed sink ``hh_parse_he_stream_packed`` stays in the library unbound:
no decoder of the port reads packed records.  The parser is always
built: a build or load failure raises.
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
from .bitstream.reader import BitstreamError
from .tables import REPO
from .utils.trace import count

SRC_DIR = os.path.join(REPO, "heaac_tpu", "native")
BUILD_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                         "_build")
SO = os.path.join(BUILD_DIR, "libaachost.so")
DEPS = ("aac_host.cc", "he_host.inc", "tables.inc")
CXXFLAGS = ["-O3", "-march=native", "-ffp-contract=off", "-fno-math-errno",
            "-fPIC", "-shared", "-std=c++17"]
EDGE_MAX = 24   # AFTER_IMDCT coupling edges per stream (he_host.inc)
# output lanes per channel config (config 7 has 8 channels; config 0's
# layout arrives in-band and is not known before the parse)
LANES_FOR_CONFIG = {1: 1, 2: 2, 3: 3, 4: 4, 5: 5, 6: 6, 7: 8}

# the dense plan records of hh_parse_he_stream; must match PlanF / PlanI /
# PsPlanF in he_host.inc
PLAN_F_FIELDS = [
    ("start", ()), ("gain_num", (5, 48)), ("den_q", (5, 48)),
    ("e_orig", (5, 48)), ("q_m0", (5, 48)), ("s_m0", (5, 48)),
    ("noisegate", (5, 48)), ("lim_onehot", (28, 48)), ("limgain", ()),
    ("env_onehot", (5, 38)), ("recip", (5,)), ("bw_of_m", (48,)),
    ("hf_mask", (48,)), ("gen_slot_mask", (40,)), ("fill_map", (42, 5)),
    ("smooth_on", (38,)), ("sine_re", (38,)), ("sine_im0", (38,)),
    ("grp_mean", (2, 48, 48)), ("freqres_sel", (5,)),
    ("use_y_old", (64,)), ("use_y_new", (64,)), ("xlow_old", (64,)),
    ("xlow_new", (64,)), ("scatter_m", (48, 64)),
]
PLAN_I_FIELDS = [
    ("src_of_m", (48,)), ("row_src", (42,)), ("direct_row", (38,)),
    ("noise_start", (38,)), ("i_temp", ()),
]
PS_F_FIELDS = [
    ("ps_on", ()), ("H", (2, 6, 34, 4)), ("Ws", (6, 32)), ("We", (6, 32)),
    ("ipd_on", ()), ("top_mask", (91,)),
]


def _field_size(shape) -> int:
    n = 1
    for s in shape:
        n *= s
    return n


PLAN_F_N = sum(_field_size(s) for _, s in PLAN_F_FIELDS)
PLAN_I_N = sum(_field_size(s) for _, s in PLAN_I_FIELDS)
PS_F_N = sum(_field_size(s) for _, s in PS_F_FIELDS)


def _unpack(buf, fields) -> dict:
    """buf [T, L, N] -> {name: [T, L, *shape] view}."""
    out = {}
    off = 0
    for name, shape in fields:
        n = _field_size(shape)
        out[name] = buf[:, :, off:off + n].reshape(
            buf.shape[0], buf.shape[1], *shape)
        off += n
    return out


def _info(info) -> dict:
    return dict(lanes=int(info[0]), sbr=int(info[1]), is34=int(info[2]),
                err_frames=int(info[3]))


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
        dt = time.perf_counter() - t0
        count("build_s", dt)
        return dt


def build() -> float:
    """Compile the parser library if it is missing or stale."""
    return compile_if_stale(
        SO, [os.path.join(SRC_DIR, f) for f in DEPS],
        ["g++", *CXXFLAGS, os.path.join(SRC_DIR, "aac_host.cc")])


def available() -> bool:
    """True: the parser library builds and loads (a failure raises, as
    the port always has its parser).  The plan decoders' native routes
    ask it, as in the JAX package, so a test can set it False to force
    their Python routes."""
    Parser()
    return True


class Parser:
    """ctypes binding of ``hh_parse_he_stream_qwire`` and
    ``hh_parse_he_stream[_compact[_strided]]`` (he_host.inc),
    ``ht_parse_stream``, ``ht_parse_sce`` and ``ht_parse_cpe``
    (aac_host.cc)."""

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
        f32p = ctypes.POINTER(ctypes.c_float)
        i64p = ctypes.POINTER(ctypes.c_int64)
        u32p = ctypes.POINTER(ctypes.c_uint32)
        L.ht_parse_sce.restype = ctypes.c_int
        L.ht_parse_sce.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p,
                                   ctypes.c_int, f32p, i32p, u32p,
                                   ctypes.c_int]
        L.ht_parse_cpe.restype = ctypes.c_int
        L.ht_parse_cpe.argtypes = [ctypes.c_char_p, ctypes.c_int64, i64p,
                                   ctypes.c_int, f32p, f32p, i32p, i32p,
                                   u32p, ctypes.c_int]
        i8p = ctypes.POINTER(ctypes.c_int8)
        c_int, c_i64 = ctypes.c_int, ctypes.c_int64
        head = [ctypes.c_char_p, c_i64, c_int, c_int, c_int]
        L.hh_parse_he_stream.restype = c_int
        L.hh_parse_he_stream.argtypes = head + [f32p, i32p, f32p, i32p,
                                                f32p, c_int, i32p]
        L.hh_parse_he_stream_compact.restype = c_int
        L.hh_parse_he_stream_compact.argtypes = head + [
            f32p, i32p, i32p, i8p, f32p, i32p, i8p, c_int, i32p]
        L.hh_parse_he_stream_compact_strided.restype = c_int
        L.hh_parse_he_stream_compact_strided.argtypes = head + [
            f32p, i32p, i32p, i8p, f32p, i32p, i8p, c_int, c_i64, c_i64,
            i32p]
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

    def parse_sce(self, data: bytes, pos_bits: int, sampling_index: int,
                  rng_state: int, apply_tns: bool = True):
        """Native SCE parse -> (coeffs[1024] f32, meta [16] i32, new_pos,
        new_rng), or None if the element needs the Python parser (-2,
        e.g. a predictor-carrying ics_info); BitstreamError on any other
        failure."""
        C = ctypes
        coeffs = np.zeros(1024, np.float32)
        meta = np.zeros(16, np.int32)
        pos = C.c_int64(pos_bits)
        rng = C.c_uint32(rng_state & 0xFFFFFFFF)
        r = self.lib.ht_parse_sce(
            data, len(data) * 8, C.byref(pos), sampling_index,
            coeffs.ctypes.data_as(C.POINTER(C.c_float)),
            meta.ctypes.data_as(C.POINTER(C.c_int32)), C.byref(rng),
            int(apply_tns))
        if r == -2:
            return None
        if r:
            raise BitstreamError(f"native SCE parse failed ({r})")
        return coeffs, meta, pos.value, rng.value

    def parse_cpe(self, data: bytes, pos_bits: int, sampling_index: int,
                  rng_state: int, apply_tns: bool = True):
        """Native CPE parse -> ((coeffs0, coeffs1), (meta0, meta1),
        new_pos, new_rng), or None / BitstreamError as ``parse_sce``."""
        C = ctypes
        c0, c1 = np.zeros(1024, np.float32), np.zeros(1024, np.float32)
        m0, m1 = np.zeros(16, np.int32), np.zeros(16, np.int32)
        pos = C.c_int64(pos_bits)
        rng = C.c_uint32(rng_state & 0xFFFFFFFF)
        fp = lambda a: a.ctypes.data_as(C.POINTER(C.c_float))  # noqa: E731
        ip = lambda a: a.ctypes.data_as(C.POINTER(C.c_int32))  # noqa: E731
        r = self.lib.ht_parse_cpe(
            data, len(data) * 8, C.byref(pos), sampling_index, fp(c0),
            fp(c1), ip(m0), ip(m1), C.byref(rng), int(apply_tns))
        if r == -2:
            return None
        if r:
            raise BitstreamError(f"native CPE parse failed ({r})")
        return (c0, c1), (m0, m1), pos.value, rng.value

    # ---- HE plan records (the plan decoders, codec/planner.py) ----------
    @staticmethod
    def _ptrs(*arrays) -> list:
        """ctypes pointers to C-contiguous numpy arrays, by dtype."""
        C = ctypes
        kind = {np.dtype(np.float32): C.c_float, np.dtype(np.int32): C.c_int32,
                np.dtype(np.int8): C.c_int8, np.dtype(np.uint32): C.c_uint32}
        out = []
        for a in arrays:
            if not a.flags.c_contiguous:
                raise ValueError("native parse buffers must be C-contiguous")
            out.append(a.ctypes.data_as(C.POINTER(kind[a.dtype])))
        return out

    @staticmethod
    def _fits(chan_config: int, lane0: int, stride: int, max_frames: int,
              T: int) -> bool:
        """Whether a strided plan parse of a stream of ``chan_config``
        stays inside [T, stride] buffers from lane ``lane0`` on; raises
        where the caller's lane or frame range is out of them.  False for
        channel config 0: the C plan sinks have no lane bound (the qwire
        sink has), and a PCE may carry more lanes than the row has room
        for, so such a stream goes to the Python planner."""
        nl = LANES_FOR_CONFIG.get(chan_config)
        if nl is None:
            return False
        if lane0 < 0 or lane0 + nl > stride or not 0 < max_frames <= T:
            raise ValueError(f"lanes {lane0}..{lane0 + nl} x {max_frames} "
                             f"frames outside buffers of [{T}, {stride}]")
        return True

    def parse_he_stream(self, data: bytes, sampling_index: int,
                        core_rate: int, chan_config: int, max_frames: int):
        """Whole-stream HE parse into the dense plans: (core dict, sbr plan
        dict, ps plan dict, info dict) with [T, L, ...] leaves, or None
        when the stream needs the Python planner."""
        nl = LANES_FOR_CONFIG.get(chan_config)
        if nl is None:
            return None   # config 0: lane count unknown before the parse
        coeffs = np.zeros((max_frames, nl, 1024), np.float32)
        meta = np.zeros((max_frames, nl, 8), np.int32)
        planf = np.zeros((max_frames, nl, PLAN_F_N), np.float32)
        plani = np.zeros((max_frames, nl, PLAN_I_N), np.int32)
        psf = np.zeros((max_frames, nl, PS_F_N), np.float32)
        info = np.zeros(4, np.int32)
        p = self._ptrs(coeffs, meta, planf, plani, psf, info)
        r = self.lib.hh_parse_he_stream(
            data, len(data), sampling_index, core_rate, chan_config,
            *p[:5], max_frames, p[5])
        if r < 0:
            return None
        core = dict(coeffs=coeffs[:r], ws=meta[:r, :, 0], wsp=meta[:r, :, 1],
                    kbd=meta[:r, :, 2], kbdp=meta[:r, :, 3])
        sbr = _unpack(planf[:r], PLAN_F_FIELDS)
        sbr.update(_unpack(plani[:r], PLAN_I_FIELDS))
        return core, sbr, _unpack(psf[:r], PS_F_FIELDS), _info(info)

    def parse_he_stream_compact(self, data: bytes, sampling_index: int,
                                core_rate: int, chan_config: int,
                                max_frames: int):
        """Whole-stream HE parse into the compact records
        (``codec/compact_plan.py`` SC_* / PC_* layout): (core dict, sbr
        dict sc_i / sc_b / sc_f, ps dict pc_i / pc_b, info dict) with
        [T, L, ...] leaves, or None for the Python planner."""
        from .codec import compact_plan as cp
        nl = LANES_FOR_CONFIG.get(chan_config)
        if nl is None:
            return None
        bufs = dict(
            coeffs=np.zeros((max_frames, nl, 1024), np.float32),
            meta=np.zeros((max_frames, nl, 8), np.int32),
            sc_i=np.zeros((max_frames, nl, cp.SC_I_N), np.int32),
            sc_b=np.zeros((max_frames, nl, cp.SC_B_N), np.int8),
            sc_f=np.zeros((max_frames, nl, cp.SC_F_N), np.float32),
            pc_i=np.zeros((max_frames, nl, cp.PC_I_N), np.int32),
            pc_b=np.zeros((max_frames, nl, cp.PC_B_N), np.int8))
        info = np.zeros(4, np.int32)
        p = self._ptrs(*bufs.values(), info)
        r = self.lib.hh_parse_he_stream_compact(
            data, len(data), sampling_index, core_rate, chan_config,
            *p[:7], max_frames, p[7])
        if r < 0:
            return None
        b = {k: v[:r] for k, v in bufs.items()}
        meta = b["meta"]
        core = dict(coeffs=b["coeffs"], ws=meta[:, :, 0], wsp=meta[:, :, 1],
                    kbd=meta[:, :, 2], kbdp=meta[:, :, 3])
        return (core, dict(sc_i=b["sc_i"], sc_b=b["sc_b"], sc_f=b["sc_f"]),
                dict(pc_i=b["pc_i"], pc_b=b["pc_b"]), _info(info))

    def parse_he_stream_compact_into(self, data: bytes, sampling_index: int,
                                     core_rate: int, chan_config: int,
                                     bufs: dict, lane0: int,
                                     max_frames: int):
        """Strided compact parse: a stream's lanes go straight into the
        [T, L_total, ...] arrays of ``bufs`` (coeffs, meta, sc_i, sc_b,
        sc_f, pc_i, pc_b) from lane ``lane0`` on.  -> (frames, info dict),
        or None for the Python planner."""
        keys = ("coeffs", "meta", "sc_i", "sc_b", "sc_f", "pc_i", "pc_b")
        T, stride = bufs["coeffs"].shape[:2]
        for k in keys:
            if bufs[k].shape[:2] != (T, stride):
                raise ValueError(f"bufs[{k!r}] is {bufs[k].shape[:2]}, "
                                 f"not {(T, stride)}")
        if not self._fits(chan_config, lane0, stride, max_frames, T):
            return None
        info = np.zeros(4, np.int32)
        p = self._ptrs(*(bufs[k] for k in keys), info)
        r = self.lib.hh_parse_he_stream_compact_strided(
            data, len(data), sampling_index, core_rate, chan_config,
            *p[:7], max_frames, stride, lane0, p[7])
        if r < 0:
            return None
        return r, _info(info)
