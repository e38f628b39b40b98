"""Parametric-stereo transient detector + allpass chain (kernel K1).

The two serial recurrences of the PS decorrelator (aacps.c:681-735): per
lane, 32 QMF slots in order, carrying the transient detector's peak /
smoothed power / smoothed peak-minus-power per parameter band and the
3-link allpass ring per allpass band.

On a CUDA tensor ``decorrelate_seq`` launches the hand-written kernel in
``csrc/ps_decorrelate.cu``, which replaces the TPU kernel
``heaac_tpu/ops/ps_pallas.py:_kernel``; its design and what bounds it on
the card are in that file's header.  On a CPU tensor it runs
``decorrelate_plain``, the PyTorch port of the JAX reference's scan pair
(``ps_jax._decorrelate_scans``).  There is no other route: a CUDA tensor
never falls back to the plain version.

Contract (ps_pallas.decorrelate_seq): power [B,34,32], in_re/in_im
[B,napb,32], trans [B,34,3], ap [B,napb,3,5,2], ag [napb,3],
qf [napb,3,2] -> (tgain [B,32,34], ap_out [B,napb,32,2],
new_trans [B,34,3], new_ap [B,napb,3,5,2]), all f32 and contiguous;
on the card power, in_re, in_im and ap also start 16-byte aligned.

The kernel's launch geometry (lanes per CTA, the two roles' thread
counts, the shared-memory layout) is computed here by ``geometry`` and
passed to the launcher; ``work_items`` and ``copies`` restate the
kernel's index arithmetic so that the CPU tests can check it.
"""
from __future__ import annotations

import ctypes
import functools
import os
import shutil

import numpy as np
import torch

from .. import tables as TB
from ..native import BUILD_DIR, compile_if_stale
from ..utils.trace import span

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "ps_decorrelate.cu")
SO = os.path.join(BUILD_DIR, "libps_decorrelate.so")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "--fmad=false", "-shared", "-Xcompiler", "-fPIC"]

# kernel launches made by decorrelate_seq, by napb (30: the 20-band PS
# path, 50: the 34-band path); callers that count reset them
launches = {30: 0, 50: 0}

_PEAK = float(TB.PEAK_DECAY_FACTOR)
_ASM = float(TB.A_SMOOTH)
_TI = float(TB.TRANSIENT_IMPACT)
_LD = [5 - int(d) for d in TB.LINK_DELAY]


def decorrelate_plain(power, in_re, in_im, trans, ap, ag, qf):
    """Plain PyTorch version: one step per QMF slot (the JAX scan pair,
    each mul and add a separate rounded op)."""
    pk, psm, pdd = trans[..., 0], trans[..., 1], trans[..., 2]
    tg = []
    for n in range(32):
        pn = power[:, :, n]
        pk = torch.maximum(_PEAK * pk, pn)
        psm = psm + _ASM * (pn - psm)
        pdd = pdd + _ASM * (pk - pn - pdd)
        denom = _TI * pdd
        tg.append(torch.where(
            denom > psm, psm / torch.where(denom != 0, denom, 1.0), 1.0))
    tgain = torch.stack(tg, 1)                                  # [B,32,34]
    new_trans = torch.stack([pk, psm, pdd], -1)

    buf = ap
    outs = []
    for n in range(32):
        o_re, o_im = in_re[:, :, n], in_im[:, :, n]
        cols = []
        for m in range(3):
            ld_re = buf[:, :, m, _LD[m], 0]
            ld_im = buf[:, :, m, _LD[m], 1]
            am = ag[None, :, m]
            a_re = am * o_re
            a_im = am * o_im
            n_re = ld_re * qf[None, :, m, 0] - ld_im * qf[None, :, m, 1] \
                - a_re
            n_im = ld_re * qf[None, :, m, 1] + ld_im * qf[None, :, m, 0] \
                - a_im
            cols.append(torch.stack([o_re + am * n_re, o_im + am * n_im],
                                    -1))
            o_re, o_im = n_re, n_im
        buf = torch.cat([buf[:, :, :, 1:],
                         torch.stack(cols, 2)[:, :, :, None]], 3)
        outs.append(torch.stack([o_re, o_im], -1))
    return tgain, torch.stack(outs, 2), new_trans, buf


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the PS decorrelation kernel cannot "
                       "be built")


def build(extra_flags=()) -> float:
    """Compile the kernel library if missing or older than its source
    (``extra_flags`` go to nvcc, e.g. ``("-Xptxas", "-v")``); returns the
    seconds spent compiling (0 when current)."""
    return compile_if_stale(SO, [SRC],
                            [_nvcc(), *NVCC_FLAGS, *extra_flags, SRC])


# ---- launch geometry (csrc/ps_decorrelate.cu, "Design") ---------------------
LANES_PER_CTA = 2
# Staged row pitches in floats: an odd number of float4s, so the float4s
# that 8 consecutive threads read or write at one column fall in 8
# different shared-memory bank groups.
IN_PITCH = 36     # 32-float rows of power, in_re, in_im
OUT_PITCH = 68    # 64-float rows of ap_out
SMEM_MAX = 232_448          # dynamic shared memory one Hopper block may use
_RING = 30                  # floats of allpass ring per band
_STEP = 16                  # slots per pipeline step (kStep)


class Geometry(ctypes.Structure):
    """The kernel's ``Geometry`` (same fields, same order): lanes per
    CTA, the two roles' thread counts, the staged row pitches (floats),
    the byte offset of each shared-memory region (new_ap reuses ``ap``)
    and the dynamic shared memory in bytes."""
    _fields_ = [(f, ctypes.c_int) for f in (
        "lanes", "det_threads", "chain_threads", "in_pitch", "out_pitch",
        "power", "in_re", "in_im", "ap", "tgain", "ap_out", "smem")]


def _warps(threads: int) -> int:
    return -(-threads // 32) * 32


@functools.cache
def geometry(napb: int) -> Geometry:
    """Block and shared-memory layout of one CTA of LANES_PER_CTA
    lanes."""
    lanes = LANES_PER_CTA
    regions = (("power", 34 * IN_PITCH), ("in_re", napb * IN_PITCH),
               ("in_im", napb * IN_PITCH), ("ap", napb * _RING),
               ("tgain", 32 * 34), ("ap_out", napb * OUT_PITCH))
    off, offsets = 0, {}
    for name, floats in regions:
        offsets[name] = off
        off += -(-lanes * floats * 4 // 16) * 16
    return Geometry(lanes=lanes, det_threads=_warps(lanes * 34),
                    chain_threads=_warps(lanes * napb), in_pitch=IN_PITCH,
                    out_pitch=OUT_PITCH, smem=off, **offsets)


def grid(B: int, geo: Geometry) -> int:
    return -(-B // geo.lanes)


def work_items(B: int, napb: int):
    """(role, lane, band) computed by every thread of a launch, by the
    kernel's index arithmetic (for the tests; the kernel cannot run on
    the CPU)."""
    geo = geometry(napb)
    for cta in range(grid(B, geo)):
        b0 = cta * geo.lanes
        g = min(geo.lanes, B - b0)
        for t in range(geo.det_threads + geo.chain_threads):
            u = t - geo.det_threads
            if t < geo.det_threads:
                if t < g * 34:
                    yield "detector", b0 + t // 34, t % 34
            elif u < g * napb:
                yield "chain", b0 + u // napb, u % napb


def copies(B: int, napb: int):
    """Every 16-byte-chunked copy of a launch, one per piece of a row:
    (array, byte offset in the array, byte offset in shared memory,
    bytes), by the kernel's index arithmetic (for the tests).  Rows of
    32 slots go in pieces of ``_STEP`` slots, one per pipeline step."""
    geo = geometry(napb)
    h = _STEP
    steps = tuple(range(0, 32, h))
    # array, region, rows per lane, floats per piece, global row pitch,
    # shared row pitch, the pieces' first floats
    rows = (("power", "power", 34, h, 32, geo.in_pitch, steps),
            ("in_re", "in_re", napb, h, 32, geo.in_pitch, steps),
            ("in_im", "in_im", napb, h, 32, geo.in_pitch, steps),
            ("ap", "ap", napb * _RING // 4, 4, 4, 4, (0,)),
            ("tgain", "tgain", 1, h * 34, 32 * 34, 32 * 34,
             tuple(n * 34 for n in steps)),
            ("ap_out", "ap_out", napb, 2 * h, 64, geo.out_pitch,
             tuple(2 * n for n in steps)),
            ("new_ap", "ap", napb * _RING // 4, 4, 4, 4, (0,)))
    for cta in range(grid(B, geo)):
        b0 = cta * geo.lanes
        g = min(geo.lanes, B - b0)
        for array, region, per_lane, width, gp, sp, cols in rows:
            for r in range(g * per_lane):
                for col in cols:
                    yield (array, 4 * ((b0 * per_lane + r) * gp + col),
                           getattr(geo, region) + 4 * (r * sp + col),
                           4 * width)


@functools.cache
def _lib():
    build()
    L = ctypes.CDLL(SO)
    vp, i32 = ctypes.c_void_p, ctypes.c_int
    L.ps_decorrelate_launch.restype = i32
    L.ps_decorrelate_launch.argtypes = [vp] * 11 + [i32] * 3 + [Geometry, vp]
    L.ps_decorrelate_ctas_per_sm.restype = i32
    L.ps_decorrelate_ctas_per_sm.argtypes = [i32, i32]
    return L


def ctas_per_sm(napb: int, device=None) -> int:
    """CTAs of the kernel one SM of ``device`` (the current card when
    None) holds at napb's geometry (the CUDA occupancy calculator; -1 on
    an error)."""
    geo = geometry(napb)
    with torch.cuda.device(device):
        return _lib().ps_decorrelate_ctas_per_sm(
            geo.det_threads + geo.chain_threads, geo.smem)


_STAGED = ("power", "in_re", "in_im", "ap")


def _check(name, t, shape, device):
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: expected float32, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if name in _STAGED and t.data_ptr() % 16:
        raise ValueError(f"{name}: the kernel stages it with 16-byte copies"
                         " and needs a 16-byte aligned start")


def decorrelate_seq(power, in_re, in_im, trans, ap, ag, qf):
    """K1: the plain version for CPU tensors, the CUDA kernel for CUDA
    tensors (raises on anything the kernel does not take)."""
    dev = power.device
    if dev.type == "cpu":
        with span("k1", napb=in_re.shape[1]):
            return decorrelate_plain(power, in_re, in_im, trans, ap, ag, qf)
    if dev.type != "cuda":
        raise ValueError(f"decorrelate_seq: unsupported device {dev}")
    B, napb = power.shape[0], in_re.shape[1]
    if napb not in (30, 50):
        raise ValueError(f"decorrelate_seq: napb {napb} not in (30, 50)")
    for name, t, shape in (
            ("power", power, (B, 34, 32)), ("in_re", in_re, (B, napb, 32)),
            ("in_im", in_im, (B, napb, 32)), ("trans", trans, (B, 34, 3)),
            ("ap", ap, (B, napb, 3, 5, 2)), ("ag", ag, (napb, 3)),
            ("qf", qf, (napb, 3, 2))):
        _check(name, t, shape, dev)
    tgain = torch.empty((B, 32, 34), dtype=torch.float32, device=dev)
    ap_out = torch.empty((B, napb, 32, 2), dtype=torch.float32, device=dev)
    new_trans = torch.empty((B, 34, 3), dtype=torch.float32, device=dev)
    new_ap = torch.empty((B, napb, 3, 5, 2), dtype=torch.float32, device=dev)
    geo = geometry(napb)
    # the launcher raises the shared-memory limit on, and launches from,
    # the CUDA runtime's current device: make it the tensors' card
    with torch.cuda.device(dev), span("k1", napb=napb):
        rc = _lib().ps_decorrelate_launch(
            power.data_ptr(), in_re.data_ptr(), in_im.data_ptr(),
            trans.data_ptr(), ap.data_ptr(), ag.data_ptr(), qf.data_ptr(),
            tgain.data_ptr(), ap_out.data_ptr(), new_trans.data_ptr(),
            new_ap.data_ptr(), B, napb, grid(B, geo), geo,
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"ps_decorrelate kernel launch failed: CUDA "
                           f"error {rc}")
    launches[napb] += 1
    return tgain, ap_out, new_trans, new_ap


def random_inputs(B: int, napb: int, seed: int = 0):
    """numpy inputs of the kernel contract at (B, napb), drawn from a
    seed as tests/test_ps_pallas.py draws them, plus the band mode's
    ag/qf constants."""
    rng = np.random.default_rng(seed)
    c = TB.ps_consts(1 if napb == 50 else 0)
    f = np.float32
    return dict(
        power=np.abs(rng.standard_normal((B, 34, 32))).astype(f),
        in_re=rng.standard_normal((B, napb, 32)).astype(f),
        in_im=rng.standard_normal((B, napb, 32)).astype(f),
        trans=np.abs(rng.standard_normal((B, 34, 3))).astype(f),
        ap=(rng.standard_normal((B, napb, 3, 5, 2)) * 0.1).astype(f),
        ag=c["ag"], qf=c["qf"])
