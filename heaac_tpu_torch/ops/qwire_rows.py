"""The qwire frame step's Huffman row decoders, both in one launch.

``qwire.expand_frame`` decodes each lane's raw SBR rows
(``sbr_huff.decode_sbr_rows``) and its PS region
(``ps_huff.decode_ps_region``) every frame step.  On CUDA tensors
``decode_rows`` runs both in the hand-written kernel of
``csrc/qwire_rows.cu``, one thread per (lane, region) reading the bits
serially; its design and what bounds it are in that file's header.  On
CPU tensors it runs the two plain functions, which the kernel equals bit
for bit.  There is no other route: a CUDA tensor never falls back to the
plain versions.
"""
from __future__ import annotations

import ctypes
import functools
import os

import numpy as np
import torch

from .. import tables as TB
from ..native import BUILD_DIR, compile_if_stale
from ..utils.trace import span
from . import ps_decorrelate, ps_huff, sbr_huff

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), "csrc", "qwire_rows.cu")
SO = os.path.join(BUILD_DIR, "libqwire_rows.so")

# kernel launches made by decode_rows, by ``pair`` (1: the coupled-CPE
# rows of stereo HE-AAC v1); callers that count reset them
launches = {0: 0, 1: 0}

# decode_sbr_rows' and decode_ps_region's tensor arguments and outputs
SBR_IN = ("region", "phase", "rbits", "ne", "nnoise", "frbits", "n0", "n1",
          "nq", "ampres", "active", "coupled")
SBR_CARRY = ("env_last", "noise_last", "fr_last")
SBR_OUT = ("ecodes", "pcodes", "qcodes", "qpcodes", "ok")
PS_IN = ("region", "start_off", "rbits", "enable_iid", "iq", "nr_iid",
         "enable_icc", "nr_icc", "enable_ext", "ne_pre", "penv", "nipd",
         "header")
PS_CARRY = ("iid_last", "icc_last", "ipd_full", "opd_full", "pd_enable",
            "penv_prev", "ps_ok")
PS_OUT = ("iid", "icc", "ipd", "opd", "pd_on")
LUTS = ("sbr_flat", "sbr_prefix", "sbr_bases", "sbr_maxlens", "sbr_lav",
        "ps_flat", "ps_prefix", "ps_bases", "ps_maxlens", "ps_offsets",
        "ps_iid_tabsel")
PREFIX_BITS = 8            # kPrefixBits: a code's first lookup
# the kernel's RowsArgs, in its order; the PS carry's penv_prev is the
# penv input itself, as in decode_ps_region, and ps_ok is also its
# ps_on_ok output
FIELDS = ([f"sbr_{k}" for k in SBR_IN + SBR_CARRY]
          + [f"ps_{k}" for k in PS_IN + PS_CARRY] + list(LUTS)
          + [f"sbr_{k}" for k in SBR_OUT]
          + [f"sbr_{k}_out" for k in SBR_CARRY]
          + [f"ps_{k}" for k in PS_OUT]
          + [f"ps_{k}_out" for k in PS_CARRY if k != "penv_prev"])

# [B, ...] shapes of the tensors the kernel reads and writes
SHAPES = dict(
    sbr_region=(sbr_huff.RW,), sbr_env_last=(2, sbr_huff.NB),
    sbr_noise_last=(2, sbr_huff.NQ), sbr_fr_last=(2,),
    sbr_ecodes=(sbr_huff.E, sbr_huff.NB), sbr_pcodes=(sbr_huff.E,
                                                       sbr_huff.NB),
    sbr_qcodes=(2, sbr_huff.NQ), sbr_qpcodes=(2, sbr_huff.NQ),
    ps_region=(ps_huff.RW,), ps_iid_last=(34,), ps_icc_last=(34,),
    ps_ipd_full=(5, 17), ps_opd_full=(5, 17), ps_iid=(5, 34),
    ps_icc=(5, 34), ps_ipd=(5, 17), ps_opd=(5, 17))


class RowsArgs(ctypes.Structure):
    """The kernel's ``RowsArgs``: one device pointer a field."""
    _fields_ = [(f, ctypes.c_void_p) for f in FIELDS]


def decode_rows_plain(sbr: dict, ps: dict, pair: bool):
    """The plain PyTorch version: the two row decoders one after the
    other."""
    return (sbr_huff.decode_sbr_rows(**sbr, pair=pair),
            ps_huff.decode_ps_region(**ps))


def build() -> float:
    """Compile the kernel library with K1's nvcc flags if missing or
    older than its source; returns the seconds spent compiling (0 when
    current)."""
    return compile_if_stale(SO, [SRC], [
        ps_decorrelate._nvcc(), *ps_decorrelate.NVCC_FLAGS, SRC])


@functools.cache
def _lib():
    build()
    L = ctypes.CDLL(SO)
    L.qwire_rows_launch.restype = ctypes.c_int
    L.qwire_rows_launch.argtypes = [ctypes.POINTER(RowsArgs), ctypes.c_int,
                                    ctypes.c_int, ctypes.c_void_p]
    return L


def prefix_table(flat, bases, maxlens):
    """[tables, 2^PREFIX_BITS] int64: each table's flat-LUT entry by its
    top min(PREFIX_BITS, maxlen) window bits where the code there has that
    many bits or fewer (then every flat entry under the prefix is it),
    else -1 (a longer code, or none: the flat LUT decides)."""
    out = np.full((len(bases), 1 << PREFIX_BITS), -1, np.int64)
    for t, (base, ml) in enumerate(zip(bases, maxlens)):
        pb = min(PREFIX_BITS, int(ml))
        e = flat[base + (np.arange(1 << pb) << (ml - pb))].astype(np.int64)
        out[t, :1 << pb] = np.where((e & 31) <= pb, e, -1)
    return out


@functools.cache
def _luts(device: torch.device) -> dict:
    """The kernel's tables on ``device``, made once: LUT entries as int16
    (code length | symbol << 5, under 2^15 in both tables), the rest
    int32."""
    sbr_flat, sbr_bases, sbr_maxlens = TB.sbr_huff_luts()
    ps_flat, ps_bases, ps_maxlens, ps_offsets = TB.ps_huff_luts()
    tabsel = np.array([ps_huff.IID_DF0, ps_huff.IID_DF1, ps_huff.IID_DT0,
                       ps_huff.IID_DT1])
    out = {}
    for name, a in zip(LUTS, (
            sbr_flat, prefix_table(sbr_flat, sbr_bases, sbr_maxlens),
            sbr_bases, sbr_maxlens, TB.SBR_LAV, ps_flat,
            prefix_table(ps_flat, ps_bases, ps_maxlens), ps_bases,
            ps_maxlens, ps_offsets, tabsel)):
        dt = np.int16 if name.endswith(("flat", "prefix")) else np.int32
        if a.max() > np.iinfo(dt).max:
            raise ValueError(f"{name} does not fit {dt.__name__}")
        out[name] = torch.from_numpy(a.astype(dt).reshape(-1)).to(device)
    return out


def _check(name, t, B, device):
    want = torch.bool if name == "sbr_active" else torch.long
    shape = (B,) + SHAPES.get(name, ())
    if t.dtype != want:
        raise TypeError(f"{name}: expected {want}, got {t.dtype}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected {shape}")


def decode_rows(sbr: dict, ps: dict, pair: bool):
    """One frame step's row decodes: ``sbr`` holds decode_sbr_rows'
    arguments but ``pair`` (``coupled`` given), ``ps``
    decode_ps_region's -> (decode_sbr_rows' outputs, decode_ps_region's
    outputs).  The plain functions for CPU tensors, the CUDA kernel for
    CUDA tensors (raises on anything the kernel does not take)."""
    dev = sbr["region"].device
    pair = bool(pair)
    if dev.type == "cpu":
        with span("qwire_rows", pair=int(pair)):
            return decode_rows_plain(sbr, ps, pair)
    if dev.type != "cuda":
        raise ValueError(f"decode_rows: unsupported device {dev}")
    return _launch(sbr, ps, pair, dev)


def _launch(sbr: dict, ps: dict, pair: bool, dev):
    """decode_rows' CUDA route: checks, allocates the outputs, launches."""
    B = sbr["region"].shape[0]
    ins = {f"sbr_{k}": sbr[k] for k in SBR_IN}
    ins.update((f"sbr_{k}", sbr["carry"][k]) for k in SBR_CARRY)
    ins.update((f"ps_{k}", ps[k]) for k in PS_IN)
    ins.update((f"ps_{k}", ps["carry"][k]) for k in PS_CARRY)
    for name, t in ins.items():
        _check(name, t, B, dev)
    # header fields arrive as column views: the kernel reads dense rows
    ins = {k: t.contiguous() for k, t in ins.items()}
    outs = {}
    for name in FIELDS[FIELDS.index("sbr_ecodes"):]:
        shape = (B,) + SHAPES.get(name.removesuffix("_out"), ())
        outs[name] = torch.empty(
            shape, dtype=torch.bool if name == "sbr_ok" else torch.long,
            device=dev)
    args = RowsArgs(**{k: t.data_ptr() for k, t in ins.items()},
                    **{k: t.data_ptr() for k, t in _luts(dev).items()},
                    **{k: t.data_ptr() for k, t in outs.items()})
    # launched from the CUDA runtime's current device: make it the
    # tensors' card
    with torch.cuda.device(dev), span("qwire_rows", pair=int(pair)):
        rc = _lib().qwire_rows_launch(
            ctypes.byref(args), B, int(pair),
            torch.cuda.current_stream(dev).cuda_stream)
    if rc != 0:
        raise RuntimeError(f"qwire_rows kernel launch failed: CUDA error "
                           f"{rc}")
    launches[int(pair)] += 1
    sbr_carry = {k: outs[f"sbr_{k}_out"] for k in SBR_CARRY}
    ps_carry = {k: ps["penv"] if k == "penv_prev" else outs[f"ps_{k}_out"]
                for k in PS_CARRY}
    return (tuple(outs[f"sbr_{k}"] for k in SBR_OUT) + (sbr_carry,),
            tuple(outs[f"ps_{k}"] for k in PS_OUT)
            + (outs["ps_ps_ok_out"], ps_carry))
