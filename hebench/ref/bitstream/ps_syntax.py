"""Parametric Stereo bitstream parsing (reference libavcodec/aacps.c:84-279).

Parses IID/ICC/IPD/OPD parameter sets with time/frequency delta coding,
envelope borders, and the extension container; maintains the persistent
PSContext used by the DSP half (ops/ps_np.py).
"""
from __future__ import annotations

import numpy as np

from ..tables import aac_tables as T
from ..tables.ps_tables import (PS_MAX_NR_IIDICC, PS_MAX_NUM_ENV,
                                PS_QMF_TIME_SLOTS)
from .reader import BitReader
from .vlc import VLC

NUM_ENV_TAB = [[0, 1, 2, 4], [1, 2, 3, 4]]
NR_IIDICC_PAR_TAB = [10, 20, 34, 10, 20, 34]
NR_IIDOPD_PAR_TAB = [5, 11, 17, 5, 11, 17]

(HUFF_IID_DF1, HUFF_IID_DT1, HUFF_IID_DF0, HUFF_IID_DT0, HUFF_ICC_DF,
 HUFF_ICC_DT, HUFF_IPD_DF, HUFF_IPD_DT, HUFF_OPD_DF, HUFF_OPD_DT) = range(10)
_PS_VLC_NAMES = ["huff_iid_df1", "huff_iid_dt1", "huff_iid_df0",
                 "huff_iid_dt0", "huff_icc_df", "huff_icc_dt", "huff_ipd_df",
                 "huff_ipd_dt", "huff_opd_df", "huff_opd_dt"]

_vlcs = None


def ps_vlcs():
    global _vlcs
    if _vlcs is None:
        r = T.raw()
        _vlcs = [VLC(r[f"ps_{n}_codes"], r[f"ps_{n}_bits"], name=n)
                 for n in _PS_VLC_NAMES]
    return _vlcs


def huff_offset(idx: int) -> int:
    return int(T.raw()["ps_huff_offset"][idx])


class PSContext:
    def __init__(self):
        self.start = 0
        self.enable_iid = 0
        self.iid_quant = 0
        self.nr_iid_par = 0
        self.nr_ipdopd_par = 0
        self.enable_icc = 0
        self.icc_mode = 0
        self.nr_icc_par = 0
        self.enable_ext = 0
        self.frame_class = 0
        self.num_env_old = 0
        self.num_env = 0
        self.enable_ipdopd = 0
        self.border_position = np.zeros(PS_MAX_NUM_ENV + 1, np.int64)
        self.iid_par = np.zeros((PS_MAX_NUM_ENV, PS_MAX_NR_IIDICC), np.int64)
        self.icc_par = np.zeros((PS_MAX_NUM_ENV, PS_MAX_NR_IIDICC), np.int64)
        self.ipd_par = np.zeros((PS_MAX_NUM_ENV, PS_MAX_NR_IIDICC), np.int64)
        self.opd_par = np.zeros((PS_MAX_NUM_ENV, PS_MAX_NR_IIDICC), np.int64)
        self.is34bands = 0
        self.is34bands_old = 0
        # wire-v5 raw-region capture (set by read_ps_data on success;
        # consumed + cleared by codec/qwire.build_side)
        self.wire_fresh = 0
        self.wire_header = 0
        self.wire_ne_pre = 0
        self.wire_bitoff = 0
        self.wire_rbits = 0
        self.wire_region = b""
        # DSP state (ops/ps_np.py)
        self.in_buf = np.zeros((5, 44, 2), np.float32)
        self.delay = np.zeros((91, 32 + 14, 2), np.float32)
        self.ap_delay = np.zeros((50, 3, 32 + 5, 2), np.float32)
        self.peak_decay_nrg = np.zeros(34, np.float32)
        self.power_smooth = np.zeros(34, np.float32)
        self.peak_decay_diff_smooth = np.zeros(34, np.float32)
        self.H11 = np.zeros((2, PS_MAX_NUM_ENV + 1, PS_MAX_NR_IIDICC), np.float32)
        self.H12 = np.zeros((2, PS_MAX_NUM_ENV + 1, PS_MAX_NR_IIDICC), np.float32)
        self.H21 = np.zeros((2, PS_MAX_NUM_ENV + 1, PS_MAX_NR_IIDICC), np.float32)
        self.H22 = np.zeros((2, PS_MAX_NUM_ENV + 1, PS_MAX_NR_IIDICC), np.float32)
        self.opd_hist = np.zeros(PS_MAX_NR_IIDICC, np.int64)
        self.ipd_hist = np.zeros(PS_MAX_NR_IIDICC, np.int64)


def _read_par(ps: PSContext, br: BitReader, par, num: int, table_idx: int,
              e: int, dt: int, offset: int, mask: int, err_check) -> bool:
    """READ_PAR_DATA expansion (aacps.c:84-114). Returns False on error."""
    vlc = ps_vlcs()[table_idx]
    if dt:
        e_prev = e - 1 if e else ps.num_env_old - 1
        e_prev = max(e_prev, 0)
        for b in range(num):
            val = int(par[e_prev][b]) + vlc.decode(br) - offset
            if mask:
                val &= mask
            par[e][b] = val
            if err_check is not None and err_check(val):
                return False
    else:
        val = 0
        for b in range(num):
            val += vlc.decode(br) - offset
            if mask:
                val &= mask
            par[e][b] = val
            if err_check is not None and err_check(val):
                return False
    return True


def _read_extension(br: BitReader, ps: PSContext, ext_id: int) -> int:
    start = br.pos
    if ext_id:
        return 0
    ps.enable_ipdopd = br.get1()
    if ps.enable_ipdopd:
        for e in range(ps.num_env):
            dt = br.get1()
            _read_par(ps, br, ps.ipd_par, ps.nr_ipdopd_par,
                      HUFF_IPD_DT if dt else HUFF_IPD_DF, e, dt, 0, 0x07, None)
            dt = br.get1()
            _read_par(ps, br, ps.opd_par, ps.nr_ipdopd_par,
                      HUFF_OPD_DT if dt else HUFF_OPD_DF, e, dt, 0, 0x07, None)
    br.skip(1)  # reserved_ps
    return br.pos - start


_LOG2 = [0, 0, 1, 1, 2, 2, 2, 2, 3]


def read_ps_data(ps: PSContext, br_host: BitReader, bits_left: int) -> int:
    """ff_ps_read_data (aacps.c:150-279); consumes from a copy, then skips
    the host reader by the consumed amount."""
    br = BitReader(b"")
    br._val, br.nbits, br.pos = br_host._val, br_host.nbits, br_host.pos
    start = br.pos
    try:
        header = br.get1()
        if header:
            ps.enable_iid = br.get1()
            if ps.enable_iid:
                iid_mode = br.get(3)
                if iid_mode > 5:
                    raise ValueError("reserved iid_mode")
                ps.nr_iid_par = NR_IIDICC_PAR_TAB[iid_mode]
                ps.iid_quant = int(iid_mode > 2)
                ps.nr_ipdopd_par = NR_IIDOPD_PAR_TAB[iid_mode]
            ps.enable_icc = br.get1()
            if ps.enable_icc:
                ps.icc_mode = br.get(3)
                if ps.icc_mode > 5:
                    raise ValueError("reserved icc_mode")
                ps.nr_icc_par = NR_IIDICC_PAR_TAB[ps.icc_mode]
            ps.enable_ext = br.get1()

        ps.frame_class = br.get1()
        ps.num_env_old = ps.num_env
        ps.num_env = NUM_ENV_TAB[ps.frame_class][br.get(2)]

        ps.border_position[0] = -1
        if ps.frame_class:
            for e in range(1, ps.num_env + 1):
                ps.border_position[e] = br.get(5)
        else:
            for e in range(1, ps.num_env + 1):
                ps.border_position[e] = (
                    (e * PS_QMF_TIME_SLOTS) >> _LOG2[ps.num_env]) - 1

        # wire-v5 capture (codec/qwire PS sub-block): the entropy-coded
        # half from the first iid dt bit to the end of the payload ships
        # as raw bits and decodes on device (ops/ps_huff)
        ne_pre = ps.num_env
        region_bit = br.pos

        iq = ps.iid_quant
        if ps.enable_iid:
            for e in range(ps.num_env):
                dt = br.get1()
                tab = [HUFF_IID_DF0, HUFF_IID_DF1,
                       HUFF_IID_DT0, HUFF_IID_DT1][2 * dt + iq]
                if not _read_par(ps, br, ps.iid_par, ps.nr_iid_par, tab, e,
                                 dt, huff_offset(tab), 0,
                                 lambda v: abs(v) > 7 + 8 * iq):
                    raise ValueError("illegal iid")
        else:
            ps.iid_par[:] = 0

        if ps.enable_icc:
            for e in range(ps.num_env):
                dt = br.get1()
                tab = HUFF_ICC_DT if dt else HUFF_ICC_DF
                if not _read_par(ps, br, ps.icc_par, ps.nr_icc_par, tab, e,
                                 dt, huff_offset(tab), 0,
                                 lambda v: not 0 <= v <= 7):
                    raise ValueError("illegal icc")
        else:
            ps.icc_par[:] = 0

        if ps.enable_ext:
            cnt = br.get(4)
            if cnt == 15:
                cnt += br.get(8)
            cnt *= 8
            while cnt > 7:
                ext_id = br.get(2)
                cnt -= 2 + _read_extension(br, ps, ext_id)
            if cnt < 0:
                raise ValueError("ps extension overflow")
            br.skip(cnt)

        # Fix up envelopes (aacps.c:234-252)
        if (not ps.num_env
                or ps.border_position[ps.num_env] < PS_QMF_TIME_SLOTS - 1):
            source = ps.num_env - 1 if ps.num_env else ps.num_env_old - 1
            if source >= 0 and source != ps.num_env:
                if ps.enable_iid:
                    ps.iid_par[ps.num_env] = ps.iid_par[source]
                if ps.enable_icc:
                    ps.icc_par[ps.num_env] = ps.icc_par[source]
                if ps.enable_ipdopd:
                    ps.ipd_par[ps.num_env] = ps.ipd_par[source]
                    ps.opd_par[ps.num_env] = ps.opd_par[source]
            ps.num_env += 1
            ps.border_position[ps.num_env] = PS_QMF_TIME_SLOTS - 1

        ps.is34bands_old = ps.is34bands
        if ps.enable_iid or ps.enable_icc:
            ps.is34bands = int(
                (ps.enable_iid and ps.nr_iid_par == 34)
                or (ps.enable_icc and ps.nr_icc_par == 34))

        if not ps.enable_ipdopd:
            ps.ipd_par[:] = 0
            ps.opd_par[:] = 0

        if header:
            ps.start = 1

        consumed = br.pos - start
        if consumed <= bits_left:
            b0 = region_bit >> 3
            rbits = (start + bits_left) - 8 * b0
            nby = (rbits + 7) // 8
            shift = br.nbits - 8 * b0 - 8 * nby
            v = br._val >> shift if shift >= 0 else br._val << -shift
            ps.wire_region = (v & ((1 << (8 * nby)) - 1)).to_bytes(nby,
                                                                   "big")
            ps.wire_bitoff = region_bit & 7
            ps.wire_rbits = rbits
            ps.wire_ne_pre = ne_pre
            ps.wire_header = header
            ps.wire_fresh = 1
            br_host.skip(consumed)
            return consumed
        raise ValueError("PS overread")
    except ValueError:
        ps.start = 0
        br_host.skip(bits_left)
        return bits_left
