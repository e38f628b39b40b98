"""Frozen copy of the port's SBR and PS stream writers and the SBR
splicer (``heaac_tpu_torch/io/heaac_testgen.py``: ``SbrStreamWriter``,
``PsStreamWriter``, ``splice_sbr_into_lc``), over the benchmark
reference's own bitstream parsers and tables (``hebench.ref``), so the
benchmark's streams do not change when the program does.  A payload that
cannot be coded raises ValueError and the stream makers re-draw.  The
element ends that ``splice_sbr_into_lc`` splices after come from the
reference ``Decoder``'s parse of the core, made once per core.

An AAC-LC ADTS stream at the core rate gets a syntactically valid SBR
fill extension (and, with a PS writer, parametric stereo in its extended
data) in every frame, with the ADTS frame length rewritten.  The writers
mirror the decoder's delta-coding state, so delta-time coded frames stay
in range.
"""
from __future__ import annotations

import numpy as np

from ..ref.bitstream import sbr_syntax as S
from ..ref.bitstream.adts import parse_adts_header, split_adts_stream
from ..ref.bitstream.reader import BitReader
from ..ref.codec.decoder import Decoder
from ..ref.tables import aac_tables as T
from .bitwriter import BitWriter

# Huffman encode tables: value-index -> (code, bits)
_enc_cache: dict[int, tuple] = {}


def _enc(vlc_idx: int):
    if vlc_idx not in _enc_cache:
        r = T.raw()
        name, lav = S._SBR_VLC_NAMES[vlc_idx]
        _enc_cache[vlc_idx] = (r[f"sbr_{name}_codes"], r[f"sbr_{name}_bits"],
                               lav)
    return _enc_cache[vlc_idx]


def _put_vlc(bw: BitWriter, vlc_idx: int, delta: int) -> None:
    codes, bits, lav = _enc(vlc_idx)
    idx = delta + lav
    if not 0 <= idx < len(codes):
        raise ValueError(f"SBR delta {delta} outside Huffman table {vlc_idx}")
    bw.put(int(bits[idx]), int(codes[idx]))


class SbrWriterState:
    """Mirror of the decoder-side per-channel delta-coding state."""

    def __init__(self):
        self.env = np.zeros((6, 48), np.int64)    # raw quantized chain
        self.noise = np.zeros((3, 5), np.int64)
        self.freq_res = np.zeros(7, np.int64)
        self.num_env = 0
        self.t_env = np.zeros(8, np.int64)
        self.e_a1 = -1


class SbrStreamWriter:
    """Generates one element's SBR payload per frame."""

    def __init__(self, core_rate: int, is_cpe: bool, seed: int = 0,
                 amp_res: int = 1, start_freq: int = 5, stop_freq: int = 7,
                 xover_band: int = 0, freq_scale: int = 2, alter_scale: int = 1,
                 noise_bands: int = 2, limiter_bands: int = 2,
                 limiter_gains: int = 2, interpol_freq: int = 1,
                 smoothing_mode: int = 1, coupling: bool = False,
                 header_every: int = 100, no_header: bool = False,
                 crc: bool = False, grid_classes=(0, 1, 2, 3),
                 allow_df: bool = True, allow_harmonics: bool = True,
                 fix_num_env: int | None = None,
                 invf_modes=(0, 1, 2, 3), env_hi_shift: int = 0,
                 ps_writer=None):
        self.rng = np.random.default_rng(seed)
        self.is_cpe = is_cpe
        self.crc = crc
        self.p = dict(amp_res=amp_res, start_freq=start_freq,
                      stop_freq=stop_freq, xover_band=xover_band,
                      freq_scale=freq_scale, alter_scale=alter_scale,
                      noise_bands=noise_bands, limiter_bands=limiter_bands,
                      limiter_gains=limiter_gains,
                      interpol_freq=interpol_freq,
                      smoothing_mode=smoothing_mode)
        self.coupling = coupling and is_cpe
        self.grid_classes = tuple(grid_classes)
        self.allow_df = allow_df
        self.allow_harmonics = allow_harmonics
        self.fix_num_env = fix_num_env
        self.invf_modes = tuple(invf_modes)
        self.env_hi_shift = env_hi_shift
        self.ps_writer = ps_writer
        self.header_every = header_every
        self.no_header = no_header
        self.frame_idx = 0
        self.ch_state = [SbrWriterState(), SbrWriterState()]
        # derive the frequency tables exactly as the decoder will
        self.sbr = S.SBRContext()
        self.sbr.sample_rate = 2 * core_rate
        sp = self.sbr.spectrum_params
        sp.bs_start_freq = start_freq
        sp.bs_stop_freq = stop_freq
        sp.bs_xover_band = xover_band
        sp.bs_freq_scale = freq_scale
        sp.bs_alter_scale = alter_scale
        sp.bs_noise_bands = noise_bands
        self.sbr.bs_limiter_bands = limiter_bands
        S.sbr_make_f_master(self.sbr, sp)
        S.sbr_make_f_derived(self.sbr)

    # -- grid ----------------------------------------------------------
    def _write_grid(self, bw: BitWriter, st: SbrWriterState):
        rng = self.rng
        cls = int(self.grid_classes[rng.integers(0, len(self.grid_classes))])
        st.freq_res[0] = st.freq_res[st.num_env]
        num_env_old = st.num_env
        t_env_old_last = int(st.t_env[st.num_env])
        bs_pointer = 0
        abs_bord_trail = 16
        if cls == S.FIXFIX:
            if self.fix_num_env:
                log_env = {1: 0, 2: 1, 4: 2}[self.fix_num_env]
            else:
                log_env = int(rng.integers(0, 3))  # 1,2,4 envelopes
            num_env = 1 << log_env
            bw.put(2, cls)
            bw.put(2, log_env)
            t = np.zeros(8, np.int64)
            t[num_env] = 16
            step = (16 + (num_env >> 1)) // num_env
            for i in range(num_env - 1):
                t[i + 1] = t[i] + step
            fr = int(rng.integers(0, 2))
            bw.put1(fr)
            st.freq_res[1: num_env + 1] = fr
        elif cls == S.FIXVAR:
            var = int(rng.integers(0, 4))
            abs_bord_trail += var
            num_rel = int(rng.integers(0, 3))
            num_env = num_rel + 1
            bw.put(2, cls)
            bw.put(2, var)
            bw.put(2, num_rel)
            t = np.zeros(8, np.int64)
            t[num_env] = abs_bord_trail
            rels = []
            for i in range(num_rel):
                lo = 0
                hi = min(3, max(0, (int(t[num_env - i]) - 2 * (num_rel - i)) // 2 - 1))
                r = int(rng.integers(0, hi + 1))
                rels.append(r)
                t[num_env - 1 - i] = t[num_env - i] - 2 * r - 2
            for r in rels:
                bw.put(2, r)
            nbits = S._CEIL_LOG2[num_env]
            bs_pointer = int(rng.integers(0, min(num_env + 2, 1 << nbits)))
            bw.put(nbits, bs_pointer)
            frs = [int(rng.integers(0, 2)) for _ in range(num_env)]
            for i, fr in enumerate(frs):
                bw.put1(fr)
                st.freq_res[num_env - i] = fr
        elif cls == S.VARFIX:
            t0 = int(rng.integers(0, 4))
            num_rel = int(rng.integers(0, 3))
            num_env = num_rel + 1
            bw.put(2, cls)
            bw.put(2, t0)
            bw.put(2, num_rel)
            t = np.zeros(8, np.int64)
            t[0] = t0
            t[num_env] = abs_bord_trail
            for i in range(num_rel):
                budget = 16 - int(t[i]) - 2 * (num_rel - i)
                hi = min(3, max(0, budget // 2 - 1))
                r = int(rng.integers(0, hi + 1))
                bw.put(2, r)
                t[i + 1] = t[i] + 2 * r + 2
            nbits = S._CEIL_LOG2[num_env]
            bs_pointer = int(rng.integers(0, min(num_env + 2, 1 << nbits)))
            bw.put(nbits, bs_pointer)
            for i in range(num_env):
                fr = int(rng.integers(0, 2))
                bw.put1(fr)
                st.freq_res[i + 1] = fr
        else:  # VARVAR
            t0 = int(rng.integers(0, 4))
            var = int(rng.integers(0, 4))
            abs_bord_trail += var
            num_rel_lead = int(rng.integers(0, 2))
            num_rel_trail = int(rng.integers(0, 2))
            num_env = num_rel_lead + num_rel_trail + 1
            bw.put(2, cls)
            bw.put(2, t0)
            bw.put(2, var)
            bw.put(2, num_rel_lead)
            bw.put(2, num_rel_trail)
            t = np.zeros(8, np.int64)
            t[0] = t0
            t[num_env] = abs_bord_trail
            for i in range(num_rel_lead):
                budget = (abs_bord_trail - 2 * num_rel_trail - int(t[i])
                          - 2 * (num_rel_lead - i))
                hi = min(3, max(0, budget // 2 - 1))
                r = int(rng.integers(0, hi + 1))
                bw.put(2, r)
                t[i + 1] = t[i] + 2 * r + 2
            rels = []
            for i in range(num_rel_trail):
                lo_border = int(t[num_rel_lead]) + 2 * (num_rel_trail - i)
                hi = min(3, max(0, (int(t[num_env - i]) - lo_border) // 2 - 1))
                r = int(rng.integers(0, hi + 1))
                rels.append(r)
                t[num_env - 1 - i] = t[num_env - i] - 2 * r - 2
            for r in rels:
                bw.put(2, r)
            nbits = S._CEIL_LOG2[num_env]
            bs_pointer = int(rng.integers(0, min(num_env + 2, 1 << nbits)))
            bw.put(nbits, bs_pointer)
            for i in range(num_env):
                fr = int(rng.integers(0, 2))
                bw.put1(fr)
                st.freq_res[i + 1] = fr

        if cls == S.FIXFIX and num_env == 1:
            amp_res_now = 0
        else:
            amp_res_now = self.p["amp_res"]
        st.num_env = num_env
        st.t_env = t
        # mirror e_a bookkeeping (aacsbr.c:741-746)
        e_a0 = -int(st.e_a1 != num_env_old)
        st.e_a1 = -1
        if (cls & 1) and bs_pointer:
            st.e_a1 = num_env + 1 - bs_pointer
        elif cls == S.VARFIX and bs_pointer > 1:
            st.e_a1 = bs_pointer - 1
        st.t_env_old_last = t_env_old_last
        return num_env, amp_res_now

    # -- envelopes / noise ----------------------------------------------
    def _write_env(self, bw: BitWriter, st: SbrWriterState, ch: int,
                   amp_res: int, first_frame: bool):
        sbr, rng = self.sbr, self.rng
        coupled_bal = self.coupling and ch == 1
        delta = 2 if coupled_bal else 1
        if coupled_bal:
            t_idx, f_idx = (S.T_BAL30, S.F_BAL30) if amp_res else (S.T_BAL15, S.F_BAL15)
            bits = 5 if amp_res else 6
            lo, hi = 0, 12 if amp_res else 24
        else:
            t_idx, f_idx = (S.T_ENV30, S.F_ENV30) if amp_res else (S.T_ENV15, S.F_ENV15)
            bits = 6 if amp_res else 7
            lo, hi = (15, 40) if amp_res else (30, 80)
            hi += self.env_hi_shift * (1 if amp_res else 2)
            lo = min(lo, hi)
        _, _, t_lav = _enc(t_idx)
        _, _, f_lav = _enc(f_idx)
        odd = sbr.n[1] & 1
        for i in range(st.num_env):
            n_cur = sbr.n[st.freq_res[i + 1]]
            df = 0 if ((first_frame and i == 0) or not self.allow_df) \
                else int(rng.integers(0, 2))
            st_df = df
            self._df_env[ch].append(st_df)
            if df:
                for j in range(n_cur):
                    if st.freq_res[i + 1] == st.freq_res[i]:
                        k = j
                    elif st.freq_res[i + 1]:
                        k = (j + odd) >> 1
                    else:
                        k = 2 * j - odd if j else 0
                    base = int(st.env[i][k])
                    lo_t = max(lo, base - delta * t_lav)
                    hi_t = min(hi, base + delta * t_lav)
                    if lo_t > hi_t:
                        val = min(max(min(max(base, lo), hi),
                                      base - delta * t_lav),
                                  base + delta * t_lav)
                    else:
                        val = int(rng.integers(lo_t, hi_t + 1))
                    d, rem = divmod(val - base, delta)
                    val -= rem
                    self._env_bits[ch].append(("v", t_idx, d))
                    st.env[i + 1][j] = val
            else:
                start = int(rng.integers(lo, hi + 1)) // delta
                self._env_bits[ch].append(("b", bits, start))
                st.env[i + 1][0] = start * delta
                for j in range(1, n_cur):
                    base = int(st.env[i + 1][j - 1])
                    lo_t = max(lo, base - delta * f_lav)
                    hi_t = min(hi, base + delta * f_lav)
                    if lo_t <= hi_t:
                        val = int(rng.integers(lo_t, hi_t + 1))
                    else:
                        val = min(max(min(max(base, lo), hi),
                                      base - delta * f_lav),
                                  base + delta * f_lav)
                    d, rem = divmod(val - base, delta)
                    val -= rem
                    self._env_bits[ch].append(("v", f_idx, d))
                    st.env[i + 1][j] = val
        st.env[0][:] = st.env[st.num_env]

    def _write_noise(self, st: SbrWriterState, ch: int, first_frame: bool,
                     num_noise: int):
        sbr, rng = self.sbr, self.rng
        coupled_bal = self.coupling and ch == 1
        delta = 2 if coupled_bal else 1
        t_idx = S.T_NOISEBAL30 if coupled_bal else S.T_NOISE30
        f_idx = S.F_BAL30 if coupled_bal else S.F_ENV30
        _, _, t_lav = _enc(t_idx)
        _, _, f_lav = _enc(f_idx)
        lo, hi = (0, 12) if coupled_bal else (0, 28)
        for i in range(num_noise):
            df = 0 if ((first_frame and i == 0) or not self.allow_df) \
                else int(rng.integers(0, 2))
            self._df_noise[ch].append(df)
            if df:
                for j in range(sbr.n_q):
                    base = int(st.noise[i][j])
                    lo_t = max(lo, base - delta * t_lav)
                    hi_t = min(hi, base + delta * t_lav)
                    if lo_t <= hi_t:
                        val = int(rng.integers(lo_t, hi_t + 1))
                    else:
                        val = min(max(min(max(base, lo), hi),
                                      base - delta * t_lav),
                                  base + delta * t_lav)
                    d, rem = divmod(val - base, delta)
                    val -= rem
                    self._noise_bits[ch].append(("v", t_idx, d))
                    st.noise[i + 1][j] = val
            else:
                start = int(rng.integers(lo, hi + 1)) // delta
                self._noise_bits[ch].append(("b", 5, start))
                st.noise[i + 1][0] = start * delta
                for j in range(1, sbr.n_q):
                    base = int(st.noise[i + 1][j - 1])
                    lo_t = max(lo, base - delta * f_lav)
                    hi_t = min(hi, base + delta * f_lav)
                    if lo_t <= hi_t:
                        val = int(rng.integers(lo_t, hi_t + 1))
                    else:
                        val = min(max(min(max(base, lo), hi),
                                      base - delta * f_lav),
                                  base + delta * f_lav)
                    d, rem = divmod(val - base, delta)
                    val -= rem
                    self._noise_bits[ch].append(("v", f_idx, d))
                    st.noise[i + 1][j] = val
        st.noise[0][:] = st.noise[num_noise]

    def _flush_values(self, bw: BitWriter, items):
        for kind, a, b in items:
            if kind == "b":
                bw.put(a, b)
            else:
                _put_vlc(bw, a, b)

    # -- payload ---------------------------------------------------------
    def sbr_payload(self) -> BitWriter:
        """Produce sbr_data (without the 4-bit extension type)."""
        bw = BitWriter()
        first = self.frame_idx == 0
        if self.crc:
            bw.put(10, 0x155)  # dummy CRC; reference skips it
        write_header = (not self.no_header) and (
            first or (self.header_every and
                      self.frame_idx % self.header_every == 0))
        bw.put1(int(write_header))
        if write_header:
            p = self.p
            bw.put1(p["amp_res"])
            bw.put(4, p["start_freq"])
            bw.put(4, p["stop_freq"])
            bw.put(3, p["xover_band"])
            bw.put(2, 0)  # reserved
            bw.put1(1)    # header_extra_1
            bw.put1(1)    # header_extra_2
            bw.put(2, p["freq_scale"])
            bw.put1(p["alter_scale"])
            bw.put(2, p["noise_bands"])
            bw.put(2, p["limiter_bands"])
            bw.put(2, p["limiter_gains"])
            bw.put1(p["interpol_freq"])
            bw.put1(p["smoothing_mode"])
        if self.no_header:
            self.frame_idx += 1
            return bw

        sbr, rng = self.sbr, self.rng
        nch = 2 if self.is_cpe else 1
        self._df_env = [[], []]
        self._df_noise = [[], []]
        self._env_bits = [[], []]
        self._noise_bits = [[], []]

        if self.is_cpe:
            bw.put1(0)  # bs_data_extra
            bw.put1(int(self.coupling))
        else:
            bw.put1(0)  # bs_data_extra

        if self.is_cpe and self.coupling:
            ne, ar = self._write_grid(bw, self.ch_state[0])
            # grid copied to ch1 (copy_sbr_grid); mirror chain state
            st1 = self.ch_state[1]
            st1.freq_res[0] = st1.freq_res[st1.num_env]
            st1.freq_res[1:] = self.ch_state[0].freq_res[1:]
            st1.num_env = ne
            st1.t_env = self.ch_state[0].t_env.copy()
            num_noise = (ne > 1) + 1
            self._write_env_noise_values(ar, ne, num_noise, first, nch=2)
            # dtdf ch0, dtdf ch1
            for ch in range(2):
                for df in self._df_env[ch]:
                    bw.put1(df)
                for df in self._df_noise[ch]:
                    bw.put1(df)
            # invf ch0 only
            for _ in range(sbr.n_q):
                bw.put(2, int(self.invf_modes[
                    rng.integers(0, len(self.invf_modes))]))
            self._flush_values(bw, self._env_bits[0])
            self._flush_values(bw, self._noise_bits[0])
            self._flush_values(bw, self._env_bits[1])
            self._flush_values(bw, self._noise_bits[1])
        else:
            if self.is_cpe:
                grids = []
                for ch in range(2):
                    grids.append(self._write_grid_deferred(self.ch_state[ch]))
                for g in grids:
                    bw.extend(g[0])
                nes = [g[1] for g in grids]
                ars = [g[2] for g in grids]
                for ch in range(2):
                    ne = nes[ch]
                    self._gen_env_noise_for_ch(ch, ars[ch], ne,
                                               (ne > 1) + 1, first)
                for ch in range(2):
                    for df in self._df_env[ch]:
                        bw.put1(df)
                    for df in self._df_noise[ch]:
                        bw.put1(df)
                for ch in range(2):
                    for _ in range(sbr.n_q):
                        bw.put(2, int(self.invf_modes[
                    rng.integers(0, len(self.invf_modes))]))
                self._flush_values(bw, self._env_bits[0])
                self._flush_values(bw, self._env_bits[1])
                self._flush_values(bw, self._noise_bits[0])
                self._flush_values(bw, self._noise_bits[1])
            else:
                ne, ar = self._write_grid(bw, self.ch_state[0])
                self._gen_env_noise_for_ch(0, ar, ne, (ne > 1) + 1, first)
                for df in self._df_env[0]:
                    bw.put1(df)
                for df in self._df_noise[0]:
                    bw.put1(df)
                for _ in range(sbr.n_q):
                    bw.put(2, int(self.invf_modes[
                    rng.integers(0, len(self.invf_modes))]))
                self._flush_values(bw, self._env_bits[0])
                self._flush_values(bw, self._noise_bits[0])

        # bs_add_harmonic per channel
        for ch in range(nch):
            add = int(rng.integers(0, 2) == 0) if self.allow_harmonics else 0
            bw.put1(add)
            if add:
                for _ in range(sbr.n[1]):
                    bw.put1(int(rng.integers(0, 5) == 0))
        if self.ps_writer is not None:
            sub = self.ps_writer.ps_payload()
            total = 2 + sub.nbits
            cnt = (total + 7) // 8
            bw.put1(1)  # bs_extended_data
            if cnt >= 15:
                bw.put(4, 15)
                bw.put(8, cnt - 15)
            else:
                bw.put(4, cnt)
            bw.put(2, 2)  # EXTENSION_ID_PS (aacsbr.c:69)
            bw.extend(sub)
            bw.put(cnt * 8 - total, 0)
        else:
            bw.put1(0)  # bs_extended_data
        self.frame_idx += 1
        return bw

    def _write_grid_deferred(self, st):
        sub = BitWriter()
        ne, ar = self._write_grid(sub, st)
        return sub, ne, ar

    def _gen_env_noise_for_ch(self, ch, amp_res, num_env, num_noise, first):
        self._write_env(BitWriter(), self.ch_state[ch], ch, amp_res, first)
        self._write_noise(self.ch_state[ch], ch, first, num_noise)

    def _write_env_noise_values(self, amp_res, num_env, num_noise, first,
                                nch):
        for ch in range(nch):
            self._gen_env_noise_for_ch(ch, amp_res, num_env, num_noise, first)


def core_frames(lc_adts: bytes) -> tuple:
    """The core's ADTS frames, each with the bit position of its END
    element, from the reference parser (one parse per core)."""
    frames = split_adts_stream(lc_adts)
    hdr0 = parse_adts_header(BitReader(frames[0]))
    dec = Decoder(adts_probe=frames[0][:7])
    out = []
    for f in frames:
        dec_br = BitReader(f)
        h = parse_adts_header(dec_br)
        # the object type is per frame (profile-flip streams are legal)
        dec.m4ac.object_type = h.object_type
        if not hdr0.crc_absent:
            dec_br.skip(16)
        dec._parse_raw_data_block(dec_br)
        out.append((f, dec._end_bitpos))
    return tuple(out)


def splice_sbr_into_lc(core: tuple, writer: SbrStreamWriter) -> bytes:
    """Append an SBR fill element to every frame of an LC ADTS stream,
    given as ``core_frames(stream)``."""
    out = bytearray()
    for f, end_pos in core:
        payload = writer.sbr_payload()
        # fill element: 4-bit ext type + payload + alignment to whole bytes
        ext = BitWriter()
        ext.put(4, 0xE if writer.crc else 0xD)
        ext.extend(payload)
        cnt = (ext.nbits + 7) // 8
        ext.put(8 * cnt - ext.nbits, 0)  # bs_fill_bits

        bw = BitWriter()
        hdr_bits = 56  # ADTS header, CRC absent
        bw.put_bits_from(f, hdr_bits, end_pos - hdr_bits)
        bw.put(3, T.TYPE_FIL)
        if cnt >= 15:
            bw.put(4, 15)
            bw.put(8, cnt - 15 + 1)
        else:
            bw.put(4, cnt)
        bw.extend(ext)
        bw.put(3, T.TYPE_END)
        bw.align()
        body = bw.bytes()
        full_len = 7 + len(body)
        hdr = bytearray(f[:7])
        hdr[3] = (hdr[3] & 0xFC) | (full_len >> 11)
        hdr[4] = (full_len >> 3) & 0xFF
        hdr[5] = (hdr[5] & 0x1F) | ((full_len & 7) << 5)
        out += bytes(hdr) + body
    return bytes(out)


class PsStreamWriter:
    """Generates ps_data payloads (written into the SBR extended-data
    container with extension id 2), mirroring the decoder's delta state."""

    def __init__(self, seed: int = 0, iid_mode: int = 1, icc_mode: int = 1,
                 enable_iid: bool = True, enable_icc: bool = True,
                 enable_ipdopd: bool = False, allow_dt: bool = True,
                 frame_classes=(0, 1), header_every: int = 100,
                 switch_at: dict | None = None):
        from ..ref.bitstream import ps_syntax as PSyn
        self.PSyn = PSyn
        self.rng = np.random.default_rng(seed + 1000)
        self.iid_mode = iid_mode
        self.icc_mode = icc_mode
        # {frame_idx: (iid_mode, icc_mode)} band-resolution switches,
        # applied just before that frame's payload is written
        self.switch_at = dict(switch_at or {})
        self._force_header = False
        self._force_df = False
        self.enable_iid = enable_iid
        self.enable_icc = enable_icc
        self.enable_ipdopd = enable_ipdopd
        self.allow_dt = allow_dt
        self.frame_classes = tuple(frame_classes)
        self.header_every = header_every
        self.frame_idx = 0
        self.nr_iid_par = PSyn.NR_IIDICC_PAR_TAB[iid_mode]
        self.nr_icc_par = PSyn.NR_IIDICC_PAR_TAB[icc_mode]
        self.nr_ipdopd_par = PSyn.NR_IIDOPD_PAR_TAB[iid_mode]
        self.iid_quant = int(iid_mode > 2)
        # mirrored state
        self.iid = np.zeros((6, 34), np.int64)
        self.icc = np.zeros((6, 34), np.int64)
        self.ipd = np.zeros((6, 34), np.int64)
        self.opd = np.zeros((6, 34), np.int64)
        self.num_env = 0

    def switch_mode(self, iid_mode: int, icc_mode: int | None = None):
        """Change the band resolution mid-stream (PS header rewrite).

        The next payload carries a header with the new modes and codes
        every envelope delta-frequency (df), sidestepping cross-resolution
        dt bases — exactly the 20<->34 transition the decoder's state
        fixup (aacps.c:831-860 map_val + ipdopd_reset) converts across."""
        PSyn = self.PSyn
        self.iid_mode = int(iid_mode)
        if icc_mode is not None:
            self.icc_mode = int(icc_mode)
        self.nr_iid_par = PSyn.NR_IIDICC_PAR_TAB[self.iid_mode]
        self.nr_icc_par = PSyn.NR_IIDICC_PAR_TAB[self.icc_mode]
        self.nr_ipdopd_par = PSyn.NR_IIDOPD_PAR_TAB[self.iid_mode]
        self.iid_quant = int(self.iid_mode > 2)
        self._force_header = True
        self._force_df = True

    def _ps_enc(self, idx):
        r = T.raw()
        names = self.PSyn._PS_VLC_NAMES
        return r[f"ps_{names[idx]}_codes"], r[f"ps_{names[idx]}_bits"]

    def _write_par(self, bw, par, num, e, dt, table_idx, offset, lo, hi,
                   mask=0):
        codes, bits = self._ps_enc(table_idx)
        if dt:
            e_prev = e - 1 if e else max(self.num_env_old - 1, 0)
            base_row = par[e_prev]
        prev = 0
        lo_d, hi_d = -offset, len(codes) - 1 - offset
        for b in range(num):
            base = int(base_row[b]) if dt else prev
            if mask:
                # wrapped values: any target reachable, delta = (val-base)&mask
                val = int(self.rng.integers(lo, hi + 1))
                delta = (val - base) & mask
                val = (base + delta) & mask
            else:
                lo_t = max(lo, base + lo_d)
                hi_t = min(hi, base + hi_d)
                if lo_t > hi_t:
                    val = min(max(min(max(base, lo), hi), base + lo_d),
                              base + hi_d)
                else:
                    val = int(self.rng.integers(lo_t, hi_t + 1))
                delta = val - base
            sym = delta + offset
            if not 0 <= sym < len(codes):
                raise ValueError(f"PS delta {delta} outside Huffman table "
                                 f"{table_idx}")
            bw.put(int(bits[sym]), int(codes[sym]))
            par[e][b] = val
            prev = val
        return

    def ps_payload(self, max_bytes: int = 269) -> BitWriter:
        """One ps_data payload, bounded by the FIL container it must fit
        in (a FIL extension payload is at most 269 bytes, 4-bit count +
        8-bit esc, aacdec.c:1650-1668): oversized random draws are
        re-rolled with the mirrored delta state rewound, because a real
        encoder could never emit them."""
        snap = (self._force_header, self._force_df, self.num_env,
                getattr(self, "num_env_old", 0), self.frame_idx,
                self.iid.copy(), self.icc.copy(), self.ipd.copy(),
                self.opd.copy())
        for _ in range(64):
            bw = self._gen_ps_payload()
            if max_bytes is None or (bw.nbits + 7) // 8 <= max_bytes:
                return bw
            (self._force_header, self._force_df, self.num_env,
             self.num_env_old, self.frame_idx) = snap[:5]
            self.iid[:] = snap[5]
            self.icc[:] = snap[6]
            self.ipd[:] = snap[7]
            self.opd[:] = snap[8]
        return bw

    def _gen_ps_payload(self) -> BitWriter:
        PSyn = self.PSyn
        rng = self.rng
        if self.frame_idx in self.switch_at:
            sw = self.switch_at[self.frame_idx]
            self.switch_mode(*(sw if isinstance(sw, (tuple, list))
                               else (sw,)))
        bw = BitWriter()
        first = self.frame_idx == 0
        header = first or self._force_header \
            or (self.header_every
                and self.frame_idx % self.header_every == 0)
        self._force_header = False
        force_df = self._force_df
        self._force_df = False
        bw.put1(int(header))
        if header:
            bw.put1(int(self.enable_iid))
            if self.enable_iid:
                bw.put(3, self.iid_mode)
            bw.put1(int(self.enable_icc))
            if self.enable_icc:
                bw.put(3, self.icc_mode)
            bw.put1(int(self.enable_ipdopd))  # enable_ext

        fc = int(self.frame_classes[rng.integers(0, len(self.frame_classes))])
        ne_idx = int(rng.integers(0, 4))
        num_env = PSyn.NUM_ENV_TAB[fc][ne_idx]
        bw.put1(fc)
        bw.put(2, ne_idx)
        self.num_env_old = self.num_env
        borders = []
        if fc:
            # increasing 5-bit borders; usually end at 31
            end = 31 if rng.integers(0, 4) else int(rng.integers(8, 31))
            pts = sorted(rng.choice(np.arange(1, max(end, 2)),
                                    size=max(num_env - 1, 0), replace=False)
                         .tolist()) if num_env > 1 else []
            borders = pts + [end]
            for bp in borders:
                bw.put(5, int(bp))

        iq = self.iid_quant
        if self.enable_iid:
            lim = 7 + 8 * iq
            for e in range(num_env):
                dt = int(self.allow_dt and not (first and e == 0)
                         and not (force_df and e == 0)
                         and rng.integers(0, 2))
                bw.put1(dt)
                tab = [PSyn.HUFF_IID_DF0, PSyn.HUFF_IID_DF1,
                       PSyn.HUFF_IID_DT0, PSyn.HUFF_IID_DT1][2 * dt + iq]
                from ..ref.bitstream.ps_syntax import huff_offset
                self._write_par(bw, self.iid, self.nr_iid_par, e, dt, tab,
                                huff_offset(tab), -lim, lim)
        else:
            self.iid[:] = 0
        if self.enable_icc:
            for e in range(num_env):
                dt = int(self.allow_dt and not (first and e == 0)
                         and not (force_df and e == 0)
                         and rng.integers(0, 2))
                bw.put1(dt)
                tab = PSyn.HUFF_ICC_DT if dt else PSyn.HUFF_ICC_DF
                from ..ref.bitstream.ps_syntax import huff_offset
                self._write_par(bw, self.icc, self.nr_icc_par, e, dt, tab,
                                huff_offset(tab), 0, 7)
        else:
            self.icc[:] = 0

        if self.enable_ipdopd:  # ext container with ipdopd extension
            sub = BitWriter()
            sub.put1(1)  # enable_ipdopd
            for e in range(num_env):
                dt = int(self.allow_dt and not (first and e == 0)
                         and not (force_df and e == 0)
                         and rng.integers(0, 2))
                sub.put1(dt)
                self._write_par(sub, self.ipd, self.nr_ipdopd_par, e, dt,
                                PSyn.HUFF_IPD_DT if dt else PSyn.HUFF_IPD_DF,
                                0, 0, 7, mask=0x07)
                dt = int(self.allow_dt and not (first and e == 0)
                         and not (force_df and e == 0)
                         and rng.integers(0, 2))
                sub.put1(dt)
                self._write_par(sub, self.opd, self.nr_ipdopd_par, e, dt,
                                PSyn.HUFF_OPD_DT if dt else PSyn.HUFF_OPD_DF,
                                0, 0, 7, mask=0x07)
            sub.put1(0)  # reserved_ps
            total = 2 + sub.nbits
            cnt = (total + 7) // 8
            if cnt >= 15:
                bw.put(4, 15)
                bw.put(8, cnt - 15)
            else:
                bw.put(4, cnt)
            bw.put(2, 0)  # ps extension id 0 carries ipd/opd (aacps.c:120-126)
            bw.extend(sub)
            bw.put(cnt * 8 - total, 0)

        # mirror the decoder's fake-envelope fixup (aacps.c:234-252)
        if not num_env or (borders and borders[-1] < 31) or (fc and not borders):
            source = num_env - 1 if num_env else self.num_env_old - 1
            if source >= 0 and source != num_env:
                if self.enable_iid:
                    self.iid[num_env] = self.iid[source]
                if self.enable_icc:
                    self.icc[num_env] = self.icc[source]
                if self.enable_ipdopd:
                    self.ipd[num_env] = self.ipd[source]
                    self.opd[num_env] = self.opd[source]
            num_env += 1
        self.num_env = num_env
        self.frame_idx += 1
        return bw
