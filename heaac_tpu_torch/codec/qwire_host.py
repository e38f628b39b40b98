"""Host-side qwire writers of the Python planner (numpy only).

Port copies, names as there:
  - ``heaac_tpu/codec/qwire.py:216-510``: emit_coeff_tokens, build_side,
    pack_nibbles, build_header, assemble_lane, assemble_spec_lane,
    sfidx_from_sf, extract_bits (PS_KIND_OF beside them);
  - ``heaac_tpu/ops/spec_huff.py:139-271``: BitWriter, encode_section,
    the w3 flag bits and pack_spec_block, concat_bit_ranges;
  - ``heaac_tpu/ops/sbr_np.py:157-171``: BW_TAB and chirp, the chirp-factor
    recursion that build_side runs on the host.
The wire constants come from ``heaac_tpu_torch.host``; the device half
of the format is ``codec/qwire.py``.
"""
from __future__ import annotations

import functools

import numpy as np

from .. import tables as TB
from ..host import (H_FLAGS, H_KX1, H_LIMG, H_M1, H_N0, H_N1, H_NLIM,
                    H_NPATCH, H_NQ, H_TAB, HDR_MAX, PS_B0, PS_BORD, PS_HEAD,
                    PS_KND, PS_NE, PS_NIPD, PS_RB, PS_TOP, R_W1, R_W2, R_W3,
                    RAW_MAX, REC_W, SIDE_HEAD, SIDE_MAX, T_ESC1, T_ESC2,
                    T_PAIR0, T_QUAD0, T_RAW0, T_SETSF, T_SFD_BASE, T_SGL0,
                    T_ZRUN0, ZRUN_MAX)
from ..tables import TYPE_CPE, pow2sf_tab

_f32 = np.float32
SEC_MAX = 31          # wire bound: sections per lane (5-bit w3 field)
PS_KIND_OF = {0: 3, 10: 0, 20: 1, 34: 2}


BW_TAB = np.array([0.0, 0.75, 0.9, 0.98], np.float32)


def chirp(sbr, ch_data) -> None:
    """aacsbr.c:1316-1334."""
    for i in range(sbr.n_q):
        if ch_data.bs_invf_mode[0][i] + ch_data.bs_invf_mode[1][i] == 1:
            new_bw = _f32(0.6)
        else:
            new_bw = BW_TAB[ch_data.bs_invf_mode[0][i]]
        if new_bw < ch_data.bw_array[i]:
            new_bw = _f32(_f32(0.75) * new_bw
                          + _f32(0.25) * ch_data.bw_array[i])
        else:
            new_bw = _f32(_f32(0.90625) * new_bw
                          + _f32(0.09375) * ch_data.bw_array[i])
        ch_data.bw_array[i] = _f32(0.0) if new_bw < 0.015625 else new_bw


def emit_coeff_tokens(coef: np.ndarray, q: np.ndarray | None = None,
                      sfw: np.ndarray | None = None,
                      raw: np.ndarray | None = None):
    """Tokenize one 1024-coefficient lane -> (tokens u8, ext u8).

    q[1024] i32: quantized values (sign included); sfw[1024] u16: per-bin
    scalefactor word (bits0-8 pow2sf index, bit15 positive sign) valid where
    q != 0; raw[1024] bool: ship coef bits verbatim.  With q/sfw None the
    whole lane is shipped raw (Python-planner fallback lanes)."""
    toks = bytearray()
    ext = bytearray()
    if q is None:
        raw = np.ones(1024, bool)
        q = np.zeros(1024, np.int32)
        sfw = np.zeros(1024, np.uint16)
    raw = raw.astype(bool) if raw is not None else np.zeros(1024, bool)
    zero = (q == 0) & ~raw & (coef == 0)
    # positions that disagree with their q representation must go raw:
    # a q==0 bin with a nonzero coefficient has no token representation,
    # so auto-promote it into the raw set (the native emitter maintains
    # this invariant itself; this guards tooling/test callers)
    raw = raw | ((q == 0) & (np.asarray(coef) != 0))
    cur_sf = -1
    p = 0
    while p < 1024:
        if zero[p]:
            n = 1
            while p + n < 1024 and zero[p + n]:
                n += 1
            while n > 0:
                step = min(n, ZRUN_MAX)
                toks.append(T_ZRUN0 - 1 + step)
                n -= step
                p += step
            continue
        if raw[p]:
            n = 1
            while n < RAW_MAX and p + n < 1024 and raw[p + n]:
                n += 1
            toks.append(T_RAW0 + n)
            ext.extend(np.asarray(coef[p:p + n], np.float32).tobytes())
            p += n
            continue
        # plain value position: ensure sf in effect (1-byte delta when
        # the sign matches and the index step is small — the common case)
        if int(sfw[p]) != cur_sf:
            new_sf = int(sfw[p])
            d = new_sf - cur_sf if cur_sf >= 0 else 1 << 20
            if -11 <= d <= 10 and (new_sf & 0x8000) == (cur_sf & 0x8000):
                toks.append(T_SFD_BASE + d)
            else:
                toks.append(T_SETSF)
                ext.extend(int(new_sf).to_bytes(2, "little"))
            cur_sf = new_sf
        same = lambda i: (not zero[i]) and (not raw[i]) \
            and int(sfw[i]) == cur_sf
        v = int(q[p])
        # QUAD: 4 positions of |v|<=1 under one sf (zeros allowed inside)
        if (abs(v) <= 1 and p + 3 < 1024
                and all((zero[p + i] or same(p + i))
                        and abs(int(q[p + i])) <= 1 for i in range(4))):
            c = sum((int(q[p + i]) + 1) * 3 ** i for i in range(4))
            toks.append(T_QUAD0 + c)
            p += 4
            continue
        # PAIR: 2 positions of |v|<=3
        if (abs(v) <= 3 and p + 1 < 1024
                and (zero[p + 1] or (same(p + 1)
                                     and abs(int(q[p + 1])) <= 3))):
            v1 = int(q[p + 1])
            toks.append(T_PAIR0 + (v + 3) * 7 + (v1 + 3))
            p += 2
            continue
        av = abs(v)
        if 4 <= av <= 19:
            toks.append(T_SGL0 + ((v < 0) << 4) + (av - 4))
        elif av <= 127:
            toks.append(T_ESC1)
            ext.append(v & 0xFF)
        else:
            toks.append(T_ESC2)
            ext.extend(int(v & 0xFFFF).to_bytes(2, "little"))
        p += 1
    return bytes(toks), bytes(ext)


def build_side(sbr, ch: int, id_aac: int, err: int = 0,
               core_meta: dict | None = None, is34: int = 0) -> bytes:
    """SBR/PS side block for one lane (quantized codes, no host dequant).

    Mirrors compact_plan.build_sbr_compact's host-state advance (noise/sine
    phase) but ships the raw integer codes; mapping/dequant/chirp move into
    expand_frame.  ``sbr`` may be None (core-only / silence lane)."""
    b = bytearray(SIDE_HEAD)
    if core_meta is not None:
        b[0] = (int(core_meta.get("ws", 0)) & 3) \
            | ((int(core_meta.get("kbd", 0)) & 1) << 2) | ((err & 1) << 3)
    if sbr is None:
        return bytes(b)
    d = sbr.data[ch]
    coupled = int(id_aac == TYPE_CPE and sbr.bs_coupling)
    opt = bytearray()
    if int(sbr.kx[0]) != int(sbr.kx[1]) or int(sbr.m[0]) != int(sbr.m[1]):
        b[0] |= 1 << 7
        opt.append(int(sbr.kx[0]) & 0xFF)
        opt.append(int(sbr.m[0]) & 0xFF)
    if not sbr.start:
        return bytes(b + opt)
    ne = int(d.bs_num_env)
    b[0] |= ((1 * (not sbr.bs_smoothing_mode)) << 4) \
        | ((int(d.bs_amp_res) & 1) << 5)
    b[1] = (1 | (int(bool(sbr.reset)) << 1) | (coupled << 2)
            | ((coupled and ch == 1) << 3)
            | (int(bool(d.bs_add_harmonic_flag)) << 4))
    b[2] = ne | (int(d.bs_num_noise) << 3) | (int(d.f_indexsine) << 5)
    frbits = tqsel = 0
    for e in range(ne):
        if d.bs_freq_res[e + 1]:
            frbits |= 1 << e
        if d.bs_num_noise > 1 and d.t_env[e] >= d.t_q[1]:
            tqsel |= 1 << e
        b[5 + e] = int(d.t_env[e])
    for e in range(ne, 6):
        b[5 + e] = int(d.t_env[ne])
    b[3] = frbits | ((int(d.e_a[0]) + 1) << 5)
    b[4] = tqsel | ((int(d.e_a[1]) + 1) << 5)
    b[11:13] = int(d.f_indexnoise).to_bytes(2, "little")
    chirp(sbr, d)
    bw_now = np.asarray(d.bw_array[:5], np.float32).copy()
    prev = getattr(d, "wire_bw_prev", None)
    if prev is None or prev.tobytes() != bw_now.tobytes():
        b[0] |= 1 << 6
        opt.extend(bw_now.tobytes())
        d.wire_bw_prev = bw_now

    b = b + opt
    rows_fresh = int(getattr(sbr, "wire_rows_fresh", 0))
    rows_el = (id_aac != TYPE_CPE and ch == 0) or id_aac == TYPE_CPE
    if rows_el and rows_fresh:
        sbr.wire_rows_mode = 1       # latched: see he_host.inc Sbr
    if rows_el and int(getattr(sbr, "wire_rows_mode", 0)) \
            and not int(getattr(sbr, "wire_rows_datab", 0)):
        # wire v5 raw-rows block: u16 LE rbits(13)|phase(3), then the
        # byte-aligned dtdf..noise region (device decode, ops/sbr_huff).
        # b[1] bit 6 is the flip-graph is34 flag; raw-rows rides bit 7.
        # Dataless frames ship rbits=0: the device replays its carried
        # decoded rows (delta regions are not idempotent).  Coupled CPE
        # frames ship the SAME region on both lanes (the device decodes
        # both channels' chained rows per lane, pair=True graphs).
        b[1] |= 1 << 7
        if rows_fresh:
            rb = int(sbr.wire_rows_rbits)
            ph = int(sbr.wire_rows_bitoff)
            b.extend((rb | (ph << 13)).to_bytes(2, "little"))
            b.extend(sbr.wire_rows_region[:(rb + 7) // 8])
            if id_aac != TYPE_CPE or ch == 1:
                sbr.wire_rows_fresh = 0
        else:
            b.extend(b"\x00\x00")
    else:
        # env codes: main channel (ch0) first, pan channel second when
        # coupled (sbr_dequant consumes E1/E2 jointly for both outputs)
        chs = [0, 1] if coupled else [ch]
        for c in chs:
            dd = sbr.data[c]
            for e in range(1, ne + 1):
                n = int(sbr.n[d.bs_freq_res[e]])
                b.extend(int(dd.env_facs[e][k]) & 0xFF for k in range(n))
        for c in chs:
            dd = sbr.data[c]
            for e in range(1, int(d.bs_num_noise) + 1):
                b.extend(int(dd.noise_facs[e][k]) & 0xFF
                         for k in range(int(sbr.n_q)))
    if d.bs_add_harmonic_flag:
        bits = 0
        for i in range(int(sbr.n[1])):
            bits |= int(bool(d.bs_add_harmonic[i])) << i
        b.extend(bits.to_bytes(6, "little"))
    ps = getattr(sbr, "ps", None)
    if ps is not None and ps.start and ch == 0 and id_aac != TYPE_CPE:
        b[1] |= 1 << 5
        # bit 6: THIS frame's PS band mode.  The static per-mode scan
        # graphs ignore it; the flip-capable graph (decode_batch's
        # band-mode-flip route) reads it per lane per frame.
        if is34:
            b[1] |= 1 << 6
        fresh = int(getattr(ps, "wire_fresh", 0))
        pb = bytearray(PS_HEAD)
        pb[PS_B0] = (int(ps.num_env)
                     | (int(getattr(ps, "wire_header", 0) if fresh else 0)
                        << 3)
                     | (int(ps.iid_quant) << 4)
                     | ((int(ps.icc_mode) & 7) << 5))
        iid_knd = PS_KIND_OF[int(ps.nr_iid_par)] if ps.enable_iid else 3
        icc_knd = PS_KIND_OF[int(ps.nr_icc_par)] if ps.enable_icc else 3
        bitoff = int(getattr(ps, "wire_bitoff", 0)) if fresh else 0
        pb[PS_KND] = (iid_knd | (icc_knd << 2)
                      | (int(ps.enable_ext) << 4) | (bitoff << 5))
        pb[PS_NIPD] = int(ps.nr_ipdopd_par)
        pb[PS_TOP] = int(sbr.kx[1] + sbr.m[1])
        for e2 in range(min(int(ps.num_env) + 1, 6)):
            pb[PS_BORD + e2] = int(ps.border_position[e2]) & 0xFF
        rbits = int(getattr(ps, "wire_rbits", 0)) if fresh else 0
        pb[PS_NE] = ((int(getattr(ps, "wire_ne_pre", 0)) & 7) if fresh
                     else 0) | (fresh << 3) | (((rbits >> 8) & 15) << 4)
        pb[PS_RB] = rbits & 0xFF
        b.extend(pb)
        if fresh:
            b.extend(ps.wire_region[:(rbits + 7) // 8])
            ps.wire_fresh = 0
    # advance the host noise/sine phase exactly like the other builders
    nslots = 2 * (int(d.t_env[ne]) - int(d.t_env[0]))
    d.f_indexnoise = (d.f_indexnoise + nslots * int(sbr.m[1])) & 0x1FF
    d.f_indexsine = (d.f_indexsine + nslots) & 3
    assert len(b) <= SIDE_MAX, len(b)
    return bytes(b)


def pack_nibbles(vals) -> bytes:
    """Low nibble first; each value must fit 4 bits (caller biases)."""
    out = bytearray((len(vals) + 1) // 2)
    for i, v in enumerate(vals):
        assert 0 <= v <= 15, v
        out[i >> 1] |= v << (4 * (i & 1))
    return bytes(out)


def build_header(sbr) -> bytes:
    """Header block: frequency tables + patch map (ships on reset frames;
    carried on device between resets).  aacsbr.c:304-575 outputs."""
    b = bytearray(H_TAB)
    n0, n1 = int(sbr.n[0]), int(sbr.n[1])
    nq, nlim = int(sbr.n_q), int(sbr.n_lim)
    npat = int(sbr.num_patches)
    b[H_N0], b[H_N1], b[H_NQ], b[H_NLIM] = n0, n1, nq, nlim
    b[H_NPATCH] = npat
    b[H_KX1], b[H_M1] = int(sbr.kx[1]), int(sbr.m[1])
    b[H_FLAGS] = int(bool(sbr.bs_interpol_freq))
    b[H_LIMG] = int(sbr.bs_limiter_gains)
    for tab, n in ((sbr.f_tablelow, n0 + 1), (sbr.f_tablehigh, n1 + 1),
                   (sbr.f_tablenoise, nq + 1), (sbr.f_tablelim, nlim + 1)):
        b.extend(int(tab[i]) & 0xFF for i in range(n))
    b.extend(int(sbr.patch_start_subband[j]) & 0xFF for j in range(npat))
    b.extend(int(sbr.patch_num_subbands[j]) & 0xFF for j in range(npat))
    assert len(b) <= HDR_MAX, len(b)
    return bytes(b)


def assemble_lane(tokens: bytes, ext: bytes, side: bytes,
                  header: bytes = b"") -> tuple[bytes, np.ndarray]:
    """One frame-lane's heap payload + its 4-word record (tok_off 0)."""
    rec = np.zeros(REC_W, np.int32)
    rec[R_W1] = len(tokens) | (len(ext) << 16)
    rec[R_W2] = len(side) | (len(header) << 16)
    return tokens + ext + side + header, rec


def assemble_spec_lane(block: bytes, w3: int, side: bytes,
                       header: bytes = b"") -> tuple[bytes, np.ndarray]:
    """Spec-mode frame-lane: raw spectral bits + section map instead of
    tokens (ops/spec_huff.py decodes on device).  mode=1 in w2."""
    rec = np.zeros(REC_W, np.int32)
    rec[R_W1] = len(block)
    rec[R_W2] = len(side) | (len(header) << 16) | (1 << 24)
    rec[R_W3] = w3
    return block + side + header, rec


def sfidx_from_sf(sf: float) -> int | None:
    """Recover the pow2sf index from a normal-band scalefactor value
    (sf == -pow2sf_tab[idx]; the table is strictly monotonic)."""
    pow2 = pow2sf_tab()
    idx = int(np.searchsorted(pow2, np.float32(-sf)))
    if 0 <= idx < len(pow2) and pow2[idx] == np.float32(-sf):
        return idx
    return None


def extract_bits(data: bytes, start: int, end: int) -> bytes:
    """MSB-aligned copy of bits [start, end) of ``data``."""
    nbits = end - start
    if nbits <= 0:
        return b""
    b0, b1 = start >> 3, (end + 7) >> 3
    x = int.from_bytes(data[b0:b1], "big")
    seg_bits = (b1 - b0) * 8
    x >>= seg_bits - (start & 7) - nbits      # keep the wanted bits
    x &= (1 << nbits) - 1
    pad = (-nbits) % 8
    return (x << pad).to_bytes((nbits + 7) // 8, "big")


class BitWriter:
    def __init__(self):
        self.bits = []

    def put(self, val: int, n: int):
        for k in range(n - 1, -1, -1):
            self.bits.append((val >> k) & 1)

    def tobytes(self) -> bytes:
        n = len(self.bits)
        out = bytearray((n + 7) // 8)
        for i, b in enumerate(self.bits):
            out[i >> 3] |= b << (7 - (i & 7))
        return bytes(out)


@functools.cache
def _enc_tables(cb: int):
    codes, bits = TB.spectral_codes(cb)
    tup = TB.codebook_tuples(cb)
    dim, lav, signed = TB.CODEBOOK_INFO[cb]
    mod = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    idx_of = {}
    for ci in range(len(codes)):
        key = tuple(int(v) for v in tup[ci])
        idx_of[key] = ci
    return codes, bits, idx_of, dim, lav, signed


def encode_section(bw: BitWriter, cb: int, q: np.ndarray) -> None:
    """Append the spectral bits encoding integer values ``q`` (len % dim
    == 0) with codebook cb, reference bit order (code, signs, escapes)."""
    codes, bits, idx_of, dim, lav, signed = _enc_tables(cb)
    for k in range(0, len(q), dim):
        vals = [int(v) for v in q[k:k + dim]]
        if signed:
            key = tuple(vals)
            esc = []
        else:
            key = tuple(min(abs(v), 16) if cb == 11 else abs(v)
                        for v in vals)
            esc = [abs(v) for v in vals if cb == 11 and abs(v) >= 16]
        ci = idx_of[key]
        bw.put(int(codes[ci]), int(bits[ci]))
        if not signed:
            for v in vals:
                if v:
                    bw.put(1 if v < 0 else 0, 1)
        for av in esc:
            n = av.bit_length() - 1
            assert 4 <= n <= 12 and av < 8192
            bw.put((1 << (n - 4)) - 1, n - 4)   # N = n-4 ones
            bw.put(0, 1)
            bw.put(av - (1 << n), n)


# w3 flag bits (above the nbits/nsec/sfidx0 fields):
W3_MS_MASK = 1 << 27   # block carries an M/S band mask after the section map
W3_MS_LEFT = 1 << 28   # lane is the LEFT channel of a device-M/S CPE pair
W3_MS_RIGHT = 1 << 29  # lane is the RIGHT channel (mask rides the left lane)
W3_SHORT = 1 << 30     # EIGHT_SHORT lane: grouping byte leads the block


def pack_spec_block(sections, sfidx0: int, raw_bits: bytes, nbits: int,
                    ms_mask=None, grouping=None, phase: int = 0):
    """sections: list of (cb, nsfb, bitlen); sfidx0: the FIRST coded
    band's absolute pow2sf index (rides the record word — the raw sf
    region's first code is a delta vs global_gain, which sfidx0 already
    embodies).  ``raw_bits`` is ONE byte-aligned slice of the source
    bitstream spanning the lane's sf-huffman region through its spectral
    region — the two are contiguous up to the 3 always-zero pulse/tns/
    gain gate bits this capture path requires.  The sf chain starts at
    bit ``phase`` (0-7) of raw_bits[0] and the spectrum 3 bits after the
    sf chain ends (the device lifts the sf chain to find the boundary);
    a phase byte leads the raw region on the wire.  ``nbits`` counts the
    SPECTRAL bits only.  ``ms_mask``, if given, is the per-sfb M/S mask
    (length == total sfb count) packed MSB-first after the section map —
    the device butterflies the pair (aacdec.c:1390-1411) since raw-bits
    lanes ship PRE-M/S spectra.  ``grouping``, if given, marks an
    EIGHT_SHORT lane: the 7-bit scale_factor_grouping field leads the
    block and sections run (group, sfb)-major.  Returns (block bytes,
    w3) where w3 = nbits | nsec<<13 | sfidx0<<18 [| flags]."""
    b = bytearray()
    if grouping is not None:
        b.append(grouping & 0x7F)
    total_sfb = 0
    for cb, nsfb, blen in sections:
        assert 0 <= cb <= 11 and nsfb < 64 and blen < (1 << 14)
        u24 = cb | (nsfb << 4) | (blen << 10)
        b += u24.to_bytes(3, "little")
        total_sfb += nsfb
    ms_flag = 0
    if ms_mask is not None:
        assert len(ms_mask) == total_sfb
        mb = bytearray((total_sfb + 7) // 8)
        for f, v in enumerate(ms_mask):
            if v:
                mb[f >> 3] |= 1 << (7 - (f & 7))
        b += mb
        ms_flag = W3_MS_MASK
    assert 0 <= phase < 8
    b.append(phase)
    b += raw_bits
    assert nbits < (1 << 13) and len(sections) <= SEC_MAX
    assert 0 <= sfidx0 < 512
    w3 = nbits | (len(sections) << 13) | (int(sfidx0) << 18) | ms_flag
    if grouping is not None:
        w3 |= W3_SHORT
    return bytes(b), w3


def concat_bit_ranges(data: bytes, ranges) -> bytes:
    """Extract [a, b) bit ranges (MSB-first positions into ``data``) and
    concatenate them MSB-first into bytes (zero-padded tail)."""
    acc, n = 0, 0
    for a, b in ranges:
        nb = b - a
        if nb <= 0:
            continue
        want = ((b + 7) >> 3) - (a >> 3)
        seg = data[a >> 3:(b + 7) >> 3]
        if len(seg) < want:           # range tail past the buffer: zeros
            seg = seg + b"\0" * (want - len(seg))
        chunk = int.from_bytes(seg, "big")
        chunk >>= want * 8 - (a & 7) - nb
        chunk &= (1 << nb) - 1
        acc = (acc << nb) | chunk
        n += nb
    nbytes = (n + 7) // 8
    return (acc << (nbytes * 8 - n)).to_bytes(nbytes, "big")
