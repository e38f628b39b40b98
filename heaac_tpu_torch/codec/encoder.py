"""Port copy of ``heaac_tpu/codec/encoder.py``, host numpy like the
original: the port imports nothing of the JAX package, so it keeps its
own copy (tables and the IMDCT matrix from ``heaac_tpu_torch.tables``,
the AAC-Main predictor helpers from ``heaac_tpu_torch.bitstream``).
Names as there.  Its float64 / float32 numpy arithmetic decides which
bits are written, so it stays numpy: ``tests/test_torch_encoder.py``
holds its ADTS bytes equal to the JAX package's.

AAC encoder (secondary capability; reference aacenc.c/aaccoder.c/aacpsy.c).

A clean-room encoder producing spec-conformant AAC-LC and AAC-Main:

- **Window switching** (aacenc.c window decision + psy attack detection,
  aacpsy.c): high-pass attack detector over 128-sample sub-blocks drives a
  legal ONLY_LONG -> LONG_START -> EIGHT_SHORT -> LONG_STOP state machine;
  short frames are grouped around the attack position.
- **Psychoacoustic bit allocation** (3GPP-style, aacpsy.c): per-band
  masking thresholds from spread band energies (bark-domain two-sided
  spreading + absolute threshold), converted to per-band scalefactors.
- **Rate control** (aacenc.c:560-580 bit-reservoir analogue): a global
  quality lambda adapts per frame to hit the target bitrate, with bounded
  in-frame re-encoding when a frame lands far off target.
- **Codebook/section coding** (aaccoder.c): exact-bit-cost codebook choice
  per band among all admissible codebooks, greedy section merging.
- AAC-Main frequency-domain prediction with a mirrored decoder state
  machine (aacdec.c:1271-1322); short frames reset all predictors exactly
  like the decoder (apply_prediction's EIGHT_SHORT branch).

TPU-first layout: the analysis MDCTs for all window sequences are constant
matrices (adjoints of this framework's reference-validated synthesis path,
perfect reconstruction ~1e-7), so a whole stream's filterbank is a single
batched matmul; psy energies/thresholds are vectorized over frames.
"""
from __future__ import annotations

import functools

import numpy as np

from .. import tables as T
from ..io.adts import mux_adts
from ..io.bitwriter import BitWriter

MAX_QUANT = 8191
ONLY_LONG, LONG_START, EIGHT_SHORT, LONG_STOP = 0, 1, 2, 3


# ---------------------------------------------------------------------------
# Analysis filterbank: forward MDCT per window sequence
# ---------------------------------------------------------------------------
def _S_pattern(n2: int, r: np.ndarray, f: np.ndarray) -> np.ndarray:
    """[n2, 2*n2] synthesis-contribution matrix: imdct_half output ->
    windowed time contribution (rising window r, falling window f, both
    length n2).  Mirrors the decoder's extension symmetry + fmul_window
    (ops/windowing.py; dsputil.c:3832)."""
    q = n2 // 2
    S = np.zeros((n2, 2 * n2))
    i = np.arange(q)
    S[q - 1 - i, i] = -r[i]
    S[i, q + i] = r[q + i]
    S[q + i, n2 + i] = f[i]
    S[q + q - 1 - i, n2 + q + i] = f[q + i]
    return S


@functools.cache
def _forward_matrices() -> dict:
    """ws -> [2048, 1024] float32 forward transform (windowing + MDCT),
    the exact adjoint of the decoder synthesis for that window sequence
    (sine windows).  Verified perfect-reconstruction vs codec/core.py."""
    from ..tables import imdct_half_matrix

    sl = T.sine_window(1024).astype(np.float64)
    ss = T.sine_window(128).astype(np.float64)
    M1024 = imdct_half_matrix(1024, 1.0).astype(np.float64)
    M128 = imdct_half_matrix(128, 1.0).astype(np.float64)
    ones, zeros = np.ones(448), np.zeros(448)
    F = {
        ONLY_LONG: (M1024 @ _S_pattern(1024, sl, sl[::-1])).T / 512.0,
        LONG_START: (M1024 @ _S_pattern(
            1024, sl, np.concatenate([ones, ss[::-1], zeros]))).T / 512.0,
        LONG_STOP: (M1024 @ _S_pattern(
            1024, np.concatenate([zeros, ss, ones]), sl[::-1])).T / 512.0,
    }
    Fs = np.zeros((2048, 1024))
    blk = (M128 @ _S_pattern(128, ss, ss[::-1])).T / 64.0
    for k in range(8):
        Fs[448 + 128 * k:448 + 128 * k + 256, 128 * k:128 * k + 128] = blk
    F[EIGHT_SHORT] = Fs
    return {k: v.astype(np.float32) for k, v in F.items()}


# ---------------------------------------------------------------------------
# Window decision (psy attack detection; aacpsy.c window switching)
# ---------------------------------------------------------------------------
def decide_window_sequences(pcm: np.ndarray, nframes: int,
                            attack_ratio: float = 10.0):
    """pcm float [n, ch] (without lead-in) -> (ws [nframes+1],
    attack_pos [nframes+1]).  Frame t transforms padded samples
    [t*1024, t*1024+2048) where padded has a 1024-sample lead-in."""
    mono = pcm.mean(axis=1) if pcm.ndim == 2 else pcm
    hp = np.diff(mono, prepend=mono[:1])          # crude high-pass
    nblk = (len(hp) + 127) // 128
    e = np.zeros(nblk + 16)
    padded_hp = np.pad(hp, (0, nblk * 128 - len(hp)))
    e[:nblk] = (padded_hp.reshape(-1, 128) ** 2).sum(axis=1)
    # running mean of the previous 8 sub-blocks
    csum = np.concatenate([[0.0], np.cumsum(e)])
    prev_mean = np.array([
        (csum[i] - csum[max(i - 8, 0)]) / max(min(i, 8), 1)
        for i in range(len(e))])
    attack = e > attack_ratio * np.maximum(prev_mean, 1e-3 * e.max() + 1e-9)

    n = nframes + 1
    short = np.zeros(n, bool)
    pos = np.zeros(n, np.int64)
    for t in range(n):
        # frame t covers padded [t*1024, t*1024+2048) = pcm [(t-1)*1024, ...)
        # its 8 short transforms live in the middle region
        lo_blk = (t - 1) * 8 + 3       # padded offset 448 onward, 128 grid
        hits = [b for b in range(max(lo_blk, 0), min(lo_blk + 9, len(e)))
                if attack[b]]
        if hits:
            short[t] = True
            pos[t] = int(np.clip(hits[0] - lo_blk, 0, 7))
    ws = np.zeros(n, np.int64)
    prev = ONLY_LONG
    for t in range(n):
        nxt = short[t + 1] if t + 1 < n else False
        if short[t]:
            cur = EIGHT_SHORT
        elif prev == EIGHT_SHORT:
            cur = EIGHT_SHORT if nxt else LONG_STOP
        elif nxt:
            cur = LONG_START
        else:
            cur = ONLY_LONG
        ws[t] = cur
        prev = cur
    return ws, pos


def _group_layout(attack_pos: int) -> list[int]:
    """Window grouping around the attack sub-block (aacenc.c grouping)."""
    a = int(np.clip(attack_pos, 0, 7))
    groups = [g for g in (a, 1, 7 - a) if g > 0]
    return groups if groups else [8]


# ---------------------------------------------------------------------------
# Psychoacoustic thresholds (3GPP-style; aacpsy.c)
# ---------------------------------------------------------------------------
def _bark(f_hz: np.ndarray) -> np.ndarray:
    return 13.3 * np.arctan(0.00076 * f_hz) \
        + 3.5 * np.arctan((f_hz / 7500.0) ** 2)


def _psy_thresholds(band_en: np.ndarray, centers_hz: np.ndarray,
                    widths: np.ndarray,
                    tonality: np.ndarray | None = None) -> np.ndarray:
    """Band energies -> masking thresholds (same units).

    Two-sided bark-domain spreading (30 dB/bark toward lower bands,
    15 dB/bark toward higher), tonality-dependent masker SNR (6 dB for
    noise-like bands up to 24 dB for tonal, the 3GPP TMN/NMT idea),
    floored at an absolute threshold scaled to the int16 PCM convention."""
    nb = len(band_en)
    bv = _bark(centers_hz)
    spread = band_en.astype(np.float64).copy()
    for b in range(1, nb):          # masking spreading upward in frequency
        db = bv[b] - bv[b - 1]
        spread[b] = max(spread[b], spread[b - 1] * 10 ** (-1.5 * db))
    for b in range(nb - 2, -1, -1):  # downward
        db = bv[b + 1] - bv[b]
        spread[b] = max(spread[b], spread[b + 1] * 10 ** (-3.0 * db))
    snr_db = 18.0 if tonality is None else 6.0 + 18.0 * tonality
    thr = spread * 10.0 ** (-snr_db / 10.0)
    # absolute threshold: ~ -84 dBFS per coefficient on the +-32768 scale
    ath = (32768.0 * 10 ** (-84.0 / 20.0)) ** 2 * widths
    return np.maximum(thr, ath)


def _band_tonality(bands: list[np.ndarray]) -> np.ndarray:
    """Per-band tonality in [0,1] via spectral flatness (geometric vs
    arithmetic mean of coefficient power): 1 = a pure tone dominates the
    band, 0 = white-noise-like.  Stand-in for aacpsy.c's predictability
    measure."""
    out = np.zeros(len(bands))
    for i, c in enumerate(bands):
        p = c.astype(np.float64) ** 2
        am = p.mean() + 1e-12
        gm = np.exp(np.log(p + 1e-12).mean())
        out[i] = np.clip(1.0 - gm / am, 0.0, 1.0) ** 2
    return out


# ---------------------------------------------------------------------------
# Quantization / codebook / bit-cost primitives (aaccoder.c analogues)
# ---------------------------------------------------------------------------
@functools.cache
def _enc_vlc(cb: int):
    codes, bits = T.spectral_codes(cb)
    return codes.astype(np.int64), bits.astype(np.int64)


@functools.cache
def _sf_vlc_enc():
    codes, bits = T.scalefactor_codes()
    return codes.astype(np.int64), bits.astype(np.int64)


def _quantize(c: np.ndarray, sf_idx: int, sf_bias: int = 140) -> np.ndarray:
    """AAC quantizer: q = sign * floor(|c * 2^(-(sf-bias)/4)|^(3/4)+0.4054);
    the decoder reconstructs coef = -sign(q)*|q|^(4/3)*2^((sf-bias)/4)
    (aacdec.c:816 with the no-bias sf_offset; bias 128 for EIGHT_SHORT via
    the +12 offset at aac_syntax.decode_scalefactors), so the encoder
    flips sign."""
    step = 2.0 ** (-(sf_idx - sf_bias) / 4.0)
    mag = np.floor(np.abs(c * step) ** 0.75 + 0.4054)
    mag = np.minimum(mag, MAX_QUANT)
    return (-np.sign(c) * mag).astype(np.int64)


def _dequantize(q: np.ndarray, sf_idx: int, sf_bias: int = 140) -> np.ndarray:
    step = np.float32(2.0 ** ((sf_idx - sf_bias) / 4.0))
    return (-np.sign(q) * np.abs(q).astype(np.float32) ** (4.0 / 3.0)
            * step).astype(np.float32)


def _band_sf_limit(c: np.ndarray, sf_bias: int) -> int:
    """Smallest sf (coarsest valid quantization) with max|q| <= MAX_QUANT."""
    peak = np.abs(c).max()
    if peak == 0:
        return 0
    # max|q| = (peak / 2^((sf-bias)/4))^(3/4) <= MAX_QUANT; _quantize clamps
    # at MAX_QUANT, so test the raw magnitude to avoid silent peak clipping
    sf = sf_bias + 4 * (np.log2(max(peak, 1e-9))
                        - (4.0 / 3.0) * np.log2(MAX_QUANT))
    sf = int(np.ceil(sf)) - 1
    while sf < 255:
        raw = np.floor((peak * 2.0 ** (-(sf - sf_bias) / 4.0)) ** 0.75
                       + 0.4054)
        if raw <= MAX_QUANT:
            break
        sf += 1
    return int(np.clip(sf, 0, 255))


def _band_sf_for_noise(c: np.ndarray, allowed: float, sf_bias: int) -> int:
    """Choose sf so band quantization noise <= allowed (measured search,
    the inner loop of aaccoder.c's scalefactor search)."""
    en = float((c.astype(np.float64) ** 2).sum())
    peak = float(np.abs(c).max())
    if peak == 0.0 or en <= allowed:
        # the all-zero band already meets the threshold: any sf coarse
        # enough to zero the band works (band_type becomes ZERO_BT)
        return int(np.clip(np.ceil(sf_bias + 4 * np.log2(peak + 1e-12)) + 4,
                           0, 255))
    lo = _band_sf_limit(c, sf_bias)
    hi = int(np.clip(np.ceil(sf_bias + 4 * np.log2(peak)) + 4, lo, 255))

    def noise(s):
        q = _quantize(c, s, sf_bias)
        return float(((c - _dequantize(q, s, sf_bias)) ** 2).sum())

    if noise(lo) > allowed:
        return lo
    # bisect for the coarsest sf still under the noise budget (noise is
    # monotone in sf to within quantizer granularity)
    while hi - lo > 1:
        mid = (lo + hi) // 2
        if noise(mid) <= allowed:
            lo = mid
        else:
            hi = mid
    return lo


_CB_CANDIDATES = {  # amax threshold -> admissible codebooks (unsigned pairs
    # use sign bits; aactab.c codebook parameters)
    1: (1, 2),
    2: (3, 4),
    4: (5, 6),
    7: (7, 8),
    12: (9, 10),
    16: (11,),
}


def _band_bits(q: np.ndarray, cb: int) -> int:
    """Exact spectral bit count for band q under codebook cb."""
    if cb == 0:
        return 0
    codes, bits = _enc_vlc(cb)
    dim, lav, signed = T.CODEBOOK_INFO[cb]
    mod = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    total = 0
    for k in range(0, len(q), dim):
        tup = q[k:k + dim]
        idx = 0
        for v in tup:
            av = int(v)
            if not signed:
                av = min(abs(av), 16 if cb == 11 else lav)
                idx = idx * mod + av
            else:
                idx = idx * mod + (av + off)
        total += int(bits[idx])
        if not signed:
            for v in tup:
                if v:
                    total += 1
                if cb == 11 and abs(int(v)) >= 16:
                    total += 2 * (abs(int(v)).bit_length() - 1) - 3
    return total


def _codebook_for(q: np.ndarray) -> int:
    """Cheapest admissible codebook by exact bit count (aaccoder.c
    codebook_trellis step, greedy per band)."""
    amax = int(np.abs(q).max()) if len(q) else 0
    if amax == 0:
        return 0
    cands: list[int] = []
    for t, cbs in _CB_CANDIDATES.items():
        if amax <= t:
            cands.extend(cbs)
            if len(cands) >= 4:
                break
    if 11 not in cands:
        cands.append(11)
    # signed two-value books need even lengths (they do: bands are multiples
    # of 4); pick min cost
    return min(cands, key=lambda cb: _band_bits(q, cb))


def _write_band(bw: BitWriter, q: np.ndarray, cb: int) -> None:
    codes, bits = _enc_vlc(cb)
    dim, lav, signed = T.CODEBOOK_INFO[cb]
    mod = 2 * lav + 1 if signed else lav + 1
    off = lav if signed else 0
    for k in range(0, len(q), dim):
        tup = q[k:k + dim]
        if signed:
            idx = 0
            for v in tup:
                idx = idx * mod + (int(v) + off)
            bw.put(int(bits[idx]), int(codes[idx]))
        else:
            idx = 0
            esc = []
            for v in tup:
                av = min(abs(int(v)), 16 if cb == 11 else lav)
                idx = idx * mod + av
                if cb == 11 and abs(int(v)) >= 16:
                    esc.append(abs(int(v)))
            bw.put(int(bits[idx]), int(codes[idx]))
            for v in tup:  # sign bits for nonzero, spectral order
                if v:
                    bw.put1(1 if v < 0 else 0)
            for av in esc:  # escape sequences after the signs
                n = av.bit_length() - 1
                bw.put(n - 4, (1 << (n - 4)) - 1)  # n-4 ones
                bw.put(1, 0)
                bw.put(n, av - (1 << n))


# ---------------------------------------------------------------------------
# ANMR trellis search (aaccoder.c:476 search_for_quantizers_anmr +
# aaccoder.c:258 encode_window_bands_info, re-expressed): a scalefactor
# Viterbi whose transition costs are the exact scalefactor-delta VLC bits
# and whose node costs are lambda-weighted quantization distortion plus
# exact spectral bits, followed by a codebook run trellis that jointly
# minimizes section_data run bits and spectral bits.
# ---------------------------------------------------------------------------
_BITS_INF = 1 << 30
_N_STATES = 61            # TRELLIS_STATES analogue: max legal sf delta is 60


def _band_bits_states(qmat: np.ndarray, cb: int) -> np.ndarray:
    """Exact spectral bit counts for S quantizations of one band under
    codebook cb (vectorized `_band_bits`).  qmat: [S, n] int64.  States the
    codebook cannot represent return _BITS_INF."""
    _, bits = _enc_vlc(cb)
    dim, lav, signed = T.CODEBOOK_INFO[cb]
    mod = 2 * lav + 1 if signed else lav + 1
    S, n = qmat.shape
    a = np.abs(qmat)
    amax = a.max(axis=1) if n else np.zeros(S, np.int64)
    if signed:
        # clamp for the table gather; out-of-range states are masked via ok
        v = np.clip(qmat, -lav, lav) + lav
        ok = amax <= lav
    else:
        v = np.minimum(a, 16 if cb == 11 else lav)
        ok = np.ones(S, bool) if cb == 11 else (amax <= lav)
    t = v.reshape(S, n // dim, dim)
    idx = np.zeros((S, n // dim), np.int64)
    for d in range(dim):
        idx = idx * mod + t[:, :, d]
    total = bits[idx].sum(axis=1).astype(np.int64)
    if not signed:
        total = total + (a != 0).sum(axis=1)         # sign bits
        if cb == 11:
            # escape sequence: (bit_length-5) ones + 0 + (bit_length-1)
            # value bits = 2*(bit_length-1)-3 extra (matches _write_band)
            esc = a >= 16
            if esc.any():
                bl = np.frexp(np.maximum(a, 1).astype(np.float64))[1]
                total = total + np.where(esc, 2 * (bl - 1) - 3, 0).sum(axis=1)
    return np.where(ok, total, _BITS_INF)


def _cb_candidates_for_amax(amax: int) -> list[int]:
    """Admissible codebooks for a band whose max |q| is amax (1..8191)."""
    cands = [cb for cb, (_, lav, _) in T.CODEBOOK_INFO.items()
             if amax <= lav]
    if 11 not in cands:
        cands.append(11)
    return cands


def _anmr_band_table(c: np.ndarray, states: np.ndarray,
                     sf_bias: int) -> tuple[np.ndarray, np.ndarray, list]:
    """Per-state (distortion, best spectral bits) for one band over all
    candidate scalefactor states; lambda-independent, so computed once per
    frame and reused across the rate loop's Viterbi passes.

    Returns (dist[S] f64, bits[S] i64, qs[S] list of int64 arrays)."""
    S = len(states)
    step = 2.0 ** (-(states[:, None].astype(np.float64) - sf_bias) / 4.0)
    mag = np.minimum(np.floor(np.abs(c[None, :] * step) ** 0.75 + 0.4054),
                     MAX_QUANT)
    qmat = (-np.sign(c[None, :]) * mag).astype(np.int64)
    istep = (2.0 ** ((states.astype(np.float64) - sf_bias)
                     / 4.0)).astype(np.float32)
    deq = ((-np.sign(qmat) * np.abs(qmat).astype(np.float32) ** (4.0 / 3.0))
           .astype(np.float32) * istep[:, None]).astype(np.float32)
    dist = ((c[None, :].astype(np.float64) - deq) ** 2).sum(axis=1)
    amax = np.abs(qmat).max(axis=1) if qmat.shape[1] else np.zeros(S, np.int64)
    bits = np.full(S, _BITS_INF, np.int64)
    nz = amax[amax > 0]
    # union of per-state admissible books = books for the smallest nonzero
    # amax (inadmissible (state, cb) pairs come back as _BITS_INF)
    bits_all = {}
    for cb in _cb_candidates_for_amax(int(nz.min()) if len(nz) else 1):
        bits_all[cb] = _band_bits_states(qmat, cb)
        bits = np.minimum(bits, bits_all[cb])
    # all-zero states: 0 spectral bits (the run trellis decides whether the
    # band rides a neighboring section or becomes ZERO_BT)
    bits = np.where(amax == 0, 0, bits)
    return dist, bits, [qmat[s] for s in range(S)], bits_all


@functools.cache
def _zero_band_bits(n: int, cb: int) -> int:
    """Spectral bits for an all-zero band of width n under codebook cb."""
    return int(_band_bits_states(np.zeros((1, n), np.int64), cb)[0])


def _rethread_sfs(cbs, sfs, had_sf) -> int:
    """After a codebook-run trellis changes the coded-band set: bands
    promoted from all-zero into a section ride the previous coded band's
    scalefactor (delta 0), demoted bands drop theirs.  Returns the
    global_gain (the first coded band's sf).  Shared by the twoloop and
    ANMR coders (aaccoder.c:258 section layout aftermath)."""
    nbands = len(cbs)
    last = None
    for i in range(nbands):
        if cbs[i] == 0:
            sfs[i] = 0
            continue
        if had_sf[i]:
            last = int(sfs[i])
        elif last is not None:
            sfs[i] = last
    first = next((i for i in range(nbands) if cbs[i]), None)
    if first is not None and not had_sf[first]:
        nxt = next((int(sfs[i]) for i in range(first, nbands)
                    if cbs[i] and had_sf[i]), 100)
        for i in range(first, nbands):
            if cbs[i] and not had_sf[i]:
                sfs[i] = nxt
            elif had_sf[i]:
                break
    return int(sfs[first]) if first is not None else 100


def _codebook_run_trellis(band_cost: np.ndarray, is8: bool) -> np.ndarray:
    """Optimal section layout for one window group: Viterbi over
    (band, codebook) where staying in a codebook extends the current run
    (run-escape bits accounted exactly) and switching pays 4+run_bits
    (encode_window_bands_info, aaccoder.c:258-357).  Zero bands may join a
    neighboring nonzero section (paying the all-zero codewords plus one
    delta-0 scalefactor code) when that beats closing and reopening a run.
    band_cost: [nb, 12] spectral(+scalefactor) bits per (band, codebook),
    _BITS_INF where inadmissible.  Returns cbs[nb] int64."""
    nb, ncb = band_cost.shape
    run_bits = 3 if is8 else 5
    resc = (1 << run_bits) - 1
    cost = np.full(ncb, np.inf)
    run = np.zeros(ncb, np.int64)
    prev = np.full((nb, ncb), -1, np.int64)
    stay = np.zeros((nb, ncb), bool)
    for cb in range(ncb):
        if band_cost[0, cb] < _BITS_INF:
            cost[cb] = 4 + run_bits + band_cost[0, cb]
            run[cb] = 1
    for b in range(1, nb):
        ncost = np.full(ncb, np.inf)
        nrun = np.zeros(ncb, np.int64)
        best_from = int(np.argmin(cost))
        for cb in range(ncb):
            if band_cost[b, cb] >= _BITS_INF:
                continue
            # stay: extend the run (extra run_bits each time the length
            # crosses a run-escape boundary: bits(r) = run_bits*(r//resc+1))
            c_stay = cost[cb] + band_cost[b, cb] \
                + (run_bits if (run[cb] + 1) % resc == 0 else 0)
            # switch: close the best previous section, open a new one
            c_switch = cost[best_from] + band_cost[b, cb] + 4 + run_bits
            if c_stay <= c_switch:
                ncost[cb], nrun[cb] = c_stay, run[cb] + 1
                prev[b, cb], stay[b, cb] = cb, True
            else:
                ncost[cb], nrun[cb] = c_switch, 1
                prev[b, cb], stay[b, cb] = best_from, False
        cost, run = ncost, nrun
    cbs = np.zeros(nb, np.int64)
    cb = int(np.argmin(cost))
    for b in range(nb - 1, -1, -1):
        cbs[b] = cb
        cb = int(prev[b, cb])
    return cbs


class AacEncoder:
    """AAC encoder: int16 PCM [n, ch] -> ADTS bytes.

    object_type 2 = LC (default); 1 = Main with frequency-domain
    prediction (the encoder mirrors the decoder's predictor state,
    aacdec.c:1271-1322, and codes residuals).

    With ``bitrate`` set, the psy model + rate control drive per-band
    scalefactors toward masking thresholds at the target rate; otherwise
    ``qstep`` fixes a uniform quantization quality."""

    def __init__(self, sample_rate: int, channels: int, qstep: int = 28,
                 object_type: int = 2, bitrate: int | None = None,
                 window_switching: bool = True,
                 tns_inject: dict | None = None, coder: str = "twoloop",
                 ms: bool = False, intensity: bool = False):
        if channels not in (1, 2):
            raise ValueError("mono or stereo only")
        if (ms or intensity) and (channels != 2 or object_type != 2):
            raise ValueError("stereo tools need a stereo LC stream")
        self.ms = ms
        self.intensity = intensity
        if coder not in ("twoloop", "anmr"):
            raise ValueError("coder must be 'twoloop' or 'anmr'")
        self.coder = coder
        if object_type not in (1, 2):
            raise ValueError("AAC-LC or AAC-Main only")
        sr = np.asarray(T.SAMPLE_RATES)
        idx = np.where(sr == sample_rate)[0]
        if not len(idx):
            raise ValueError(f"unsupported sample rate {sample_rate}")
        self.sampling_index = int(idx[0])
        self.sample_rate = sample_rate
        self.channels = channels
        self.qstep = qstep
        self.object_type = object_type
        self.bitrate = bitrate
        self.window_switching = window_switching
        # test-vector TNS (the reference encoder never writes TNS,
        # aacenc.c:453, so golden TNS coverage needs an injector): emit a
        # fixed one-filter tns_data on every long-window ICS.  Keys:
        # coefs (list of coef-table indices), coef_res (0/1),
        # direction (0/1).  The decoder's AR filter amplifies — callers
        # keep input levels low so the oracle's int16 cannot wrap.
        self.tns_inject = tns_inject
        self.swb_long = T.swb_offset_1024(self.sampling_index)
        self.nswb_long = T.num_swb_1024(self.sampling_index)
        self.swb_short = T.swb_offset_128(self.sampling_index)
        self.nswb_short = T.num_swb_128(self.sampling_index)
        self.lam = 1.0                      # rate-control quality state
        if object_type == 1:
            from ..bitstream import aac_syntax as syn
            self._syn = syn
            self._pred_state = [syn.new_predictor_state()
                                for _ in range(channels)]
            self._pred_max = T.pred_sfb_max(self.sampling_index)
            self._frame_no = 0
            self._sf_scale = np.float32(1.0 / -1024.0)

    # ---------------- AAC-Main prediction --------------------------------
    def _predict_values(self, ch: int):
        """pv per bin from the mirrored decoder state (aacdec.c:1280-1283)."""
        syn = self._syn
        st = self._pred_state[ch]
        kmax = int(self.swb_long[min(self._pred_max, self.nswb_long)])
        cor0, cor1 = st[:kmax, 0], st[:kmax, 1]
        var0, var1 = st[:kmax, 2], st[:kmax, 3]
        r0, r1 = st[:kmax, 4], st[:kmax, 5]
        a = np.float32(0.953125)
        k1 = np.where(var0 > 1, cor0 * syn._flt16_even(a / var0),
                      0).astype(np.float32)
        k2 = np.where(var1 > 1, cor1 * syn._flt16_even(a / var1),
                      0).astype(np.float32)
        return syn._flt16_round((k1 * r0 + k2 * r1).astype(np.float32)), \
            k1, kmax

    def _predict_update(self, ch: int, dec_coef: np.ndarray, k1, kmax,
                        reset_group: int):
        """State update from the decoded spectra (aacdec.c:1287-1296)."""
        syn = self._syn
        st = self._pred_state[ch]
        alpha = np.float32(0.90625)
        a = np.float32(0.953125)
        r0, r1 = st[:kmax, 4].copy(), st[:kmax, 5].copy()
        e0 = (dec_coef[:kmax] / self._sf_scale).astype(np.float32)
        e1 = (e0 - k1 * r0).astype(np.float32)
        st[:kmax, 1] = syn._flt16_trunc(
            (alpha * st[:kmax, 1] + r1 * e1).astype(np.float32))
        st[:kmax, 3] = syn._flt16_trunc(
            (alpha * st[:kmax, 3]
             + np.float32(0.5) * (r1 * r1 + e1 * e1)).astype(np.float32))
        st[:kmax, 0] = syn._flt16_trunc(
            (alpha * st[:kmax, 0] + r0 * e0).astype(np.float32))
        st[:kmax, 2] = syn._flt16_trunc(
            (alpha * st[:kmax, 2]
             + np.float32(0.5) * (r0 * r0 + e0 * e0)).astype(np.float32))
        st[:kmax, 5] = syn._flt16_trunc((a * (r0 - k1 * e0)).astype(np.float32))
        st[:kmax, 4] = syn._flt16_trunc((a * e0).astype(np.float32))
        if reset_group:
            idxs = np.arange(reset_group - 1, syn.MAX_PREDICTORS, 30)
            st[idxs] = 0.0
            st[idxs, 2] = 1.0
            st[idxs, 3] = 1.0

    # ---------------- analyze / code / emit (per-channel ICS) ------------
    # The rate loop re-runs only the lambda-dependent coding step; the
    # filterbank, psy analysis, and prediction residual are computed once
    # per frame (analyze), and bits hit the BitWriter once (emit).
    def _analyze_ics(self, coefs: np.ndarray, ch: int, ws: int,
                     group_len: list[int]) -> dict:
        is8 = ws == EIGHT_SHORT
        offs = self.swb_short if is8 else self.swb_long
        nb = self.nswb_short if is8 else self.nswb_long
        ngroups = len(group_len) if is8 else 1
        if not is8:
            group_len = [1]
        an = dict(ch=ch, ws=ws, is8=is8, offs=offs, nb=nb, ngroups=ngroups,
                  group_len=group_len, sf_bias=128 if is8 else 140,
                  predicting=False)

        if self.object_type == 1 and not is8:
            pv, k1_arr, kmax = self._predict_values(ch)
            an.update(predicting=True, pv=pv, k1_arr=k1_arr, kmax=kmax,
                      reset_group=(self._frame_no % 30) + 1,
                      nmax=min(nb, self._pred_max),
                      pred_used=np.ones(min(nb, self._pred_max), np.int64))
            residual = coefs.copy()
            residual[:kmax] = (residual[:kmax]
                               - pv * self._sf_scale).astype(np.float32)
            coefs = residual

        # gather band slices per (group, sfb): concatenated window slices
        bands: list[np.ndarray] = []
        centers, widths = [], []
        hz_per_bin = self.sample_rate / (256.0 if is8 else 2048.0)
        w0 = 0
        for g in range(ngroups):
            for b in range(nb):
                off, off_len = int(offs[b]), int(offs[b + 1] - offs[b])
                parts = [coefs[(w0 + w) * 128 + off:
                               (w0 + w) * 128 + off + off_len]
                         for w in range(group_len[g])] if is8 \
                    else [coefs[off:off + off_len]]
                bands.append(np.concatenate(parts))
                centers.append((off + off_len / 2.0) * hz_per_bin)
                widths.append(len(bands[-1]))
            w0 += group_len[g]
        an["bands"] = bands
        if self.bitrate is not None:
            en = np.array([float((c.astype(np.float64) ** 2).sum())
                           for c in bands])
            cen = np.array(centers)
            wid = np.array(widths, np.float64)
            ton = _band_tonality(bands)
            # spreading is along frequency: apply per window group (the
            # concatenated band list restarts at DC every group)
            an["thr0"] = np.concatenate([
                _psy_thresholds(en[g * nb:(g + 1) * nb],
                                cen[g * nb:(g + 1) * nb],
                                wid[g * nb:(g + 1) * nb],
                                ton[g * nb:(g + 1) * nb])
                for g in range(ngroups)])
        return an

    def _code_ics(self, an: dict) -> dict:
        """lambda-dependent quantization + exact ICS bit count."""
        bands, sf_bias = an["bands"], an["sf_bias"]
        if self.bitrate is None:
            sfs = []
            for c in bands:
                peak = np.abs(c).max()
                if peak == 0:
                    sfs.append(0)
                    continue
                sf = sf_bias + 4 * (np.log2(max(peak, 1e-9))
                                    - (4.0 / 3.0) * np.log2(self.qstep))
                sf = int(np.ceil(sf))
                while np.abs(_quantize(c, sf, sf_bias)).max() > self.qstep \
                        and sf < 255:
                    sf += 1
                sfs.append(int(np.clip(sf, 0, 255)))
            sfs = np.array(sfs, np.int64)
        else:
            thr = an["thr0"] * self.lam
            sfs = np.array([_band_sf_for_noise(c, float(a), sf_bias)
                            for c, a in zip(bands, thr)], np.int64)
        qs = [_quantize(c, int(s), sf_bias) for c, s in zip(bands, sfs)]
        cbs = np.array([_codebook_for(q) for q in qs], np.int64)
        sfs = np.where(cbs == 0, 0, sfs)

        # clamp scalefactor deltas to +-60 (spec SCALE_MAX_DIFF)
        coded = np.nonzero(cbs)[0]
        for j in range(1, len(coded)):
            a, b = coded[j - 1], coded[j]
            lo, hi = sfs[a] - 60, sfs[a] + 60
            if not lo <= sfs[b] <= hi:
                sfs[b] = int(np.clip(sfs[b], lo, hi))
                qs[b] = np.clip(_quantize(bands[b], int(sfs[b]), sf_bias),
                                -MAX_QUANT, MAX_QUANT)
                cbs[b] = _codebook_for(qs[b])

        # codebook run trellis per window group: jointly minimal
        # section_data run bits + spectral bits over the FIXED q values
        # (encode_window_bands_info, aaccoder.c:258-357).  Per-band-
        # cheapest codebooks alternate every band and bloat section runs
        # (and overflow the wire's 24-section spec-mode bound).
        _, sf_bits_t = _sf_vlc_enc()
        sf0 = int(sf_bits_t[60])
        nbands = len(bands)
        nb, ngroups, is8 = an["nb"], an["ngroups"], an["is8"]
        band_cost = np.full((nbands, 12), float(_BITS_INF))
        had_sf = cbs != 0
        for i in range(nbands):
            q = qs[i]
            amax = int(np.abs(q).max()) if len(q) else 0
            if amax > 0:
                for cb in range(1, 12):
                    lav = T.CODEBOOK_INFO[cb][1]
                    if amax <= lav or cb == 11:
                        band_cost[i, cb] = _band_bits(q, cb)
            else:
                band_cost[i, 0] = 0.0
                for cb in range(1, 12):
                    band_cost[i, cb] = _zero_band_bits(len(q), cb) + sf0
        for g in range(ngroups):
            cbs[g * nb:(g + 1) * nb] = _codebook_run_trellis(
                band_cost[g * nb:(g + 1) * nb], is8)
        global_gain = _rethread_sfs(cbs, sfs, had_sf)
        bits = self._count_ics_bits(an, sfs, qs, cbs, global_gain)
        return dict(sfs=sfs, qs=qs, cbs=cbs, global_gain=global_gain,
                    bits=bits)

    # ---------------- ANMR trellis coder ----------------------------------
    def _anmr_tables(self, an: dict):
        """Lambda-independent per-band trellis tables, cached on the
        analysis dict: candidate scalefactor states (a 61-wide window, so
        every state pair is a legal +-60 delta), per-state distortion and
        exact spectral bits, and the scalefactor-delta transition-bit
        matrix (search_for_quantizers_anmr's paths[][] node/edge costs)."""
        if "anmr" in an:
            return an["anmr"]
        bands, sf_bias = an["bands"], an["sf_bias"]
        absall = [np.abs(c) for c in bands]
        nzmin = min((float(a[a > 0].min()) for a in absall
                     if np.any(a > 0)), default=0.0)
        qmax = max((float(a.max()) for a in absall), default=0.0)
        if qmax <= 0.0 or nzmin <= 0.0:
            an["anmr"] = None
            return None
        # finest state: min nonzero coef not clipped at MAX_QUANT;
        # coarsest: max coef still quantizes nonzero (aaccoder.c:506-509)
        q0low = int(np.clip(round(sf_bias + 4 * np.log2(nzmin)) - 69,
                            0, 255))
        q1high = int(np.clip(round(sf_bias + 4 * np.log2(qmax)) + 6,
                             0, 255))
        if q1high - q0low > _N_STATES - 1:
            en = sum(float((a.astype(np.float64) ** 2).sum())
                     for a in absall)
            cnt = sum(int((a > 0).sum()) for a in absall)
            qc = int(round(sf_bias + 2 * np.log2(en / max(cnt, 1)) - 28))
            q0 = int(np.clip(qc - 30, q0low, max(q0low, q1high - 60)))
        else:
            q0 = q0low
        states = np.clip(np.arange(q0, q0 + _N_STATES), 0, 255)
        _, sf_bits = _sf_vlc_enc()
        trans = sf_bits[(states[None, :] - states[:, None]) + 60] \
            .astype(np.float64)
        tabs = [_anmr_band_table(c, states, sf_bias) for c in bands]
        en = np.array([float((c.astype(np.float64) ** 2).sum())
                       for c in bands])
        an["anmr"] = dict(states=states, trans=trans, tabs=tabs, en=en)
        return an["anmr"]

    def _code_ics_anmr(self, an: dict) -> dict:
        """Trellis (Viterbi) scalefactor + codebook search: minimizes
        sum over bands of (distortion / effective-threshold) * weight +
        exact spectral bits + exact scalefactor-delta bits + exact
        section run bits (search_for_quantizers_anmr, aaccoder.c:476,
        re-expressed around this encoder's psy thresholds and the
        in-frame lambda rate loop)."""
        tb = self._anmr_tables(an)
        bands, sf_bias = an["bands"], an["sf_bias"]
        nbands = len(bands)
        if tb is None:
            qs = [np.zeros(len(c), np.int64) for c in bands]
            return dict(sfs=np.zeros(nbands, np.int64), qs=qs,
                        cbs=np.zeros(nbands, np.int64), global_gain=100,
                        bits=self._count_ics_bits(
                            an, np.zeros(nbands, np.int64), qs,
                            np.zeros(nbands, np.int64), 100))
        thr = np.maximum(np.asarray(an["thr0"], np.float64) * self.lam,
                         1e-30)
        states, trans, tabs = tb["states"], tb["trans"], tb["tabs"]
        # psy zero decision (aaccoder.c:553: energy <= threshold)
        coded = [i for i in range(nbands) if tb["en"][i] > thr[i]]
        sfs = np.zeros(nbands, np.int64)
        qs = [np.zeros(len(c), np.int64) for c in bands]
        has_sf = np.zeros(nbands, bool)
        sel = np.full(nbands, -1, np.int64)   # chosen state per coded band
        if coded:
            # Viterbi: node = w*dist + spectral bits, edge = sf-delta bits
            args = []
            cost = None
            for i in coded:
                dist, bits, _, _ = tabs[i]
                w = 0.7 * len(bands[i]) / thr[i]
                node = w * dist + bits.astype(np.float64)
                if cost is None:
                    cost = node
                    args.append(None)
                else:
                    tot = cost[:, None] + trans
                    a = tot.argmin(axis=0)
                    cost = tot[a, np.arange(len(states))] + node
                    args.append(a)
            s = int(np.argmin(cost))
            for k in range(len(coded) - 1, -1, -1):
                i = coded[k]
                sfs[i] = int(states[s])
                qs[i] = tabs[i][2][s]
                sel[i] = s
                # a band the Viterbi quantized to silence behaves exactly
                # like a psy-zeroed band from here on
                has_sf[i] = bool(np.any(qs[i]))
                if args[k] is not None:
                    s = int(args[k][s])
        # codebook run trellis per window group (section_data is per group)
        _, sf_bits = _sf_vlc_enc()
        sf0 = int(sf_bits[60])
        nb, ngroups, is8 = an["nb"], an["ngroups"], an["is8"]
        band_cost = np.full((nbands, 12), float(_BITS_INF))
        for i in range(nbands):
            if has_sf[i]:
                for cb, ba in tabs[i][3].items():
                    band_cost[i, cb] = float(ba[sel[i]])
            else:
                band_cost[i, 0] = 0.0
                for cb in range(1, 12):
                    band_cost[i, cb] = _zero_band_bits(len(bands[i]),
                                                       cb) + sf0
        cbs = np.zeros(nbands, np.int64)
        for g in range(ngroups):
            cbs[g * nb:(g + 1) * nb] = _codebook_run_trellis(
                band_cost[g * nb:(g + 1) * nb], is8)
        # all states share one 61-wide window so any assignment keeps
        # deltas legal
        gg = _rethread_sfs(cbs, sfs, has_sf)
        bits = self._count_ics_bits(an, sfs, qs, cbs, gg)
        return dict(sfs=sfs, qs=qs, cbs=cbs, global_gain=gg, bits=bits)

    def _count_ics_bits(self, an, sfs, qs, cbs, global_gain) -> int:
        """Exact ICS bit count (mirror of _emit_ics)."""
        nb, ngroups, is8 = an["nb"], an["ngroups"], an["is8"]
        bits = 8 + 1 + 2 + 1                      # gg + ics_info head
        bits += (4 + 7) if is8 else 6
        if not is8:
            bits += 1
            if an["predicting"]:
                bits += 1 + 5 + an["nmax"]
        rbits = 3 if is8 else 5
        resc = (1 << rbits) - 1
        for g in range(ngroups):
            b = 0
            while b < nb:
                run = 1
                while b + run < nb and cbs[g * nb + b + run] == cbs[g * nb + b]:
                    run += 1
                bits += 4 + rbits * (run // resc + 1)
                b += run
        _, sf_bits = _sf_vlc_enc()
        prev = global_gain
        for i in range(ngroups * nb):
            if cbs[i]:
                bits += int(sf_bits[int(sfs[i]) - prev + 60])
                prev = int(sfs[i])
        bits += 3                                  # pulse/tns/gain flags
        if self.tns_inject and not is8:
            inj = self.tns_inject
            bits += 2 + 1 + 6 + 5 + 1 + 1 \
                + (inj.get("coef_res", 0) + 3) * len(inj["coefs"])
        for i in range(ngroups * nb):
            if cbs[i]:
                bits += _band_bits(qs[i], int(cbs[i]))
        return bits

    def _refine_twoloop(self, an, co: dict, budget: int) -> dict:
        """Scalefactor refinement (aaccoder.c:381 search_for_quantizers_
        twoloop outer-loop analogue): after the rate loop fixes the global
        quality, greedily spend the remaining bit headroom lowering the
        scalefactor (finer quantization) of whichever coded band has the
        worst quantization-noise-to-masking-threshold ratio, re-counting
        exact bits each step and respecting the +-60 sf-delta rule."""
        bands, sf_bias = an["bands"], an["sf_bias"]
        # operate against the rate loop's effective thresholds (thr0 *
        # lambda) — at constrained rates lambda, not the masking curve, is
        # the binding constraint
        thr = np.maximum(np.asarray(an["thr0"], np.float64) * self.lam,
                         1e-30)
        sfs = co["sfs"].copy()
        qs = list(co["qs"])
        cbs = co["cbs"].copy()
        bits = co["bits"]

        def noise(i, sf):
            c = bands[i]
            q = np.clip(_quantize(c, sf, sf_bias), -MAX_QUANT, MAX_QUANT)
            return float(((c - _dequantize(q, sf, sf_bias)) ** 2).sum()), q

        cur = np.full(len(bands), -1.0)
        for i in range(len(bands)):
            if cbs[i]:
                cur[i], _ = noise(i, int(sfs[i]))

        def apply(moves):
            """moves: {band: sf_delta} -> (sfs, qs, cbs, bits, noises) or
            None if illegal (delta-60 / invalid codebook)."""
            t_sfs = sfs.copy()
            t_qs = list(qs)
            t_cbs = cbs.copy()
            t_n = {}
            for i, dlt in moves.items():
                t_sfs[i] = int(np.clip(t_sfs[i] + dlt, 0, 255))
                n, q = noise(i, int(t_sfs[i]))
                cb = _codebook_for(q)
                if cb == 0 and dlt < 0:
                    return None
                t_qs[i] = q
                t_cbs[i] = cb
                t_n[i] = n
            coded = np.nonzero(t_cbs)[0]
            if not len(coded):
                return None
            if any(abs(int(t_sfs[coded[j]]) - int(t_sfs[coded[j - 1]])) > 60
                   for j in range(1, len(coded))):
                return None
            gg = int(t_sfs[coded[0]])
            t_bits = self._count_ics_bits(an, t_sfs, t_qs, t_cbs, gg)
            return t_sfs, t_qs, t_cbs, t_bits, t_n

        blocked: set = set()
        for _ in range(64):
            ratio = np.where(cbs > 0, cur / thr[:len(cur)], -1.0)
            for i in blocked:
                ratio[i] = -1.0
            w = int(np.argmax(ratio))
            if ratio[w] <= 0.0 or sfs[w] <= 0:
                break  # every band blocked or nothing coded
            # refine alone if the reservoir headroom allows it
            t = apply({w: -1})
            if t is not None and t[3] <= budget and t[4][w] < cur[w]:
                sfs, qs, cbs, bits, tn = t
                cur[w] = tn[w]
                continue
            # exchange: coarsen the most over-coded donor (noise far under
            # threshold) to pay for refining the worst band
            dr = np.where(cbs > 0, cur / thr[:len(cur)], 2.0)
            dr[w] = 2.0
            d = int(np.argmin(dr))
            t = None
            if dr[d] < 0.25 and sfs[d] < 255:
                t = apply({w: -1, d: +1})
            if (t is not None and t[3] <= budget and t[4][w] < cur[w]
                    and (t[2][d] == 0 or t[4][d] <= thr[d])):
                sfs, qs, cbs, bits, tn = t
                cur[w] = tn[w]
                if d in tn:
                    cur[d] = tn[d]
            else:
                blocked.add(w)
        coded = np.nonzero(cbs)[0]
        gg = int(sfs[coded[0]]) if len(coded) else 100
        return dict(sfs=sfs, qs=qs, cbs=cbs, global_gain=gg, bits=bits)

    def _emit_ics_info(self, bw: BitWriter, an: dict) -> None:
        nb, ngroups, is8 = an["nb"], an["ngroups"], an["is8"]
        bw.put1(0)          # reserved
        bw.put(2, an["ws"])
        bw.put1(0)          # use_kb_window = sine
        if is8:
            bw.put(4, nb)   # max_sfb
            # scale_factor_grouping: 7 bits, bit w=1 iff window w shares
            # its group with window w-1 (aac_syntax.decode_ics_info)
            for g in range(ngroups):
                if g:
                    bw.put1(0)
                for _ in range(an["group_len"][g] - 1):
                    bw.put1(1)
        else:
            bw.put(6, nb)
            if an["predicting"]:
                bw.put1(1)      # predictor_data_present
                bw.put1(1)      # predictor_reset
                bw.put(5, an["reset_group"])
                for sfb in range(an["nmax"]):
                    bw.put1(int(an["pred_used"][sfb]))
            else:
                bw.put1(0)

    def _emit_ics(self, bw: BitWriter, an: dict, co: dict,
                  update_state: bool, common_window: bool = False) -> None:
        nb, ngroups, is8 = an["nb"], an["ngroups"], an["is8"]
        sfs, qs, cbs = co["sfs"], co["qs"], co["cbs"]
        if self.object_type == 1 and is8 and update_state:
            # decoder resets all predictors on short frames
            # (aac_syntax.apply_prediction EIGHT_SHORT branch)
            self._pred_state[an["ch"]] = self._syn.new_predictor_state()
        bw.put(8, co["global_gain"])
        if not common_window:
            self._emit_ics_info(bw, an)
        # intensity bands override the right channel's section codebook
        # (15/14) and code a position in the sf chain's own accumulator
        # (decode_scalefactors offset[2], start 100)
        isb = an.get("is_bands") or {}
        cbs = np.asarray(cbs).copy()
        for b, (bt, _pos) in isb.items():
            cbs[b] = bt
        # section_data (per group; 3-bit runs short, 5-bit long)
        rbits = 3 if is8 else 5
        resc = (1 << rbits) - 1
        for g in range(ngroups):
            b = 0
            while b < nb:
                cb = cbs[g * nb + b]
                run = 1
                while b + run < nb and cbs[g * nb + b + run] == cb:
                    run += 1
                bw.put(4, int(cb))
                r = run
                while r >= resc:
                    bw.put(rbits, resc)
                    r -= resc
                bw.put(rbits, r)
                b += run
        # scalefactor data (delta huffman; intensity positions dpcm on
        # their own chain)
        sf_codes, sf_bits = _sf_vlc_enc()
        prev = co["global_gain"]
        prev_is = 100
        for i in range(ngroups * nb):
            if cbs[i] == 0:
                continue
            if int(cbs[i]) >= 14:
                pos = isb[i][1]
                d = pos - prev_is + 60
                bw.put(int(sf_bits[d]), int(sf_codes[d]))
                prev_is = pos
                continue
            d = int(sfs[i]) - prev + 60
            bw.put(int(sf_bits[d]), int(sf_codes[d]))
            prev = int(sfs[i])
        bw.put1(0)  # pulse_data_present
        inj = self.tns_inject
        if inj and not is8:
            # one filter over all coded bands (syntax per decode_tns /
            # aacdec.c:854; length counts sfbs, order <= 12 for LC)
            bw.put1(1)                     # tns_data_present
            bw.put(2, 1)                   # n_filt (long: 2 bits)
            coef_res = inj.get("coef_res", 0)
            bw.put1(coef_res)
            bw.put(6, nb)                  # length in sfbs
            order = len(inj["coefs"])
            bw.put(5, order)
            bw.put1(inj.get("direction", 0))
            bw.put1(0)                     # coef_compress
            for c in inj["coefs"]:
                bw.put(coef_res + 3, int(c))
        else:
            bw.put1(0)  # tns_data_present
        bw.put1(0)  # gain_control_data_present
        for i in range(ngroups * nb):
            if 1 <= cbs[i] <= 11:   # intensity bands carry no spectra
                _write_band(bw, qs[i], int(cbs[i]))
        if an["predicting"] and update_state:
            # mirror the decoder: decoded residual + enabled prediction
            offs, kmax = an["offs"], an["kmax"]
            dec = np.zeros(1024, np.float32)
            for b in range(nb):
                dec[int(offs[b]):int(offs[b + 1])] = _dequantize(
                    qs[b], int(sfs[b]), an["sf_bias"])
            enable = np.zeros(kmax, bool)
            for sfb in range(an["nmax"]):
                if an["pred_used"][sfb]:
                    enable[int(offs[sfb]):int(offs[sfb + 1])] = True
            dec[:kmax] = np.where(
                enable,
                (dec[:kmax] + an["pv"] * self._sf_scale).astype(np.float32),
                dec[:kmax])
            self._predict_update(an["ch"], dec, an["k1_arr"], kmax,
                                 an["reset_group"])

    def _intensity_transform(self, c0: np.ndarray, c1: np.ndarray,
                             ws: int) -> dict:
        """Per-band intensity-stereo decision + right-channel zeroing.

        High bands where L/R are strongly coherent code only a panning
        position in the right channel: band_type 15 (in-phase) / 14
        (out-of-phase) + a dpcm'd position p, and the decoder rebuilds
        R = c * 2^((100-p)/4) * L (aacdec.c:1420-1451, intensity sf
        chain decode_scalefactors offset[2]).  Long windows only; returns
        {band: (band_type, position)}."""
        if ws == EIGHT_SHORT:
            return {}
        offs, nb = self.swb_long, self.nswb_long
        out: dict = {}
        prev = 100     # dpcm start (decode_scalefactors offset[2])
        for b in range(nb // 2, nb):
            s = slice(int(offs[b]), int(offs[b + 1]))
            L, R = c0[s].astype(np.float64), c1[s].astype(np.float64)
            eL, eR, cr = (L ** 2).sum(), (R ** 2).sum(), (L * R).sum()
            if eL < 1e-9 or eR < 1e-9:
                continue
            if abs(cr) / np.sqrt(eL * eR) < 0.8:
                continue
            pos = int(np.clip(round(100 - 2.0 * np.log2(eR / eL)), 0, 255))
            if not -60 < pos - prev < 60:   # dpcm range (sf vlc)
                continue
            prev = pos
            out[b] = (15 if cr >= 0 else 14, pos)
            c1[s] = 0.0
        return out

    def _ms_transform(self, c0: np.ndarray, c1: np.ndarray, ws: int,
                      group_len: list[int],
                      skip: dict | None = None) -> np.ndarray:
        """Per-band mid/side decision + in-place transform.

        Bands where the M/S representation carries less energy than L/R
        are replaced by (L+R)/2, (L-R)/2 — the decoder's butterfly
        (aacdec.c:1390-1411: L'=a+b, R'=a-b) reconstructs L/R exactly.
        The reference encoder's analogue sets cpe->ms_mask from the psy
        model (aacenc.c:507-519).  Returns the per-(group,sfb) mask."""
        is8 = ws == EIGHT_SHORT
        offs = self.swb_short if is8 else self.swb_long
        nb = self.nswb_short if is8 else self.nswb_long
        ngroups = len(group_len) if is8 else 1
        gl = group_len if is8 else [1]
        mask = np.zeros(ngroups * nb, np.int32)
        w0 = 0
        for g in range(ngroups):
            for b in range(nb):
                if skip and b in skip:
                    continue
                sls = [slice((w0 + w) * 128 + int(offs[b]),
                             (w0 + w) * 128 + int(offs[b + 1]))
                       for w in range(gl[g])]
                L = np.concatenate([c0[s] for s in sls])
                R = np.concatenate([c1[s] for s in sls])
                eLR = float((L ** 2).sum() + (R ** 2).sum())
                M, S = 0.5 * (L + R), 0.5 * (L - R)
                if float((M ** 2).sum() + (S ** 2).sum()) < 0.98 * eLR:
                    mask[g * nb + b] = 1
                    for s in sls:
                        a, bb = c0[s].copy(), c1[s].copy()
                        c0[s] = 0.5 * (a + bb)
                        c1[s] = 0.5 * (a - bb)
            w0 += gl[g]
        return mask

    def _emit_frame(self, analyses: list[dict], codeds: list[dict]) -> bytes:
        bw = BitWriter()
        if self.channels == 1:
            bw.put(3, T.TYPE_SCE)
            bw.put(4, 0)
            self._emit_ics(bw, analyses[0], codeds[0], True)
        elif analyses[0].get("ms_mask") is not None:
            # M/S frame: common_window with a shared ics_info + mask
            bw.put(3, T.TYPE_CPE)
            bw.put(4, 0)
            bw.put1(1)  # common_window
            self._emit_ics_info(bw, analyses[0])
            mask = analyses[0]["ms_mask"]
            if mask.any():
                bw.put(2, 1)  # ms_present = 1 (per-band mask)
                for m in mask:
                    bw.put1(int(m))
            else:
                bw.put(2, 0)  # common window, no M/S (e.g. intensity-only)
            self._emit_ics(bw, analyses[0], codeds[0], True,
                           common_window=True)
            self._emit_ics(bw, analyses[1], codeds[1], True,
                           common_window=True)
        else:
            bw.put(3, T.TYPE_CPE)
            bw.put(4, 0)
            bw.put1(0)  # common_window = 0 (independent ICS info)
            self._emit_ics(bw, analyses[0], codeds[0], True)
            self._emit_ics(bw, analyses[1], codeds[1], True)
        bw.put(3, T.TYPE_END)
        bw.align()
        return bw.bytes()

    def encode(self, pcm: np.ndarray) -> bytes:
        """pcm int16 [n, ch] -> ADTS byte stream."""
        pcm = np.asarray(pcm)
        if pcm.ndim == 1:
            pcm = pcm[:, None]
        n = pcm.shape[0]
        nframes = (n + 1023) // 1024
        padded = np.zeros((nframes * 1024 + 1024, pcm.shape[1]), np.float32)
        padded[1024:1024 + n] = pcm.astype(np.float32)  # 1-frame lead-in
        if self.window_switching:
            ws_seq, attack_pos = decide_window_sequences(
                pcm.astype(np.float32), nframes)
        else:
            ws_seq = np.zeros(nframes + 1, np.int64)
            attack_pos = np.zeros(nframes + 1, np.int64)
        target = (self.bitrate * 1024.0 / self.sample_rate
                  if self.bitrate else None)
        hdr_bits = 7 + 3 if self.channels == 1 else 8 + 3  # elems + END
        frames = []
        for t in range(nframes + 1):
            block = padded[t * 1024:(t + 2) * 1024]
            if block.shape[0] < 2048:
                block = np.pad(block, ((0, 2048 - block.shape[0]), (0, 0)))
            ws = int(ws_seq[t])
            groups = _group_layout(int(attack_pos[t]))
            F = _forward_matrices()[ws]
            specs = [block[:, c] @ F for c in range(self.channels)]
            ms_mask = None
            is_bands: dict = {}
            if self.intensity:
                is_bands = self._intensity_transform(specs[0], specs[1], ws)
            if self.ms:
                ms_mask = self._ms_transform(specs[0], specs[1], ws, groups,
                                             skip=is_bands)
            elif self.intensity:
                # intensity needs common_window; an all-zero mask keeps
                # the M/S butterfly inert (ms_present=1, mask=0)
                ms_mask = np.zeros(
                    (len(groups) if ws == EIGHT_SHORT else 1)
                    * (self.nswb_short if ws == EIGHT_SHORT
                       else self.nswb_long), np.int32)
            analyses = [self._analyze_ics(specs[c], c, ws, groups)
                        for c in range(self.channels)]
            side_adj = 0
            if ms_mask is not None:
                analyses[0]["ms_mask"] = ms_mask
                # common_window saves one ics_info, adds ms_present(2) +
                # the mask bits (_emit_frame layout)
                info_bits = 15 if ws == EIGHT_SHORT else 11
                side_adj += -info_bits + 2 \
                    + (len(ms_mask) if ms_mask.any() else 0)
            if is_bands:
                analyses[1]["is_bands"] = is_bands
                # intensity positions ride the sf chain (the per-band
                # quantizer counted these bands as zero runs)
                _, sfb_t = _sf_vlc_enc()
                prev_is = 100
                for b in sorted(is_bands):
                    d = is_bands[b][1] - prev_is
                    side_adj += int(sfb_t[d + 60])
                    prev_is = is_bands[b][1]
            code = (self._code_ics_anmr
                    if self.coder == "anmr" and target is not None
                    else self._code_ics)
            if target is None:
                codeds = [self._code_ics(an) for an in analyses]
            else:
                # in-frame rate loop: bracket + bisect log-lambda for the
                # most bits <= ~target (aacenc.c bit-reservoir analogue);
                # analysis is lambda-independent so only quantization
                # re-runs per iteration
                over = under = None   # lam values giving too many/too few
                best = None           # (bits, codeds) best under 1.02*target
                iters = 12 if t < 3 else 6
                for _ in range(iters):
                    codeds = [code(an) for an in analyses]
                    bits = hdr_bits + side_adj \
                        + sum(c["bits"] for c in codeds)
                    ratio = bits / max(target, 1.0)
                    if ratio <= 1.02 and (best is None or bits > best[0]):
                        best = (bits, codeds, self.lam)
                    if 0.8 <= ratio <= 1.02:
                        break
                    if ratio > 1.02:
                        over = self.lam
                    else:
                        under = self.lam
                    if over is not None and under is not None:
                        self.lam = float(np.sqrt(over * under))
                    else:
                        self.lam = float(np.clip(
                            self.lam * np.clip(ratio ** 1.2, 0.1, 8.0),
                            1e-5, 1e7))
                if best is not None:
                    codeds, self.lam = best[1], best[2]
                # twoloop refinement: spend the reservoir headroom on the
                # worst noise/threshold bands (aaccoder.c:381 analogue)
                budget = int(1.02 * target) - hdr_bits
                used = sum(c["bits"] for c in codeds)
                if self.coder == "anmr":
                    used = budget   # the trellis already spent the budget
                if used < budget:
                    spare = budget - used
                    share = spare // max(len(codeds), 1)
                    codeds = [self._refine_twoloop(an, c, c["bits"] + share)
                              for an, c in zip(analyses, codeds)]
            frames.append(self._emit_frame(analyses, codeds))
            if self.object_type == 1:
                self._frame_no += 1
        return mux_adts(frames, self.object_type, self.sample_rate,
                        1 if self.channels == 1 else 2)
