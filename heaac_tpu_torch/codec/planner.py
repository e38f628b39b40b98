"""The Python qwire planner: one stream -> per-frame qwire lanes (host).

Port copy of ``heaac_tpu/codec/batch.py``: _host_couple_and_tns
(23-43) and _point3_edges (52-86), which live in ``codec/decoder.py``
(the single-stream decoder runs them too), _point3_edges_sub (87-124),
_couple_series (125-139), _align_union_layout (140-175),
QwirePlanningDecoder (413-655), parse_stream_qwire (657-727) and
LcPlanningDecoder (1535-1567); names as there.  The planner parses with
the Python element parser (``codec/decoder.py``) and writes each
frame-lane with the host writers of ``codec/qwire_host.py``: raw-bits
spectral blocks where a lane is eligible, raw-f32 tokens otherwise, SBR
and PS side info as integer codes.  It is the batched decoder's
fallback for streams the native parser refuses, and the only parse that
reports a stream's per-frame PS band mode (``is34_out``) and its
downsampled-SBR flag (from an AudioSpecificConfig, ``asc``).  The LC
planner (``LcPlanningDecoder``) is the AAC-LC counterpart: per frame
the core plan of every lane, and AFTER_IMDCT coupling edges.
"""
from __future__ import annotations

import numpy as np

from .. import tables as T
from ..bitstream import aac_syntax as syn
from ..bitstream.reader import BitstreamError
from ..bitstream.sbr_syntax import SBRContext
from ..host import silence_lane, split_adts_stream
from ..ops.spec_huff import SFB
from . import qwire_host as QH
from .decoder import Decoder, _host_couple_and_tns, _point3_edges


def _point3_edges_sub(dec, qpos) -> list:
    """This frame's AFTER_IMDCT coupling edges [(tgt_lane, tgt_sub,
    src_lane, gain)] in the emitted qwire lane numbering; ``qpos`` maps
    (etype, eid, ch) -> (lane, stereo sub).  Mirrors
    decoder._apply_independent_coupling (aacdec.c:1849-1862); SCE targets
    always have ch_select==2 (decode_cce, aacdec.c:1523) so only their L
    sub-channel is coupled, exactly like the reference."""
    edges = []
    for key, el in dec.elements.items():
        if key[0] != T.TYPE_CCE or el.coup is None \
                or not el.present_this_frame \
                or el.coup.coupling_point != 3:
            continue
        src = qpos.get((T.TYPE_CCE, key[1], 0))
        if src is None:
            continue
        coup = el.coup
        index = 0
        for c in range(coup.num_coupled + 1):
            tkey = (coup.type[c], coup.id_select[c])
            ch_sel = coup.ch_select[c]
            if dec.elements.get(tkey) is None:
                index += 1 + (ch_sel == 3)
                continue
            if ch_sel != 1:
                p = qpos.get((tkey[0], tkey[1], 0))
                if p is not None:
                    edges.append(p + (src[0], float(coup.gain[index][0])))
                if ch_sel != 0:
                    index += 1
            if ch_sel != 2:
                p = qpos.get((tkey[0], tkey[1], 1))
                if p is not None:
                    edges.append(p + (src[0], float(coup.gain[index][0])))
                index += 1
    return edges


def _couple_series(frames_couple: list):
    """Per-frame edge lists -> (struct [(tgt_lane, tgt_sub, src_lane)],
    gains [T, K] f32) with one edge structure for the whole stream (gain
    0 on frames where an edge is absent), or None without any edges."""
    struct = sorted({e[:3] for fr in frames_couple for e in fr})
    if not struct:
        return None
    pos = {e: k for k, e in enumerate(struct)}
    gains = np.zeros((len(frames_couple), len(struct)), np.float32)
    for t, fr in enumerate(frames_couple):
        for tl, ts, sl, g in fr:
            gains[t, pos[(tl, ts, sl)]] = g
    return struct, gains


def _align_union_layout(dec) -> None:
    """Realign dec.frames_q/frames_couple onto the union lane layout
    (see parse_stream_qwire); frames missing an element ship silence on
    its lane.  Error-silence rows (frames_keys None) become full-width
    silence rows."""
    union: list = []
    seen: set = set()
    for fk in dec.frames_keys:
        for k in fk or ():
            if k is not None and k not in seen:
                seen.add(k)
                union.append(k)
    ucce = [k for k in union if k[0] == T.TYPE_CCE]
    union = [k for k in union if k[0] != T.TYPE_CCE] + ucce
    pos = {k: i for i, k in enumerate(union)}
    sil = silence_lane()
    new_q, new_c = [], []
    for fk, fr, cpl in zip(dec.frames_keys, dec.frames_q,
                           dec.frames_couple):
        row = [sil] * len(union)
        remap: dict = {}
        if fk is not None:
            for i, k in enumerate(fk):
                if k is not None and i < len(fr):
                    row[pos[k]] = fr[i]
                    remap[i] = pos[k]
        new_q.append(row)
        new_c.append([(remap[tl], ts, remap[sl], g)
                      for (tl, ts, sl, g) in cpl
                      if tl in remap and sl in remap])
    dec.frames_q = new_q
    dec.frames_couple = new_c
    dec.out_nl = len(union) - len(ucce)


class QwirePlanningDecoder(Decoder):
    """Parses a stream into qwire frame-lane payloads (``codec/qwire_host.py``).

    The Python planner has only the final float coefficients, so spectra are
    shipped as raw-f32 tokens (exact, ~5x fatter than the native emitter's
    integer tokens); SBR/PS side-info ships as integer codes with host
    dequantization skipped — the device performs sbr_dequant/mapping/chirp."""

    def __init__(self, *a, **kw):
        # parse with the pure-Python syntax layer, as the JAX planner
        # does: the native per-element parser never captures spectral
        # bit positions (Decoder._native_sce), and raw-bits lanes need
        # decode_ics
        kw.setdefault("use_native", False)
        super().__init__(*a, device=None, **kw)   # parses only
        self.frames_q = []   # per frame: list of per-lane (payload, rec)
        self.ps_is34 = None
        self.downsampled = 0
        self._hdr_sent = set()
        self._cur_packet = b""
        # mid-stream 20<->34 band-mode flips: rejected by default (the
        # static per-mode scan graphs would mis-decode); the flip-capable
        # path (decode_qwire_flip_stream) opts in and reads the per-frame
        # mode trail from is34_frames
        self.allow_ps_flips = False
        self.cur_is34 = None     # THIS frame's effective PS band mode
        self.is34_frames: list = []
        # AFTER_IMDCT (point 3) CCE: per frame [(tgt_lane, tgt_sub,
        # src_lane, gain)] in the emitted qwire lane numbering (CCE
        # elements ride extra non-output lanes, aacdec.c:1919-1929)
        self.frames_couple: list = []
        self.out_nl = None       # output lanes (excludes CCE lanes)
        # per-frame lane identity keys [(etype, eid, ch)] parallel to
        # frames_q rows (None for error-silence rows): a mid-stream PCE
        # that changes the layout is realigned onto the union layout by
        # parse_stream_qwire instead of demoting (aacdec.c:224-302)
        self.frames_keys: list = []

    def decode_frame(self, packet: bytes):
        # scope the bandpos-capture flag to THIS parse: a module-global
        # left set would make every later Decoder in the process pay the
        # per-band capture in the hot VLC loop (round-3 review finding)
        self._cur_packet = bytes(packet)
        prev = syn.CAPTURE_SPEC
        syn.CAPTURE_SPEC = True
        try:
            return super().decode_frame(packet)
        finally:
            syn.CAPTURE_SPEC = prev

    def _try_spec_block(self, cd, ms_mask=None):
        """Raw-bits spec block for a clean lane, or None.

        Eligible when nothing modifies the decoded spectrum after the
        VLC loop: LC object, no pulses/TNS, no noise/intensity bands, no
        channel coupling in the stream.  EIGHT_SHORT frames ship a
        grouping byte and (group, sfb)-ordered sections (W3_SHORT); the
        device de-interleaves.  ``ms_mask`` (per-sfb, length max_sfb)
        rides the block for CPE pairs whose M/S butterfly moves to the
        device (the raw bits are PRE-M/S; see _try_spec_cpe)."""
        ics = cd.ics
        is8 = ics.window_sequence == T.EIGHT_SHORT
        # bandpos is only captured for clean lanes (decode_ics: no
        # pulses/TNS) — the checks here are belt and braces since TNS is
        # applied+cleared before this point
        bp = getattr(cd, "spec_bandpos", None)
        if (self.m4ac.object_type != 2 or not bp
                or (not is8 and ics.num_window_groups != 1)
                or getattr(cd, "pulse_present", False)):
            return None
        if any(et == T.TYPE_CCE for (et, _) in self.elements):
            return None
        nbands = ics.num_window_groups * ics.max_sfb
        bt = np.asarray(cd.band_type[:nbands])
        if nbands and (bt > 11).any():
            return None
        nbits = bp[-1] - bp[0]
        if nbits >= (1 << 13):
            return None
        sfpos = getattr(cd, "spec_sfpos", None)
        if sfpos is None or sfpos[1] - sfpos[0] > SFB - 24:
            return None              # sf region must fit the device axis
        secs = []
        sfidx0 = None
        for grp in range(ics.num_window_groups):
            i = 0
            while i < ics.max_sfb:   # runs never cross a group boundary
                b0 = grp * ics.max_sfb + i
                cb = int(bt[b0])
                j = i
                while j < ics.max_sfb \
                        and int(bt[grp * ics.max_sfb + j]) == cb:
                    j += 1
                blen = bp[grp * ics.max_sfb + j] - bp[b0]
                if blen >= (1 << 14):
                    return None
                secs.append((cb, j - i, blen))
                if cb >= 1 and sfidx0 is None:
                    sfidx0 = QH.sfidx_from_sf(
                        cd.sf[grp * ics.max_sfb + i])
                    if sfidx0 is None:
                        return None
                i = j
        if len(secs) > QH.SEC_MAX:
            return None
        # raw bits: one byte-aligned slice spanning the sf-huffman region
        # through the spectral region — contiguous up to the 3 always-
        # zero pulse/tns/gain gate bits, which ship in place (the device
        # skips them; ops/spec_huff.decode_spec_jax)
        if bp[0] != sfpos[1] + 3:
            return None              # non-standard gate span: token mode
        bits = self._cur_packet[sfpos[0] >> 3:(bp[-1] + 7) >> 3]
        phase = sfpos[0] & 7
        grouping = None
        if is8:
            # bit (7-w) set iff window w shares window w-1's group
            grouping = 0
            w = 0
            for g in range(ics.num_window_groups):
                for r in range(ics.group_len[g]):
                    if r >= 1:
                        grouping |= 1 << (7 - w)
                    w += 1
        return QH.pack_spec_block(secs, sfidx0 or 0, bits, nbits,
                                  ms_mask=ms_mask, grouping=grouping,
                                  phase=phase)

    def _try_spec_cpe(self, el):
        """Spec blocks for a CPE's two channels, each entry None when
        that channel must ship tokens.

        Without effective M/S the channels are independent raw-bits
        lanes (intensity in ch1 only reads ch0, whose raw bits decode to
        its final values).  With effective M/S the raw bits predate the
        butterfly (aacdec.c:1390), so spec mode requires BOTH channels
        eligible: the mask ships on the left lane and the device applies
        the pair butterfly (W3_MS_LEFT/RIGHT)."""
        ch0, ch1 = el.cur[0], el.cur[1]
        nmask = ch0.ics.num_window_groups * ch0.ics.max_sfb
        mask = (np.asarray(el.ms_mask[:nmask])
                if el.ms_mask is not None else np.zeros(nmask, np.int32))
        bt0 = np.asarray(ch0.band_type[:nmask])
        bt1 = np.asarray(ch1.band_type[:nmask])
        eff = mask.astype(bool) & (bt0 < 13) & (bt1 < 13)
        if eff.any():
            s0 = self._try_spec_block(ch0, ms_mask=eff.astype(np.int32))
            s1 = self._try_spec_block(ch1)
            if s0 is None or s1 is None:
                return (None, None)
            return ((s0[0], s0[1] | QH.W3_MS_LEFT),
                    (s1[0], s1[1] | QH.W3_MS_RIGHT))
        return (self._try_spec_block(ch0), self._try_spec_block(ch1))

    def _spectral_to_sample(self, present):
        m = self.m4ac
        _host_couple_and_tns(self)
        lanes_out = []
        qpos = {}    # (etype, eid, ch) -> (emitted lane, stereo sub)
        for lane in self.lanes + self.cce_lanes:
            key = (lane.elem_type, lane.elem_id)
            el = self.elements[key]
            is_ps = (lane.elem_type == T.TYPE_SCE and m.ps == 1)
            if is_ps and lane.ch == 1:
                # PS second output shares the SCE lane's stereo sub-axis
                qpos[key + (1,)] = (qpos[key + (0,)][0], 1)
                continue
            qpos[key + (lane.ch,)] = (len(lanes_out), 0)
            cd = el.cur[lane.ch]
            meta = dict(ws=int(cd.ics.window_sequence),
                        kbd=int(cd.ics.use_kb_window))
            spec = None
            if lane.elem_type == T.TYPE_SCE and el.present_this_frame:
                # presence gate: an absent element's spec_bandpos is the
                # previous frame's and would slice the WRONG packet
                spec = self._try_spec_block(cd)
            elif lane.elem_type == T.TYPE_CPE and el.present_this_frame:
                if lane.ch == 0:
                    self._cpe_pair = self._try_spec_cpe(el)
                spec = self._cpe_pair[lane.ch]
            if spec is None:
                coeffs = cd.coeffs
                if coeffs is None or not el.present_this_frame:
                    # a CCE absent this frame keeps its lane valid
                    coeffs = np.zeros(1024, np.float32)
                toks, ext = QH.emit_coeff_tokens(coeffs)
            sbr = None
            header = b""
            if m.sbr == 1:
                if el.sbr is None:
                    el.sbr = SBRContext()
                if not el.sbr.sample_rate:
                    el.sbr.sample_rate = 2 * m.sample_rate
                if not m.ext_sample_rate:
                    m.ext_sample_rate = 2 * m.sample_rate
                self.downsampled = int(m.ext_sample_rate <= m.sample_rate)
                sbr = el.sbr
                if sbr.ps is not None and sbr.ps.start:
                    cur34 = int(sbr.ps.is34bands)
                    if self.ps_is34 is None:
                        self.ps_is34 = cur34
                    elif cur34 != (self.cur_is34
                                   if self.cur_is34 is not None
                                   else self.ps_is34) \
                            and not self.allow_ps_flips:
                        raise NotImplementedError(
                            "PS band mode changes mid-stream")
                    self.cur_is34 = cur34
                hkey = (key, lane.ch)
                if sbr.start and (sbr.reset or hkey not in self._hdr_sent):
                    header = QH.build_header(sbr)
                    self._hdr_sent.add(hkey)
            side = QH.build_side(sbr, lane.ch, lane.elem_type,
                                    core_meta=meta,
                                    is34=(self.cur_is34
                                          if self.cur_is34 is not None
                                          else self.ps_is34) or 0)
            if spec is not None:
                lanes_out.append(QH.assemble_spec_lane(
                    spec[0], spec[1], side, header))
            else:
                lanes_out.append(QH.assemble_lane(toks, ext, side,
                                                     header))
        self.frames_q.append(lanes_out)
        lane_keys = [None] * len(lanes_out)
        for k3, (ln, sub) in qpos.items():
            if sub == 0:
                lane_keys[ln] = k3
        self.frames_keys.append(lane_keys)
        self.out_nl = len(lanes_out) - len(self.cce_lanes)
        self.frames_couple.append(_point3_edges_sub(self, qpos))
        self.is34_frames.append((self.cur_is34
                                 if self.cur_is34 is not None
                                 else self.ps_is34) or 0)
        self.sample_rate = m.sample_rate << (
            (m.ext_sample_rate > m.sample_rate) if m.sbr == 1 else 0)
        return np.zeros((0, 1), np.int16)


def parse_stream_qwire(data: bytes, asc: bytes | None = None,
                       max_frames: int | None = None,
                       err_out: list | None = None,
                       is34_out: list | None = None,
                       info_out: dict | None = None):
    """One ADTS stream -> (frames list of per-lane (payload, rec), rate,
    n_lanes, is34, downsampled) in the qwire format, with per-frame error
    isolation (corrupt frame -> silence lanes, count stays aligned).
    ``err_out``, if given, receives the stream's corrupt-frame count.
    ``is34_out``, if given, enables mid-stream PS band-mode flips (for
    the flip-capable scan graph) and receives the per-frame mode trail.
    ``info_out``, if given, receives ``out_nl`` (output lanes: n_lanes
    minus trailing CCE lanes) and ``couple`` (None, or the stream's
    AFTER_IMDCT edge structure + per-frame gains from _couple_series)."""

    frames = split_adts_stream(data)
    if max_frames is not None:
        frames = frames[:max_frames]
    if asc is not None:
        dec = QwirePlanningDecoder(asc=asc)
        frames = [f[9 - (f[1] & 1) * 2:] for f in frames]
    else:
        dec = QwirePlanningDecoder(adts_probe=frames[0][:7])
    if is34_out is not None:
        dec.allow_ps_flips = True
    for f in frames:
        n_before = len(dec.frames_q)
        try:
            dec.decode_frame(f)
        except BitstreamError:
            dec.error_count += 1
            if len(dec.frames_q) == n_before:
                if dec.frames_q:
                    nl_ = len(dec.frames_q[0])
                elif dec.lanes:
                    nl_ = sum(1 for ln in dec.lanes
                              if not (ln.elem_type == T.TYPE_SCE
                                      and ln.ch == 1)) \
                        + len(dec.cce_lanes)
                else:
                    nl_ = 1
                sil = silence_lane()
                dec.frames_q.append([sil for _ in range(nl_)])
                dec.frames_keys.append(None)
                dec.frames_couple.append([])
                dec.is34_frames.append(dec.is34_frames[-1]
                                       if dec.is34_frames else 0)
    if not dec.frames_q:
        raise BitstreamError("no decodable frames in stream")
    nl = len(dec.frames_q[0])
    if any(len(fr) != nl for fr in dec.frames_q):
        # mid-stream layout change (a PCE reconfigure or a CCE appearing
        # later): realign every frame onto the UNION layout -- stable
        # lane slots keyed by (etype, eid, ch), output lanes first, CCE
        # lanes last, silence where an element is absent.  This is the
        # batched analogue of the reference's in-stream output_configure
        # (aacdec.c:224-302, aac.h:104-110 OCStatus).
        _align_union_layout(dec)
        nl = len(dec.frames_q[0])
    if err_out is not None:
        err_out.append(dec.error_count)
    if is34_out is not None:
        is34_out.extend(dec.is34_frames)
    if info_out is not None:
        info_out["out_nl"] = dec.out_nl if dec.out_nl is not None else nl
        info_out["couple"] = _couple_series(dec.frames_couple)
    return (dec.frames_q, dec.sample_rate, nl,
            dec.ps_is34 or 0, dec.downsampled)


class LcPlanningDecoder(Decoder):
    """Parses an AAC-LC stream into per-frame core plans, one lane per
    output channel, then one per coupling channel element.  Per frame:
    ``frames_core`` (coeffs [lanes, 1024] f32, ws / wsp / kbd / kbdp
    [lanes] int32) and ``frames_couple``, the AFTER_IMDCT edges [(tgt_lane,
    src_lane, gain)] the device mixes after the scan."""

    def __init__(self, *a, **kw):
        super().__init__(*a, device=None, **kw)   # parses only
        self.frames_core = []
        self.frames_couple = []

    def _spectral_to_sample(self, present):
        _host_couple_and_tns(self)
        all_lanes = self.lanes + self.cce_lanes
        lane_index_of = {(ln.elem_type, ln.elem_id, ln.ch): i
                         for i, ln in enumerate(all_lanes)}
        self.frames_couple.append(_point3_edges(self, lane_index_of))
        lanes = [self.elements[(ln.elem_type, ln.elem_id)].cur[ln.ch]
                 for ln in all_lanes]
        zeros = np.zeros(1024, np.float32)
        self.frames_core.append(dict(
            coeffs=np.stack([cd.coeffs if cd.coeffs is not None else zeros
                             for cd in lanes]),
            ws=np.array([cd.ics.window_sequence for cd in lanes], np.int32),
            wsp=np.array([cd.ics.window_sequence_prev for cd in lanes],
                         np.int32),
            kbd=np.array([cd.ics.use_kb_window for cd in lanes], np.int32),
            kbdp=np.array([cd.ics.use_kb_window_prev for cd in lanes],
                          np.int32)))
        return np.zeros((0, 1), np.int16)
