"""The single-stream decoder: host element loop, dense work on the device.

Port of ``heaac_tpu/codec/decoder.py``: LaneRef and ``Decoder`` with
__init__, _configure, _configure_from_pce, decode_frame, decode,
_get_che, _parse_raw_data_block, _decode_cpe, _skip_dse,
_decode_extension, _spectral_to_sample, _apply_sbr,
_apply_dependent_coupling_stage and _fan_out_coupling, names as there;
_apply_native_meta, _native_sce and _native_cpe;
_apply_independent_coupling's loop is ``_point3_edges`` (with
``_host_couple_and_tns``, from ``heaac_tpu/codec/batch.py``, shared
with the planners).  As there, SCE / CPE elements parse in the native
per-element parser (``native.Parser.parse_sce`` / ``parse_cpe``) from
frame 1 on unless a dependent coupling channel is present; frame 0, a
``bitreader_cls`` (the bit tracer) and ``use_native=False`` parse in
Python.

The host parses, applies dependent coupling and TNS to the spectra, and
does the parameter math that depends only on the bitstream
(``ops/sbr_single.prepare``, ``ops/ps_single.prepare``); everything of
a frame that goes to the device travels in one upload (``_upload``).
On the decoder's device run the core IMDCT / overlap-add
(``codec/core.core_frame`` with the overlap ``saved`` carried there),
SBR (``ops/sbr_single``), PS with kernel K1 at one lane
(``ops/ps_single``), the AFTER_IMDCT coupling mix and the int16
rounding; the frame's int16 PCM is the one copy back to the host.  The
Python planners (``codec/planner.py``) reuse the parsing half with no
device and override ``_spectral_to_sample``.
"""
from __future__ import annotations

import copy
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from .. import tables as T
from ..bitstream import aac_syntax as syn
from ..bitstream.adts import parse_adts_header
from ..bitstream.asc import M4AConfig, parse_audio_specific_config
from ..bitstream.reader import BitReader, BitstreamError
from ..bitstream.sbr_syntax import SBRContext
from ..device import resolve
from ..host import split_adts_stream
from ..ops import ps_single, sbr_single
from ..utils.metrics import log
from .core import consts as core_consts
from .core import core_frame

SF_SCALE = np.float32(1.0 / -1024.0)  # no-bias path (aacdec.c:579)


@dataclass
class LaneRef:
    elem_type: int
    elem_id: int
    ch: int


def _host_couple_and_tns(dec) -> None:
    """Dependent channel coupling + TNS in reference order (host side,
    aacdec.c:1870-1898 stages 0/1), for the decoder and both planners.
    AFTER_IMDCT (point 3) coupling mixes decoded time signals on the
    device: over extra CCE lanes on the qwire and LC paths
    (``planner._point3_edges_sub``, ``_point3_edges``), in the
    decoder's output; the JAX package's ``raise_point3`` branch serves
    only its dense-plan planner, which is not ported."""
    dec._apply_dependent_coupling_stage(0, before_tns=True)
    for lane in dec.lanes + dec.cce_lanes:
        el = dec.elements[(lane.elem_type, lane.elem_id)]
        cd = el.cur[lane.ch]
        if el.present_this_frame and cd.coeffs is not None \
                and cd.tns.present:
            syn.apply_tns(cd.coeffs, cd)
            cd.tns = syn.TnsData()
    dec._apply_dependent_coupling_stage(1, before_tns=False)


def _point3_edges(dec, lane_index_of) -> list:
    """This frame's AFTER_IMDCT coupling edges [(tgt_lane, src_lane,
    gain)] over the decoder's or the LC planner's lanes
    (``lane_index_of``: (etype, eid, ch) -> lane), in the order of the
    JAX decoder's _apply_independent_coupling (aacdec.c:1849-1862)."""
    edges = []
    for key, el in dec.elements.items():
        if key[0] != T.TYPE_CCE or el.coup is None \
                or not el.present_this_frame \
                or el.coup.coupling_point != 3:
            continue
        src = lane_index_of.get((T.TYPE_CCE, key[1], 0))
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
                li = lane_index_of.get((tkey[0], tkey[1], 0))
                if li is not None:
                    edges.append((li, src, float(coup.gain[index][0])))
                if ch_sel != 0:
                    index += 1
            if ch_sel != 2:
                li = lane_index_of.get((tkey[0], tkey[1], 1))
                if li is not None:
                    edges.append((li, src, float(coup.gain[index][0])))
                index += 1
    return edges


def _upload(groups: dict, device: torch.device) -> dict:
    """The frame's host arrays on ``device`` in one copy: ``groups`` maps
    names to dicts of values; every numpy array goes into one float32
    buffer (pinned on the host when the device is a card, so the copy
    does not wait for the device's queue) and comes back as a view of
    the copy, integer arrays as int64 (their values are exact in
    float32); other values pass through."""
    arrays = [(g, k, v) for g, d in groups.items() for k, v in d.items()
              if isinstance(v, np.ndarray)]
    buf = torch.from_numpy(np.concatenate(
        [np.asarray(v, np.float32).ravel() for _, _, v in arrays]
        or [np.zeros(0, np.float32)]))
    if device.type == "cuda":
        buf = buf.pin_memory().to(device, non_blocking=True)
    out = {g: dict(d) for g, d in groups.items()}
    off = 0
    for g, k, v in arrays:
        t = buf[off:off + v.size].view(v.shape)
        off += v.size
        out[g][k] = t.long() if v.dtype.kind in "iub" else t
    return out


class Decoder:
    """Stateful AAC / HE-AAC decoder for one stream: its dense work runs on
    ``device`` (the card unless the caller passes ``device="cpu"``; a
    card raises RuntimeError without one).  ``device=None`` keeps the
    parsing half only (the Python planners).  ``use_native``: SCE / CPE
    elements after frame 0 parse natively (the default); a
    ``bitreader_cls`` (e.g. ``TracingBitReader``) parses in Python."""

    def __init__(self, asc: bytes | None = None,
                 adts_probe: bytes | None = None, use_native: bool = True,
                 bitreader_cls=None, device="cuda"):
        self.device = None if device is None else resolve(device)
        self.bitreader_cls = bitreader_cls or BitReader
        # traced reads need the Python parser
        self.use_native = use_native and bitreader_cls is None
        self._parser = native.Parser() if self.use_native else None
        self.m4ac = M4AConfig()
        self.elements: dict[tuple[int, int], syn.ChannelElement] = {}
        self.lanes: list[LaneRef] = []          # output channel order
        self.cce_lanes: list[LaneRef] = []      # extra IMDCT lanes for CCE
        self.rng = [0x1F2E3D4C]                 # PNS LCG state (aacdec.c:567)
        self.saved = None                       # [B,512] device overlap state
        self.configured = False
        self.locked = False
        self.sample_rate = 0
        self.error_count = 0
        if asc is not None:
            self.m4ac = parse_audio_specific_config(asc)
            self._configure(self.m4ac.chan_config)
            self.sample_rate = self.m4ac.sample_rate
        elif adts_probe is not None:
            hdr = parse_adts_header(BitReader(adts_probe))
            self.m4ac.object_type = hdr.object_type
            self.m4ac.sampling_index = hdr.sampling_index
            self.m4ac.sample_rate = hdr.sample_rate
            self.m4ac.chan_config = hdr.chan_config
            self.m4ac.sbr = -1
            self.m4ac.ps = -1
            if hdr.chan_config:
                self._configure(hdr.chan_config)
            self.sample_rate = hdr.sample_rate

    # ------------------------------------------------------------------
    def _configure(self, chan_config: int) -> None:
        if not 1 <= chan_config <= 7:
            raise BitstreamError(f"channel config {chan_config} unsupported")
        self.lanes = []
        for etype, eid in T.CHANNEL_LAYOUT_MAP[chan_config]:
            key = (etype, eid)
            if key not in self.elements:
                self.elements[key] = syn.ChannelElement()
            self.lanes.append(LaneRef(etype, eid, 0))
            if etype == T.TYPE_CPE or (etype == T.TYPE_SCE and self.m4ac.ps == 1):
                self.lanes.append(LaneRef(etype, eid, 1))
        self.configured = True

    def _configure_from_pce(self, layout) -> None:
        """Configure output lanes from a program_config_element (config 0);
        ordering follows the reference's 1:1 mapping (aacdec.c:249-268:
        iterate element ids, then types SCE,CPE,CCE,LFE)."""
        pos: dict[tuple[int, int], bool] = {}
        for group in ("front", "side", "back", "lfe", "cc"):
            for etype, eid in layout[group]:
                pos[(etype, eid)] = True
        self.lanes = []
        self.cce_lanes = []
        for eid in range(16):
            for etype in (T.TYPE_SCE, T.TYPE_CPE, T.TYPE_CCE, T.TYPE_LFE):
                if (etype, eid) not in pos:
                    continue
                if (etype, eid) not in self.elements:
                    self.elements[(etype, eid)] = syn.ChannelElement()
                if etype == T.TYPE_CCE:
                    self.cce_lanes.append(LaneRef(etype, eid, 0))
                    continue
                self.lanes.append(LaneRef(etype, eid, 0))
                if etype == T.TYPE_CPE or (etype == T.TYPE_SCE
                                           and self.m4ac.ps == 1):
                    self.lanes.append(LaneRef(etype, eid, 1))
        self.configured = True

    @property
    def channels(self) -> int:
        return len(self.lanes)

    # ------------------------------------------------------------------
    def decode_frame(self, packet: bytes):
        """Decode one ADTS frame / raw_data_block -> int16 [samples, ch], a
        CPU tensor."""
        br = self.bitreader_cls(packet)
        if br.show(12) == 0xFFF:
            hdr = parse_adts_header(br)
            if not self.locked and hdr.chan_config:
                if (not self.configured
                        or hdr.chan_config != self.m4ac.chan_config):
                    self.m4ac.chan_config = hdr.chan_config
                    self._configure(hdr.chan_config)
            if not self.locked:
                self.m4ac.sbr = -1
                self.m4ac.ps = -1
            self.m4ac.sample_rate = hdr.sample_rate
            self.m4ac.sampling_index = hdr.sampling_index
            self.m4ac.object_type = hdr.object_type
            self.sample_rate = hdr.sample_rate
            if hdr.num_aac_frames != 1:
                raise BitstreamError(">1 RDB per ADTS frame unsupported")
            if not hdr.crc_absent:
                br.skip(16)

        # the first frame parses with the Python element parser: a
        # dependent (point 0/1) CCE needs un-TNS'd target spectra for the
        # BEFORE_TNS add, and the native per-element engine applies TNS
        # in-parse — discovery-after-the-fact would leave THIS frame
        # decoded in the wrong order (aacdec.c spectral_to_sample).
        # Native parsing resumes from frame 1 unless such a CCE exists.
        first = not self.locked
        native_saved = self.use_native
        if first:
            self.use_native = False
        try:
            frame_elements = self._parse_raw_data_block(br)
        finally:
            if first:
                dep = any(
                    et == T.TYPE_CCE and el.coup is not None
                    and el.coup.coupling_point < 3
                    for (et, _), el in self.elements.items())
                self.use_native = native_saved and not dep
        out = self._spectral_to_sample(frame_elements)
        self.locked = True
        return out

    def decode(self, data: bytes):
        """Decode a whole ADTS byte stream -> int16 [samples, channels], a
        CPU tensor.

        Per-frame error isolation (matches the reference CLI contract):
        a corrupt frame is skipped with a warning and decoding continues
        at the next syncword; see ``error_count``.
        """
        chunks = []
        for f in split_adts_stream(data):
            try:
                chunks.append(self.decode_frame(f))
            except BitstreamError as e:
                self.error_count += 1
                log.warning("frame dropped: %s", e)
        return torch.cat(chunks) if chunks else torch.zeros(
            (0, 1), dtype=torch.int16)

    def _get_che(self, etype: int, eid: int) -> syn.ChannelElement:
        key = (etype, eid)
        if key not in self.elements:
            # CCE elements are allocated on demand; others must exist
            if etype == T.TYPE_CCE:
                self.elements[key] = syn.ChannelElement()
                self.cce_lanes.append(LaneRef(etype, eid, 0))
            else:
                raise BitstreamError(
                    f"channel element {etype}.{eid} is not allocated")
        return self.elements[key]

    def _parse_raw_data_block(self, br: BitReader):
        m = self.m4ac
        present = []
        che = None
        che_prev, etype_prev = None, None
        self._elem_ends = []   # (etype, eid, end bitpos) per channel elem
        for el in self.elements.values():
            el.present_this_frame = False
        while True:
            etype = br.get(3)
            if etype == T.TYPE_END:
                self._end_bitpos = br.pos - 3  # used by the stream splicer
                break
            eid = br.get(4)
            if etype in (T.TYPE_SCE, T.TYPE_CPE, T.TYPE_CCE, T.TYPE_LFE):
                che = self._get_che(etype, eid)
                che.present_this_frame = True

            if etype in (T.TYPE_SCE, T.TYPE_LFE):
                if not (self.use_native and m.object_type == 2
                        and self._native_sce(br, che)):
                    syn.decode_ics(br, che.cur[0], m.sampling_index,
                                   m.object_type, 0, self.rng)
                    if m.object_type == 1:
                        syn.apply_prediction(che.ch[0], che.cur[0],
                                             m.sampling_index, SF_SCALE)
                present.append((etype, eid))
            elif etype == T.TYPE_CPE:
                if not (self.use_native and m.object_type == 2
                        and self._native_cpe(br, che)):
                    self._decode_cpe(br, che)
                present.append((etype, eid))
            elif etype == T.TYPE_CCE:
                syn.decode_cce(br, che, m.sampling_index, m.object_type,
                               self.rng)
                if m.object_type == 1:
                    # the reference applies prediction inside the CCE's
                    # decode_ics (aacdec.c:1381, common_window=0); the
                    # gain parse that follows never reads coeffs, so
                    # applying here is value-identical
                    syn.apply_prediction(che.ch[0], che.cur[0],
                                         m.sampling_index, SF_SCALE)
                if self.use_native and che.coup.coupling_point < 3:
                    # pre-IMDCT coupling needs un-TNS'd target spectra; the
                    # native engine applies TNS in-parse, so fall back to
                    # the Python element parser from the next frame on.
                    # (Streams whose dependent CCE is present from frame 0
                    # are exact — decode_frame parses frame 0 in Python; a
                    # mid-stream ONSET frame's targets were native-parsed
                    # with TNS already applied, so warn: that one frame's
                    # coupling order is inverted vs aacdec.c.)
                    log.warning(
                        "dependent CCE appeared mid-stream: this frame's "
                        "coupling applies post-TNS (reference order "
                        "resumes next frame)")
                    self.use_native = False
                present.append((etype, eid))
            elif etype == T.TYPE_DSE:
                self._skip_dse(br)
            elif etype == T.TYPE_PCE:
                layout = syn.parse_pce_layout(br)
                if not self.locked:
                    self._configure_from_pce(layout)
            elif etype == T.TYPE_FIL:
                cnt = eid
                if cnt == 15:
                    cnt += br.get(8) - 1
                if br.bits_left() < 8 * cnt:
                    raise BitstreamError("overread in fill element")
                self._decode_extension(br, cnt, che_prev, etype_prev)
            if etype in (T.TYPE_SCE, T.TYPE_CPE, T.TYPE_CCE, T.TYPE_LFE):
                self._elem_ends.append((etype, eid, br.pos))
            che_prev, etype_prev = che, etype
            if br.bits_left() < 3:
                raise BitstreamError("overread: no END element")
        return present

    def _decode_cpe(self, br: BitReader, cpe: syn.ChannelElement) -> None:
        m = self.m4ac
        common_window = br.get1()
        ms_present = 0
        if common_window:
            syn.decode_ics_info(br, cpe.cur[0].ics, m.sampling_index,
                                m.object_type, 1)
            # copy ics to ch1, preserving its own prev window shape
            prev_kbd = cpe.cur[1].ics.use_kb_window
            cpe.cur[1].ics = copy.deepcopy(cpe.cur[0].ics)
            cpe.cur[1].ics.use_kb_window_prev = prev_kbd
            ms_present = br.get(2)
            if ms_present == 3:
                raise BitstreamError("ms_present=3 reserved")
            nmask = cpe.cur[0].ics.num_window_groups * cpe.cur[0].ics.max_sfb
            if ms_present == 1:
                cpe.ms_mask = np.array([br.get1() for _ in range(nmask)] +
                                       [0] * (128 - nmask), np.int32)
            elif ms_present == 2:
                cpe.ms_mask = np.ones(128, np.int32)
            else:
                cpe.ms_mask = np.zeros(128, np.int32)
        else:
            cpe.ms_mask = np.zeros(128, np.int32)
        syn.decode_ics(br, cpe.cur[0], m.sampling_index, m.object_type,
                       common_window, self.rng)
        syn.decode_ics(br, cpe.cur[1], m.sampling_index, m.object_type,
                       common_window, self.rng)
        if common_window:
            if ms_present:
                syn.apply_mid_side_stereo(cpe)
            if m.object_type == 1:
                syn.apply_prediction(cpe.ch[0], cpe.cur[0], m.sampling_index,
                                     SF_SCALE)
                syn.apply_prediction(cpe.ch[1], cpe.cur[1], m.sampling_index,
                                     SF_SCALE)
        elif m.object_type == 1:
            # !common_window: the reference predicts each channel inside
            # its decode_ics (aacdec.c:1381-1382), i.e. still before the
            # intensity fill; per-channel state makes the deferral exact
            syn.apply_prediction(cpe.ch[0], cpe.cur[0], m.sampling_index,
                                 SF_SCALE)
            syn.apply_prediction(cpe.ch[1], cpe.cur[1], m.sampling_index,
                                 SF_SCALE)
        syn.apply_intensity_stereo(cpe, ms_present)

    # ------------------------------------------------------------------
    def _apply_native_meta(self, cd, meta) -> None:
        ics = cd.ics
        ics.window_sequence_prev = ics.window_sequence
        ics.window_sequence = int(meta[0])
        ics.use_kb_window_prev = ics.use_kb_window
        ics.use_kb_window = int(meta[1])
        ics.max_sfb = int(meta[2])
        ics.num_windows = int(meta[3])
        ics.num_window_groups = int(meta[4])
        ics.group_len = [int(v) for v in meta[5:5 + ics.num_window_groups]]
        cd.tns = syn.TnsData()  # TNS already applied natively

    def _native_sce(self, br: BitReader, che) -> bool:
        """Returns False when the element needs the Python parser (the
        native engine signalled -2, e.g. a predictor-carrying ics_info);
        the bit position is untouched in that case."""
        res = self._parser.parse_sce(br._val.to_bytes(br.nbits // 8, "big"),
                                     br.pos, self.m4ac.sampling_index,
                                     self.rng[0])
        if res is None:
            return False
        coeffs, meta, newpos, self.rng[0] = res
        che.cur[0].coeffs = coeffs
        self._apply_native_meta(che.cur[0], meta)
        br.pos = newpos
        return True

    def _native_cpe(self, br: BitReader, che) -> bool:
        res = self._parser.parse_cpe(br._val.to_bytes(br.nbits // 8, "big"),
                                     br.pos, self.m4ac.sampling_index,
                                     self.rng[0])
        if res is None:
            return False
        (c0, c1), (m0, m1), newpos, self.rng[0] = res
        che.cur[0].coeffs = c0
        che.cur[1].coeffs = c1
        self._apply_native_meta(che.cur[0], m0)
        self._apply_native_meta(che.cur[1], m1)
        br.pos = newpos
        return True

    def _skip_dse(self, br: BitReader) -> None:
        byte_align = br.get1()
        count = br.get(8)
        if count == 255:
            count += br.get(8)
        if byte_align:
            br.align()
        if br.bits_left() < 8 * count:
            raise BitstreamError("overread in DSE")
        br.skip(8 * count)

    def _decode_extension(self, br: BitReader, cnt: int, che_prev,
                          etype_prev) -> None:
        """aacdec.c:1650-1690; SBR payload routing added in sbr module."""
        total = 8 * cnt
        start = br.pos
        while total > 0:
            ext_type = br.get(4)
            if (ext_type in (0xD, 0xE) and che_prev is not None
                    and self.m4ac.sbr != 0
                    and not (self.m4ac.sbr == -1 and self.locked)):
                # SBR signalling state machine (aacdec.c:1656-1676)
                crc = ext_type == 0xE
                from ..bitstream import sbr_syntax
                if self.m4ac.sbr == -1:
                    self.m4ac.sbr = 1
                    if self.m4ac.ps == -1 and self.channels == 1:
                        self.m4ac.ps = 1
                        if self.m4ac.chan_config:
                            self._configure(self.m4ac.chan_config)
                        else:
                            # PCE-configured (config 0): keep the PCE lane
                            # layout, add the PS second output per SCE
                            lanes = []
                            for lane in self.lanes:
                                lanes.append(lane)
                                if lane.elem_type == T.TYPE_SCE \
                                        and lane.ch == 0:
                                    lanes.append(LaneRef(
                                        lane.elem_type, lane.elem_id, 1))
                            self.lanes = lanes
                used = sbr_syntax.decode_sbr_extension(
                    self, br, che_prev, crc, cnt, etype_prev)
                total -= used * 8
            elif ext_type == 0xB:  # EXT_DYNAMIC_RANGE (aacdec.c:1679)
                from ..bitstream.drc import (DynamicRangeControl,
                                             decode_dynamic_range)
                if not hasattr(self, "che_drc"):
                    self.che_drc = DynamicRangeControl()
                used = decode_dynamic_range(self.che_drc, br)
                total -= used * 8
            else:
                br.skip(total - 4)
                total = 0
        br.pos = max(br.pos, start + 8 * cnt)

    def _spectral_to_sample(self, present):
        m = self.m4ac
        _host_couple_and_tns(self)
        all_lanes = self.lanes + self.cce_lanes
        # assemble the device batch
        B = len(all_lanes)
        core = dict(coeffs=np.zeros((B, 1024), np.float32),
                    ws=np.zeros(B, np.int32), wsp=np.zeros(B, np.int32),
                    kbd=np.zeros(B, np.int32), kbdp=np.zeros(B, np.int32))
        for i, lane in enumerate(all_lanes):
            el = self.elements[(lane.elem_type, lane.elem_id)]
            cd = el.cur[lane.ch]
            if cd.coeffs is None or not el.present_this_frame:
                continue
            core["coeffs"][i] = cd.coeffs
            core["ws"][i] = cd.ics.window_sequence
            core["wsp"][i] = cd.ics.window_sequence_prev
            core["kbd"][i] = cd.ics.use_kb_window
            core["kbdp"][i] = cd.ics.use_kb_window_prev
        multiplier = (m.ext_sample_rate > m.sample_rate) if m.sbr == 1 else 0
        samples = 1024 << multiplier
        jobs = self._sbr_jobs(all_lanes) if m.sbr == 1 else []
        edges = _point3_edges(self, {(ln.elem_type, ln.elem_id, ln.ch): i
                                     for i, ln in enumerate(all_lanes)})
        dev = self.device
        groups = dict(core=core)
        for j, job in enumerate(jobs):
            groups[f"sbr{j}"] = job["plan"]
            if job["ps"] is not None:
                groups[f"ps{j}"] = job["ps"]
        up = _upload(groups, dev)
        if self.saved is None or len(self.saved) != B:
            self.saved = torch.zeros((B, 512), device=dev)
        c = up["core"]
        time_out, self.saved = core_frame(c["coeffs"], self.saved, c["ws"],
                                          c["wsp"], c["kbd"], c["kbdp"],
                                          *core_consts(dev))
        ret = torch.cat([time_out, torch.zeros_like(time_out)], 1)
        for j, job in enumerate(jobs):
            self._apply_sbr(ret, job, up[f"sbr{j}"], up.get(f"ps{j}"))
        # independent coupling AFTER_IMDCT (aacdec.c:1849-1862)
        if edges:
            src = ret
            ret = ret.clone()
            for tgt, lane, gain in edges:
                ret[tgt] += gain * src[lane]
        self.sample_rate = m.sample_rate << multiplier
        pcm = torch.clamp(torch.round(ret[:len(self.lanes), :samples]),
                          -32768, 32767).to(torch.int16)
        return pcm.T.cpu()   # [samples, channels]

    def _sbr_jobs(self, all_lanes) -> list:
        """The host half of ``_apply_sbr`` for every element that runs SBR
        this frame (aacdec.c:1924-1926), in lane order: its lanes and its
        SBR and PS plans, the parsed contexts advanced as the reference
        advances them."""
        lane_of = {(ln.elem_type, ln.elem_id, ln.ch): i
                   for i, ln in enumerate(all_lanes)}
        done = set()
        jobs = []
        for lane in all_lanes:
            key = (lane.elem_type, lane.elem_id)
            if key in done:
                continue
            el = self.elements[key]
            if key[0] == T.TYPE_CCE:
                # only AFTER_IMDCT CCEs run the filterbank + SBR (pure
                # upsampling: their sbr ctx never starts); dependent CCEs
                # feed targets pre-IMDCT and their ret is never read
                # (aacdec.c:1919-1926)
                if el.coup is None or el.coup.coupling_point != 3:
                    continue
            done.add(key)
            if not el.present_this_frame:
                continue
            if el.sbr is None:
                el.sbr = SBRContext()
            if not el.sbr.sample_rate:
                el.sbr.sample_rate = 2 * self.m4ac.sample_rate
            if not self.m4ac.ext_sample_rate:
                self.m4ac.ext_sample_rate = 2 * self.m4ac.sample_rate
            nch = 2 if key[0] == T.TYPE_CPE else 1
            # a CPE's two lanes, or a mono element's one and, with PS, two
            lanes = [lane_of[key + (ch,)] for ch in (0, 1)
                     if key + (ch,) in lane_of]
            job = dict(key=key, nch=nch, lanes=lanes,
                       downsampled=(self.m4ac.ext_sample_rate
                                    < el.sbr.sample_rate),
                       plan=sbr_single.prepare(el.sbr, key[0], nch),
                       ps=None, stereo=self.m4ac.ps == 1)
            if job["stereo"] and el.sbr.ps is not None and el.sbr.ps.start:
                job["ps"] = ps_single.prepare(el.sbr.ps,
                                              el.sbr.kx[1] + el.sbr.m[1])
            jobs.append(job)
        return jobs

    def _apply_sbr(self, ret, job, plan, ps_plan) -> None:
        """The device half for one element (``sbr_np.sbr_apply`` with
        ``ps_np.ps_apply``): its core samples from ``ret`` [B,2048] in,
        its SBR output rows written back in place."""
        el = self.elements[job["key"]]
        st = getattr(el.sbr, "dev", None)       # beside the parsed context
        if st is None or st.x_hist.shape[0] != job["nch"]:
            st = el.sbr.dev = sbr_single.SbrState.zeros(job["nch"],
                                                        self.device)
        lanes = job["lanes"]
        x = ret[lanes[:job["nch"]], :1024]
        ps_apply = None
        if ps_plan is not None:
            ps = el.sbr.ps
            if getattr(ps, "dev", None) is None:
                ps.dev = ps_single.PsState.zeros(self.device)
            ps_apply = lambda X: ps_single.ps_apply(  # noqa: E731
                ps.dev, X[:1], ps_plan)
        elif job["stereo"]:
            ps_apply = lambda X: (X[:1], X[:1])  # noqa: E731
        out = sbr_single.sbr_apply(el.sbr, st, x, plan, job["downsampled"],
                                   ps_apply)
        ret[lanes, :out.shape[1]] = out[:len(lanes)]

    def _apply_dependent_coupling_stage(self, coupling_point: int,
                                        before_tns: bool) -> None:
        ccs = [el for (t, _), el in self.elements.items()
               if t == T.TYPE_CCE and el.coup is not None
               and el.present_this_frame]
        if before_tns:
            # TNS for CCE channels themselves is applied with everything else
            pass
        for cce in ccs:
            if cce.coup.coupling_point != coupling_point:
                continue
            self._fan_out_coupling(cce, syn.apply_dependent_coupling)

    def _fan_out_coupling(self, cce, fn) -> None:
        coup = cce.coup
        index = 0
        for c in range(coup.num_coupled + 1):
            key = (coup.type[c], coup.id_select[c])
            target = self.elements.get(key)
            ch_sel = coup.ch_select[c]
            if target is None or not target.present_this_frame:
                index += 1 + (ch_sel == 3)
                continue
            if ch_sel != 1:
                fn(target.cur[0], cce, index)
                if ch_sel != 0:
                    index += 1
            if ch_sel != 2:
                fn(target.cur[1], cce, index)
                index += 1
