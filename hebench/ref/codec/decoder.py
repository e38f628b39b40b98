"""Single-stream decoder: the benchmark's plain reference.

ADTS or ASC-configured AAC in, interleaved int16 PCM out, mirroring
libavcodec's ``avcodec_open``/``avcodec_decode_audio3`` pair
(utils.c:462,638) and the aacdec.c element loop (aacdec.c:1973-2107).
A copy of the JAX package's single-stream ``Decoder`` with every element
parsed by the Python bitstream code (no native parser) and the core,
SBR and PS computed in NumPy (``core.core_frame_np``, ``ops.sbr_np``,
``ops.ps_np``).  ``transform`` replaces ``imdct_half`` in the core and
the QMF banks (the control passes ``ops.imdct.imdct_half_tf32``).
"""
from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..bitstream import aac_syntax as syn
from ..bitstream.adts import parse_adts_header, split_adts_stream
from ..bitstream.asc import M4AConfig, parse_audio_specific_config
from ..bitstream.reader import BitReader, BitstreamError
from ..tables import aac_tables as T
from ..ops.imdct import imdct_half_ref
from .core import core_frame_np

SF_SCALE = np.float32(1.0 / -1024.0)  # no-bias path (aacdec.c:579)


@dataclass
class LaneRef:
    elem_type: int
    elem_id: int
    ch: int


class Decoder:
    """Stateful AAC / HE-AAC decoder for one stream."""

    def __init__(self, asc: bytes | None = None, adts_probe: bytes | None = None,
                 transform=imdct_half_ref):
        self.transform = transform
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
    def decode_frame(self, packet: bytes) -> np.ndarray:
        """Decode one ADTS frame / raw_data_block -> int16 [samples, ch]."""
        br = BitReader(packet)
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

        frame_elements = self._parse_raw_data_block(br)
        out = self._spectral_to_sample(frame_elements)
        self.locked = True
        return out

    def decode(self, data: bytes) -> np.ndarray:
        """Decode a whole ADTS byte stream -> int16 [samples, channels].

        Per-frame error isolation (matches the reference CLI contract):
        a corrupt frame is skipped with a warning and decoding continues
        at the next syncword; see ``error_count``.
        """
        frames = split_adts_stream(data)
        chunks = []
        for f in frames:
            try:
                chunks.append(self.decode_frame(f))
            except BitstreamError as e:
                self.error_count += 1
                import logging
                logging.getLogger("hebench.ref").warning("frame dropped: %s", e)
        return np.concatenate(chunks, axis=0) if chunks else np.zeros((0, 1), np.int16)

    # ------------------------------------------------------------------
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
                syn.decode_ics(br, che.cur[0], m.sampling_index,
                               m.object_type, 0, self.rng)
                if m.object_type == 1:
                    syn.apply_prediction(che.ch[0], che.cur[0],
                                         m.sampling_index, SF_SCALE)
                present.append((etype, eid))
            elif etype == T.TYPE_CPE:
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
            import copy
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

    # ------------------------------------------------------------------
    def _spectral_to_sample(self, present) -> np.ndarray:
        m = self.m4ac
        # dependent coupling (BEFORE_TNS then BETWEEN_TNS_AND_IMDCT), TNS
        all_lanes = self.lanes + self.cce_lanes
        self._apply_dependent_coupling_stage(0, before_tns=True)
        # TNS
        for lane in all_lanes:
            el = self.elements[(lane.elem_type, lane.elem_id)]
            cd = el.cur[lane.ch]
            if el.present_this_frame and cd.coeffs is not None                     and cd.tns.present:
                syn.apply_tns(cd.coeffs, cd)
                cd.tns = syn.TnsData()
        self._apply_dependent_coupling_stage(1, before_tns=False)
        # assemble device batch
        B = len(all_lanes)
        coeffs = np.zeros((B, 1024), np.float32)
        ws = np.zeros(B, np.int32)
        wsp = np.zeros(B, np.int32)
        kbd = np.zeros(B, np.int32)
        kbdp = np.zeros(B, np.int32)
        for i, lane in enumerate(all_lanes):
            el = self.elements[(lane.elem_type, lane.elem_id)]
            cd = el.cur[lane.ch]
            if cd.coeffs is None or not el.present_this_frame:
                continue
            coeffs[i] = cd.coeffs
            ws[i] = cd.ics.window_sequence
            wsp[i] = cd.ics.window_sequence_prev
            kbd[i] = cd.ics.use_kb_window
            kbdp[i] = cd.ics.use_kb_window_prev
        if self.saved is None or len(self.saved) != B:
            self.saved = np.zeros((B, 512), np.float32)
        time_out, self.saved = core_frame_np(coeffs, self.saved, ws, wsp,
                                             kbd, kbdp, self.transform)

        multiplier = (m.ext_sample_rate > m.sample_rate) if m.sbr == 1 else 0
        samples = 1024 << multiplier
        ret = np.zeros((B, 2048), np.float32)
        ret[:, :1024] = time_out
        if m.sbr == 1:
            self._apply_sbr(ret, all_lanes)
        # independent coupling AFTER_IMDCT (aacdec.c:1849-1862)
        ret = self._apply_independent_coupling(ret, all_lanes)
        self.sample_rate = m.sample_rate << multiplier
        pcm_f = ret[: len(self.lanes), :samples]
        pcm = np.clip(np.rint(pcm_f), -32768, 32767).astype(np.int16)
        return pcm.T.copy()  # [samples, channels] interleaved

    def _apply_sbr(self, ret: np.ndarray, all_lanes) -> None:
        """Apply SBR per channel element (aacdec.c:1924-1926)."""
        from ..bitstream.sbr_syntax import SBRContext
        from ..ops import sbr_np
        lane_of = {(l.elem_type, l.elem_id, l.ch): i
                   for i, l in enumerate(all_lanes)}
        done = set()
        for lane in all_lanes:
            key = (lane.elem_type, lane.elem_id)
            if key in done:
                continue
            if key[0] == T.TYPE_CCE:
                el = self.elements[key]
                # only AFTER_IMDCT CCEs run the filterbank + SBR (pure
                # upsampling: their sbr ctx never starts); dependent CCEs
                # feed targets pre-IMDCT and their ret is never read
                # (aacdec.c:1919-1926)
                if el.coup is None or el.coup.coupling_point != 3:
                    continue
            done.add(key)
            el = self.elements[key]
            if not el.present_this_frame:
                continue
            if el.sbr is None:
                el.sbr = SBRContext()
            if not el.sbr.sample_rate:
                el.sbr.sample_rate = 2 * self.m4ac.sample_rate
            if not self.m4ac.ext_sample_rate:
                self.m4ac.ext_sample_rate = 2 * self.m4ac.sample_rate
            li0 = lane_of[(key[0], key[1], 0)]
            li1 = lane_of.get((key[0], key[1], 1), li0)
            L = ret[li0]
            R = ret[li1] if li1 != li0 else np.zeros(2048, np.float32)
            from ..ops.ps_np import ps_apply
            sbr_np.sbr_apply(self.m4ac, el.sbr, lane.elem_type, L, R,
                             ps_apply=ps_apply, transform=self.transform)
            ret[li0] = L
            if li1 != li0:
                ret[li1] = R

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

    def _apply_independent_coupling(self, time_out, all_lanes) -> np.ndarray:
        ccs = [(key, el) for key, el in self.elements.items()
               if key[0] == T.TYPE_CCE and el.coup is not None
               and el.present_this_frame and el.coup.coupling_point == 3]
        if not ccs:
            return time_out
        lane_of = {(l.elem_type, l.elem_id, l.ch): i
                   for i, l in enumerate(all_lanes)}
        out = time_out.copy()
        for key, cce in ccs:
            src = time_out[lane_of[(T.TYPE_CCE, key[1], 0)]]
            coup = cce.coup
            index = 0
            for c in range(coup.num_coupled + 1):
                tkey = (coup.type[c], coup.id_select[c])
                ch_sel = coup.ch_select[c]
                if self.elements.get(tkey) is None:
                    index += 1 + (ch_sel == 3)
                    continue
                if ch_sel != 1:
                    li = lane_of.get((tkey[0], tkey[1], 0))
                    if li is not None:
                        out[li] = out[li] + coup.gain[index][0] * src
                    if ch_sel != 0:
                        index += 1
                if ch_sel != 2:
                    li = lane_of.get((tkey[0], tkey[1], 1))
                    if li is not None:
                        out[li] = out[li] + coup.gain[index][0] * src
                    index += 1
        return out
