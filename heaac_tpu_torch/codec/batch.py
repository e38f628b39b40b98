"""Batched decode of many independent streams, and the mixed-batch
front door ``decode_batch``.

Counterparts: ``heaac_tpu/codec/batch.py`` — QwirePipelinedDecoder
(with its Python-planner fallback and Python profile parse),
decode_qwire_flip_stream, LcStreamBatchDecoder (with its LC-planner
branch), decode_batch (with its Python prober), _decode_bucket_retry
(with its last fallback, the single-stream ``codec/decoder.Decoder`` on
decode_batch's device), _decode_bucket; and the plan-record decoders
_pad_plan_frames, _he_plan_defaults, StreamBatchDecoder (compact or
dense plans), BatchDecoder and QStreamBatchDecoder, which no entry point
uses: their plans come from ``planner.parse_stream_plans`` and run
through ``heaac_graph.scan_decode`` (QStreamBatchDecoder: the qwire
scan).  The JAX package's pipelined decoder of packed, XOR-whitened
plan records has no counterpart: ``QwirePipelinedDecoder`` is the
port's one group pipeline, and ``parallel.sharding.
ShardedQwireDecoder`` runs that pipeline with its lanes over cards.

QwirePipelinedDecoder (HE-AAC v1/v2): the native parser (``native.py``)
writes each group of streams into a byte heap + per-frame-lane records
(the qwire format) in host staging buffers (pinned when the device is
CUDA, two sets); each group is uploaded with non-blocking copies and
decoded by the whole-stream scan (``heaac_graph.qwire_scan_decode``).
The parse of group g+1 runs on a worker thread (the native call releases
the GIL) while the main thread issues group g's decode.  A stream the
native parser refuses is parsed by the Python planner
(``planner.parse_stream_qwire``) into the same staging.  A stream's lanes
are its output channels (a CPE two, PS or a mono core one), then one
lane per coupling channel element; AFTER_IMDCT coupling travels as
per-group edge arrays beside the heap and records.

LcStreamBatchDecoder (AAC-LC / Main): the native whole-stream parser
gives every frame's dequantized spectra, or, for a stream it refuses
(PCE / CCE / SSR), the LC planner (``planner.LcPlanningDecoder``) its
core plans and AFTER_IMDCT edges; one upload, then the IMDCT /
overlap-add scan (``heaac_graph.lc_scan_decode``, which mixes the
coupling into the float output before rounding).

Differences from the JAX package:
  - the decoder's profile (lanes, SBR, PS band mode) comes from a native
    probe of stream 0's first two frames, with the output lanes of a
    channel configuration 0 stream from its first frame's program config
    element (``host.pce_lanes``); only where the probe refuses or its
    lanes disagree with the layout from the Python planner, which the
    JAX package always runs;
  - the single-stream fallback also logs an INFO record with a
    ``single_stats`` dict (the JAX package logs only its WARNING);
  - the heap travels as a uint8 tensor (the f32 view existed only for
    the TPU transport).
"""
from __future__ import annotations

import ctypes as C
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from .. import tables as TB
from ..device import resolve
from ..host import (R_TOKOFF, R_W1, REC_W, count_adts_frames,
                    parse_adts_header, pce_lanes, rows_pair_static,
                    silence_lane, spec_static_args, split_adts_stream)
from ..utils.metrics import log
from ..utils.trace import count, current, span
from . import compact_plan, frame_plan
from .heaac_graph import (heaac_frame, init_compact_state, init_qwire_carry,
                          init_qwire_flip_carry, init_state, lc_scan_decode,
                          qwire_scan_decode, qwire_scan_decode_flip,
                          scan_decode, to_int16)
from .decoder import Decoder
from .planner import (LcPlanningDecoder, parse_stream_plans,
                      parse_stream_qwire)


def _layout_lanes(chan_config: int) -> int:
    """Output lanes of an ADTS channel config's default layout (a CPE
    is two lanes); 0 for config 0, whose layout comes in a PCE."""
    return sum(2 if et == TB.TYPE_CPE else 1
               for et, _ in TB.CHANNEL_LAYOUT_MAP.get(chan_config, ()))


def _flatten_couple(couples: list, nl: int, T: int):
    """Per-slot (edges [K, 3], gains [nf, K]) or None -> the group's
    AFTER_IMDCT edge arrays over its lanes (slot b's lanes start at
    b * nl): (etgt [K], etch [K], esrc [K] int64, gains [T, K] f32, 0
    past a stream's last frame), or None when no slot couples."""
    rows, cols = [], []
    for b, couple in enumerate(couples):
        if couple is None:
            continue
        struct, gains = couple
        rows.append(struct + np.array([b * nl, 0, b * nl]))
        col = np.zeros((T, struct.shape[0]), np.float32)
        col[:len(gains)] = gains[:T]
        cols.append(col)
    if not rows:
        return None
    e = np.concatenate(rows).astype(np.int64)
    return e[:, 0], e[:, 1], e[:, 2], np.concatenate(cols, 1)


def pack_planner_frames(streams_frames: list, nl: int, T: int, heap=None,
                        cur: int = 0, recs=None, lane0: int = 0):
    """Write planner frames (``parse_stream_qwire``'s: per frame a list of
    (payload, record) per lane) of several streams into a byte heap and
    records: stream k's frame t, lane ln goes to recs[t, lane0 + k * nl +
    ln], its payload to the heap from byte ``cur`` on.  Frame-lanes a
    stream does not reach keep their records.  Without ``heap`` and
    ``recs`` fresh ones are made: the silence lane's payload at byte 0,
    every record pointing at it, and room for every payload plus 4 KB
    of zeros.  -> (heap uint8 [N], cur, recs int32 [T, L, REC_W]), or None
    when the payloads do not fit in ``heap``."""
    if heap is None:
        sil_payload, sil_rec = silence_lane()
        size = len(sil_payload) + sum(len(p) for frames in streams_frames
                                      for fr in frames[:T] for p, _ in fr)
        heap = np.zeros(size + 4096, np.uint8)
        heap[:len(sil_payload)] = np.frombuffer(sil_payload, np.uint8)
        cur = len(sil_payload)
        recs = np.broadcast_to(
            sil_rec, (T, lane0 + len(streams_frames) * nl, REC_W)).copy()
    for k, frames in enumerate(streams_frames):
        base = lane0 + k * nl
        for t, fr in enumerate(frames[:T]):
            for ln, (payload, rec) in enumerate(fr):
                if cur + len(payload) > heap.nbytes:
                    return None
                heap[cur:cur + len(payload)] = np.frombuffer(payload,
                                                             np.uint8)
                recs[t, base + ln] = rec
                recs[t, base + ln, R_TOKOFF] = cur
                cur += len(payload)
    return heap, cur, recs


def _planner_couple(couple):
    """parse_stream_qwire's coupling series (edge list, gains) -> the
    native parser's (edges [K, 3] int array, gains [T, K]), or None."""
    if couple is None:
        return None
    struct, gains = couple
    return np.array(struct, np.int64).reshape(-1, 3), gains


class QwirePipelinedDecoder:
    """End-to-end pipelined batched decode over the quantized wire
    format; ``decode()`` returns one pcm tensor [T, L, 2, 2048] int16 per
    stream group, on ``device``: the card unless the caller passes
    ``device="cpu"`` (without a card the default raises RuntimeError).
    Stream i sits in group ``group_of[i]`` at lanes ``slot_of[i] * nl``
    onwards; its first ``out_nl`` lanes are output channels, the rest
    its coupling channels' lanes.  The lanes, output lanes, rate and PS
    band mode come from the native probe of stream 0, or from the Python
    planner's parse of it where the probe refuses it or its lanes
    disagree with its layout.  A stream the native parser refuses is
    parsed by the Python planner; one whose PS band mode flips raises
    NotImplementedError("PS band mode changes mid-stream"), which
    ``decode_batch`` answers with ``decode_qwire_flip_stream``."""

    def __init__(self, streams, group_streams: int = 256,
                 max_frames: int | None = None, token_cap: int = 640,
                 device="cuda"):
        self.device = resolve(device)
        self.streams = [bytes(s) for s in streams]
        self.hdr = parse_adts_header(self.streams[0][:7])
        self.G = min(group_streams, len(self.streams))
        self.parser = native.Parser()
        profile = self._native_profile()
        if profile is None:
            # the JAX constructor's profile parse (batch.py:947-953)
            log.info("qwire pipelined decode: stream 0's profile from the "
                     "Python planner")
            info0 = {}
            _, rate, self.nl, self.is34, self.ds = parse_stream_qwire(
                self.streams[0], max_frames=max_frames, info_out=info0)
            self.out_nl = info0["out_nl"]
            self.sample_rate = rate
        else:
            self.nl, self.out_nl, self.sample_rate, self.is34 = profile
            # ADTS signals SBR implicitly: never the downsampled mode
            self.ds = 0
        counts = [count_adts_frames(s) for s in self.streams]
        if max_frames is not None:
            counts = [min(c, max_frames) for c in counts]
        self.T = max_frames if max_frames is not None else max(counts)
        n = len(self.streams)
        # length bucketing: groups in ascending frame-count order, each
        # scanned over its own longest stream (rounded up to 32)
        self.order = sorted(range(n), key=lambda i: counts[i])
        self.group_of = {}
        self.slot_of = {}
        self.group_T = []
        for g0 in range(0, n, self.G):
            idxs = self.order[g0:g0 + self.G]
            for slot, i in enumerate(idxs):
                self.group_of[i] = g0 // self.G
                self.slot_of[i] = slot
            tg = max(counts[i] for i in idxs)
            self.group_T.append(min(self.T, -(-max(tg, 1) // 32) * 32))
        self.S = token_cap
        self.NB = 0
        self.MS = 0
        self.NS = 52
        self.SEC = 8
        self.RP = 0
        self.rate_idx = self.hdr.sampling_index
        self.L = self.G * self.nl
        self.frame_counts: list = []
        self.error_count = 0
        sil_payload, sil_rec = silence_lane()
        self._sil_payload = sil_payload
        self._sil_recs = np.broadcast_to(
            sil_rec, (self.T, self.L, REC_W)).copy()
        cap = len(sil_payload) + self.T * self.L * 1536
        cap += (-cap) % 4
        self._cap = cap
        self._bufsets = [None, None]
        # CUDA events per staging set: one per card its upload went to
        self._uploaded = [[], []]

    def _native_profile(self):
        """(lanes, output lanes, rate, is34) of stream 0 from the native
        probe and its layout, or None where the probe refuses the stream
        or its lanes disagree with the layout."""
        probe = self.parser.probe(self.streams[0], self.hdr)
        if probe is None:
            return None
        nl = probe["lanes"]
        if self.hdr.chan_config:
            out_nl = _layout_lanes(self.hdr.chan_config)
            n_cce = nl - out_nl
        else:
            try:
                out_nl, n_cce = pce_lanes(
                    self.streams[0][:self.hdr.frame_length])
            except NotImplementedError:      # no PCE opens frame 0
                return None
        if n_cce < 0 or out_nl + n_cce != nl:
            return None
        return (nl, out_nl, self.hdr.sample_rate << probe["sbr"],
                probe["is34"])

    def _buffers(self, bufset: int):
        if self._bufsets[bufset] is None:
            pin = self.device.type == "cuda"
            heap_t = torch.zeros(self._cap, dtype=torch.uint8,
                                 pin_memory=pin)
            recs_t = torch.empty((self.T, self.L, REC_W), dtype=torch.int32,
                                 pin_memory=pin)
            heap, recs = heap_t.numpy(), recs_t.numpy()
            heap[:len(self._sil_payload)] = np.frombuffer(
                self._sil_payload, np.uint8)
            recs[:] = self._sil_recs
            self._bufsets[bufset] = (heap_t, recs_t, heap, recs)
        return self._bufsets[bufset]

    def _wait_uploads(self, bufsets=(0, 1)) -> None:
        for b in bufsets:
            for ev in self._uploaded[b]:
                ev.synchronize()
            self._uploaded[b] = []

    def _grow(self) -> None:
        """Double the heap staging; all uploads must have finished."""
        self._wait_uploads()
        self._cap *= 2
        self._bufsets = [None, None]
        count("heap.grows")
        log.info("qwire pipelined decode: heap grown to %d KB",
                 self._cap >> 10)

    def _parse_group(self, group: list, bufset: int, T: int,
                     n_real: int | None = None):
        """Parse one group into staging set ``bufset`` -> (heap, cur, recs)
        numpy views and the group's AFTER_IMDCT edges (``_flatten_couple``;
        arrays of their own, so the next parse cannot overwrite them), or
        None when the heap overflowed (grow + retry).  A stream the native
        parser refuses (or whose lanes differ from the group's) is parsed
        again by the Python planner, as the JAX package does."""
        self._wait_uploads((bufset,))
        _, _, heap, recs = self._buffers(bufset)
        recs[:T] = self._sil_recs[:T]
        cur = len(self._sil_payload)
        n_counts0 = len(self.frame_counts)
        err0 = self.error_count
        fn = self.parser.parse_qwire
        heap_p = heap.ctypes.data_as(C.POINTER(C.c_uint8))
        recs_p = recs.ctypes.data_as(C.POINTER(C.c_int32))
        info = np.zeros(8, np.int32)
        info_p = info.ctypes.data_as(C.POINTER(C.c_int32))
        cedges = np.zeros(native.EDGE_MAX * 3, np.int32)
        cgains = np.zeros((T, native.EDGE_MAX), np.float32)
        cedges_p = cedges.ctypes.data_as(C.POINTER(C.c_int32))
        cgains_p = cgains.ctypes.data_as(C.POINTER(C.c_float))
        cur_c = C.c_int64(cur)
        h = self.hdr
        couples = [None] * len(group)
        edges_dirty = False
        for gi, data in enumerate(group):
            lane0 = gi * self.nl
            if edges_dirty:
                # the parser writes gains only where a CCE is present:
                # clear the previous stream's
                cgains[:] = 0
                edges_dirty = False
            nf = fn(data, len(data), h.sampling_index, h.sample_rate,
                    h.chan_config, heap_p, heap.nbytes, C.byref(cur_c),
                    recs_p, T, recs.shape[1], lane0, info_p, cedges_p,
                    cgains_p, native.EDGE_MAX)
            if nf >= 0 and int(info[0]) == self.nl:
                if int(info[2]) != self.is34:
                    raise ValueError(
                        f"stream {gi} of the group: PS band mode is34="
                        f"{int(info[2])} in a batch of is34={self.is34}; "
                        "route mixed inputs through decode_batch")
                cur = int(cur_c.value)
                ne = int(info[4])
                if ne:
                    edges_dirty = True
                if n_real is None or gi < n_real:
                    self.error_count += int(info[3])
                    if ne:
                        couples[gi] = (
                            cedges[:3 * ne].reshape(ne, 3).copy(),
                            cgains[:nf, :ne].copy())
                self.frame_counts.append(nf)
                if nf < T:
                    recs[nf:T, lane0:lane0 + self.nl] = \
                        self._sil_recs[nf:T, lane0:lane0 + self.nl]
                continue
            cur_c.value = cur          # drop the native parse's writes
            edges_dirty = True         # it may have written gains
            if nf == -3:               # heap full: grow + retry the group
                del self.frame_counts[n_counts0:]
                self.error_count = err0
                return None
            cur = self._parse_planner(gi, data, heap, cur, recs, T, lane0,
                                      n_real, couples)
            if cur is None:
                del self.frame_counts[n_counts0:]
                self.error_count = err0
                return None
            cur_c.value = cur
        maxtok = int((recs[:T, :, R_W1] & 0xFFFF).max())
        if maxtok > self.S:
            self.S = -(-maxtok // 64) * 64
        sa = spec_static_args(recs[:T])
        self.NB = max(self.NB, sa["NB"])
        self.MS = max(self.MS, sa["MS"])
        self.NS = max(self.NS, sa["NS"])
        self.SEC = max(self.SEC, sa["SEC"])
        self.RP = max(self.RP, rows_pair_static(heap[:cur], recs[:T]))
        return heap, cur, recs, _flatten_couple(couples, self.nl, T)

    def _parse_planner(self, gi: int, data: bytes, heap, cur: int, recs,
                       T: int, lane0: int, n_real, couples: list):
        """The Python planner's parse of stream ``gi`` of the group into the
        staging at lane0 (JAX batch.py:1093-1127) -> the new heap cursor,
        or None when the heap is full."""
        log.info("qwire pipelined decode: stream %d fell back to the Python "
                 "planner", gi)
        count("planner.streams")
        errs, pinfo = [], {}
        frames_q, rate, nl, is34, ds = parse_stream_qwire(
            data, max_frames=T, err_out=errs, info_out=pinfo)
        if ds:
            raise NotImplementedError(
                f"stream {gi} of the group: downsampled SBR, which ADTS "
                "never signals (it takes an AudioSpecificConfig: "
                "planner.parse_stream_qwire(data, asc=...) into "
                "heaac_graph.qwire_scan_decode(downsampled=1))")
        if (rate, nl, is34) != (self.sample_rate, self.nl, self.is34):
            raise ValueError(
                f"stream {gi} of the group: profile (rate, lanes, is34) "
                f"{(rate, nl, is34)} differs from the batch's "
                f"{(self.sample_rate, self.nl, self.is34)}; route mixed "
                "inputs through decode_batch")
        if n_real is None or gi < n_real:
            self.error_count += errs[0]
            couples[gi] = _planner_couple(pinfo["couple"])
        r = pack_planner_frames([frames_q], self.nl, T, heap, cur, recs,
                                lane0)
        if r is None:
            return None
        self.frame_counts.append(len(frames_q))
        return r[1]

    def _static_args(self) -> dict:
        return dict(S=self.S, rate_idx=self.rate_idx, NB=self.NB, MS=self.MS,
                    NS=self.NS, SEC=self.SEC, rows_pair=self.RP)

    def _parse_with_retry(self, gidx: int, parent=None):
        """Parse group ``gidx`` into staging set gidx % 2 -> (cur, Tg,
        static decode sizes as of this group, its coupling edges).  Its
        ``group.parse`` span takes ``parent`` (on the worker thread: the
        span that ``decode`` was called in) and the group's frames and
        errored frames."""
        idxs = self.order[gidx * self.G:(gidx + 1) * self.G]
        group = [self.streams[i] for i in idxs]
        n_real = len(group)
        if len(group) < self.G:
            group = group + [group[0]] * (self.G - len(group))
        Tg = self.group_T[gidx]
        with span("group.parse", parent, group=gidx) as sp:
            n0, err0 = len(self.frame_counts), self.error_count
            for _ in range(6):
                r = self._parse_group(group, gidx % 2, Tg, n_real)
                if r is not None:
                    sp.set(frames=sum(self.frame_counts[n0:n0 + n_real]),
                           errored=self.error_count - err0)
                    return r[1], Tg, self._static_args(), r[3]
                self._grow()
            raise MemoryError("qwire heap kept overflowing")

    def _upload(self, bufset: int, cur: int, Tg: int, couple=None):
        """Staging set (and the group's coupling edges) -> device tensors
        (non-blocking from pinned memory on CUDA, with an event the next
        parse of this set waits on).  A step of ``decode``'s group loop,
        which a subclass may override with its ``_scan`` and
        ``_collect``."""
        heap_t, recs_t, _, _ = self._bufsets[bufset]
        n_up = min(cur + (1 << 18), self._cap)
        cuda = self.device.type == "cuda"
        heap_d = heap_t[:n_up].to(self.device, non_blocking=cuda)
        recs_d = recs_t[:Tg].to(self.device, non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._uploaded[bufset] = [ev]
        if couple is not None:
            couple = tuple(torch.from_numpy(a).to(self.device)
                           for a in couple)
        return heap_d, recs_d, couple

    def _scan(self, heap_d, recs_d, sa: dict, couple=None):
        """One group's qwire scan over the lanes of ``recs_d``, on their
        device -> pcm [Tg, lanes, 2, 2048] int16."""
        carry = init_qwire_carry(recs_d.shape[1], recs_d.device)
        _, pcm = qwire_scan_decode(heap_d, recs_d, carry, self.is34, self.ds,
                                   couple=couple, **sa)
        return pcm

    def _collect(self, outs: list) -> list:
        """``_scan``'s outputs, one per group -> ``decode()``'s result,
        after the device is done."""
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return outs

    def decode(self):
        """Parse + upload + decode all streams, pipelined by group: the
        parse of group g+1 runs on a worker thread (the native parser
        keeps static state: one thread) while this thread issues group
        g's decode.  Returns pcm tensors [T, L, 2, 2048] int16 (one per
        group) on the device, after the device is done."""
        n = len(self.streams)
        ngroups = -(-n // self.G)
        self.frame_counts = []
        self.error_count = 0
        outs = []
        parent = current()
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._parse_with_retry, 0, parent)
            for gidx in range(ngroups):
                with span("group.parse_wait", group=gidx):
                    cur, Tg, sa, couple = fut.result()
                with span("group.upload", group=gidx):
                    heap_d, recs_d, couple_d = self._upload(gidx % 2, cur,
                                                            Tg, couple)
                if gidx + 1 < ngroups:
                    fut = pool.submit(self._parse_with_retry, gidx + 1,
                                      parent)
                with span("group.scan", group=gidx, steps=Tg):
                    outs.append(self._scan(heap_d, recs_d, sa, couple_d))
        outs = self._collect(outs)
        self._counts_in_input_order()
        return outs

    def stream_pcm(self, outs) -> list:
        """``decode()``'s group tensors -> one CPU int16 tensor [n, ch]
        per stream, in input order: stereo for a mono core (PS), one
        channel per output lane otherwise; coupling lanes are dropped.

        Each group is put in stream-major order, output lanes only
        ([G, Tg, N, ch]), by one copy on its own device; a card's group
        then goes to page-locked host memory in one copy that does not
        block, all of them waited on once.  Every stream is one
        contiguous copy out of that into a pageable tensor of its own,
        so no result shares storage with another or with a later call.
        Counters ``pcm.d2h_copies`` / ``pcm.d2h_bytes``: the groups
        copied off a card, and their bytes."""
        lps, nl = self.out_nl, self.nl
        hosts, events = [], []
        for pcm in outs:
            Tg, L, _, N = pcm.shape
            slots = pcm.reshape(Tg, L // nl, nl, 2, N)
            # mono core -> its lane's two channels; else channel 0 a lane
            lanes = slots[:, :, 0] if lps == 1 else slots[:, :, :lps, 0]
            sm = lanes.permute(1, 0, 3, 2).contiguous()   # [G, Tg, N, ch]
            if sm.is_cuda:
                host = torch.empty(sm.shape, dtype=sm.dtype, pin_memory=True)
                host.copy_(sm, non_blocking=True)
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(sm.device))
                events.append(ev)
                count("pcm.d2h_copies")
                count("pcm.d2h_bytes", host.nbytes)
                sm = host
            hosts.append(sm)
        for ev in events:
            ev.synchronize()
        # groups are length-bucketed: map through the sort permutation
        return [hosts[self.group_of[j]][self.slot_of[j], :fc]
                .flatten(0, 1).clone()
                for j, fc in enumerate(self.frame_counts)]

    def _counts_in_input_order(self) -> None:
        """frame_counts, appended in parse order (``self.order``, padding
        copies last), -> one count per input stream, in input order."""
        by_orig = [0] * len(self.streams)
        for k, i in enumerate(self.order):
            by_orig[i] = self.frame_counts[k]
        self.frame_counts = by_orig

    def audio_seconds(self) -> float:
        spf = 1024 << (not self.ds)
        return sum(fc * spf / self.sample_rate for fc in self.frame_counts)


def decode_qwire_flip_stream(data: bytes, max_frames: int | None = None,
                             device="cuda") -> torch.Tensor:
    """Decode one HE-AAC v2 stream whose PS band mode flips between 20
    and 34 bands mid-stream, through the flip scan
    (``heaac_graph.qwire_scan_decode_flip``) on ``device`` (the card
    unless the caller passes ``device="cpu"``).  The Python planner
    parses it with the flip trail on: each frame's band mode rides side
    bit 6.  An AFTER_IMDCT coupling channel is mixed into the float PCM
    before rounding.  Returns a CPU int16 tensor [n, ch] like
    ``decode_batch``'s (a mono core gives stereo)."""
    dev = resolve(device)
    info = {}
    # a list for the band-mode trail lets the planner accept the flips
    frames_q, _, nl, _, ds = parse_stream_qwire(
        data, max_frames=max_frames, is34_out=[], info_out=info)
    T = len(frames_q)
    heap, cur, recs = pack_planner_frames([frames_q], nl, T)
    S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
    sa = spec_static_args(recs)
    couple = _flatten_couple([_planner_couple(info["couple"])], nl, T)
    if couple is not None:
        couple = tuple(torch.from_numpy(a).to(dev) for a in couple)
    carry = init_qwire_flip_carry(nl, dev)
    _, pcm = qwire_scan_decode_flip(
        torch.from_numpy(heap).to(dev), torch.from_numpy(recs).to(dev),
        carry, ds, S, rate_idx=parse_adts_header(data[:7]).sampling_index,
        NB=sa["NB"], NS=sa["NS"], SEC=sa["SEC"],
        rows_pair=rows_pair_static(heap[:cur], recs), couple=couple)
    pcm = pcm.cpu()                            # [T, nl, 2, 2048]
    out_nl = info["out_nl"]
    if out_nl == 1:
        return pcm[:, 0].permute(0, 2, 1).reshape(-1, 2)
    return torch.stack([pcm[:, k, 0].reshape(-1) for k in range(out_nl)],
                       -1)


class LcStreamBatchDecoder:
    """Batched AAC-LC decode: each stream contributes its channel lanes
    (``lane_block`` per stream, the first ``channels`` of them audio, then
    its coupling channels' lanes); the whole stream is parsed up front,
    uploaded once and decoded by one IMDCT / overlap-add scan on
    ``device`` (the card unless the caller passes ``device="cpu"``).
    ``couple`` holds the AFTER_IMDCT edges over the batch's lanes
    (etgt [K], esrc [K] int64, gains [T, K] f32) on the device, or
    None."""

    def __init__(self, streams, max_frames: int | None = None,
                 device="cuda"):
        self.device = resolve(device)
        if isinstance(streams, (bytes, bytearray)):
            streams = [bytes(streams)]
        self.parser = native.Parser()
        parsed = [self._parse_one(i, st, max_frames)
                  for i, st in enumerate(streams)]
        self.B = len(parsed)
        self.sample_rate = parsed[0][1]
        self.channels = parsed[0][2]
        self.lane_block = lb = max(p[3] for p in parsed)
        self.frame_counts = [len(p[0]["coeffs"]) for p in parsed]
        self.T = T = max(self.frame_counts)
        # shorter streams and narrower layouts pad with silent lanes:
        # zero spectra, ONLY_LONG sine windows
        core = {k: np.zeros((T, self.B * lb) + v.shape[2:], v.dtype)
                for k, v in parsed[0][0].items()}
        for b, (c, _, _, lanes, _) in enumerate(parsed):
            for k, v in c.items():
                core[k][:len(v), b * lb:b * lb + lanes] = v
        self.core = {k: torch.from_numpy(v).to(self.device)
                     for k, v in core.items()}
        # each stream's edges over the batch's lanes, gains padded to T
        etgt, esrc, gcols = [], [], []
        for b, p in enumerate(parsed):
            if p[4] is None:
                continue
            struct, gains = p[4]
            for k, (tg, sr) in enumerate(struct):
                etgt.append(b * lb + tg)
                esrc.append(b * lb + sr)
                col = np.zeros(T, np.float32)
                col[:len(gains)] = gains[:, k]
                gcols.append(col)
        self.couple = None
        if etgt:
            self.couple = tuple(
                torch.from_numpy(a).to(self.device)
                for a in (np.array(etgt, np.int64), np.array(esrc, np.int64),
                          np.stack(gcols, 1)))

    def _parse_one(self, i: int, st: bytes, max_frames: int | None):
        """-> (core dict with [T, lanes, ...] leaves, rate, channels,
        lanes, couple): the native whole-stream parser (ht_parse_stream:
        ADTS framing, element loop, dequant, prediction, TNS) for channel
        configurations 1-7, the LC planner for a stream it refuses (PCE /
        CCE / SSR).  couple is None, or the stream's one edge structure
        [(tgt, src)] (the sorted union of its frames' edges) and gains
        [T, E] (0 where a frame lacks an edge)."""
        frames = split_adts_stream(st)
        if not frames:
            raise ValueError(f"stream {i}: not an ADTS stream")
        if max_frames is not None:
            frames = frames[:max_frames]
        hdr = parse_adts_header(frames[0][:7])
        if hdr.chan_config and hdr.object_type in (1, 2):
            layout = TB.CHANNEL_LAYOUT_MAP[hdr.chan_config]
            r = self.parser.parse_stream(st, hdr.sampling_index, layout,
                                         len(frames))
            if r is not None:
                coeffs, meta = r
                core = dict(coeffs=coeffs,
                            ws=meta[..., 0].astype(np.int64),
                            wsp=meta[..., 1].astype(np.int64),
                            kbd=meta[..., 2].astype(np.int64),
                            kbdp=meta[..., 3].astype(np.int64))
                lanes = coeffs.shape[1]
                return core, hdr.sample_rate, lanes, lanes, None
        dec = LcPlanningDecoder(adts_probe=frames[0][:7])
        for f in frames:
            dec.decode_frame(f)
        core = {k: np.stack([fc[k] for fc in dec.frames_core])
                for k in dec.frames_core[0]}
        core["coeffs"] = core["coeffs"].astype(np.float32)
        for k in ("ws", "wsp", "kbd", "kbdp"):
            core[k] = core[k].astype(np.int64)
        couple = None
        if any(dec.frames_couple):
            struct = sorted({(tg, sr) for fr in dec.frames_couple
                             for tg, sr, _ in fr})
            pos = {e: k for k, e in enumerate(struct)}
            gains = np.zeros((len(dec.frames_couple), len(struct)),
                             np.float32)
            for t, fr in enumerate(dec.frames_couple):
                for tg, sr, g in fr:
                    gains[t, pos[(tg, sr)]] = g
            couple = (struct, gains)
        return (core, dec.sample_rate, dec.channels,
                core["coeffs"].shape[1], couple)

    def decode(self):
        """pcm [T, B * lane_block, 1024] int16 on the device, after the
        device is done; the audio channels are the first ``channels``
        lanes of each stream's block."""
        saved = torch.zeros((self.B * self.lane_block, 512),
                            dtype=torch.float32, device=self.device)
        _, pcm = lc_scan_decode(self.core, saved, self.couple)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return pcm

    def audio_seconds(self) -> float:
        return sum(self.frame_counts) * 1024 / self.sample_rate


# ---------------------------------------------------------------------------
# Heterogeneous batch front door: bucket streams by decode profile
# ---------------------------------------------------------------------------
def _python_probe(data: bytes, device) -> tuple:
    """decode_batch's Python prober (JAX batch.py:1791-1801): the first
    frame through the single-stream ``Decoder`` on ``device`` -> (SBR
    signalled, any element's PS in 34 bands); (False, False), an AAC-LC
    bucket, when the decode raises."""
    probe = Decoder(adts_probe=data[:7], device=device)
    try:
        probe.decode_frame(split_adts_stream(data)[0])
    except Exception:  # noqa: BLE001 - as the JAX probe: any error is LC
        return False, False
    return probe.m4ac.sbr == 1, any(
        el.sbr is not None and el.sbr.ps is not None and el.sbr.ps.is34bands
        for el in probe.elements.values())


def decode_batch(streams, device="cuda") -> list:
    """Decode many streams of possibly different configurations.

    Streams are bucketed by (profile, sample rate, channel config, PS
    band mode), each bucket decoded batched on ``device`` (the card
    unless the caller passes ``device="cpu"``; without a card the
    default raises RuntimeError).  Returns CPU int16 tensors [n, ch] in
    input order: stereo for HE-AAC v2 (PS) and mono-core HE streams, one
    channel per output lane otherwise (stereo HE-AAC v1: two), never the
    lanes of coupling channel elements; a buffer with no ADTS sync word
    gives [0, 1].  A stream the native probe refuses is bucketed by the
    Python prober (``_python_probe``).  A stream that fails its batched
    decode is decoded by the single-stream ``Decoder`` on ``device``, as
    in the JAX package.  Each bucket logs, at INFO, its key, streams,
    frames, audio and wall seconds (also as the record's
    ``bucket_stats`` dict, with the scan steps, the errored frames the
    decode dropped, and ``init_s``, the seconds of the decoder's
    construction: for AAC-LC the whole parse and upload).  The call is
    a ``decode_batch`` span; each bucket a ``bucket`` span whose
    attributes are that dict (``utils.trace``)."""
    dev = resolve(device)
    with span("decode_batch", streams=len(streams)):
        streams = [bytes(s) for s in streams]
        results: list = [None] * len(streams)
        with span("probe") as sp:
            buckets = _bucket_streams(streams, results, dev, sp)
        for key, idxs in buckets.items():
            _decode_bucket_retry(key, idxs, streams, results, dev)
    return results


def _bucket_streams(streams: list, results: list, dev, sp) -> dict:
    """decode_batch's probe of every stream -> {bucket key: stream
    indices}; a buffer with no sync word gets its empty result here.
    Counts the streams probed natively and by ``_python_probe`` (on the
    ``probe`` span ``sp`` and in the counters)."""
    parser = native.Parser()
    buckets: dict = {}
    n_python = 0
    for i, data in enumerate(streams):
        if len(data) < 7 or data[0] != 0xFF or (data[1] & 0xF0) != 0xF0:
            # leading garbage: resync on the first real sync word
            frames = split_adts_stream(data)
            if not frames:
                log.warning("decode_batch: stream %d has no ADTS sync "
                            "word; returning empty", i)
                results[i] = torch.zeros((0, 1), dtype=torch.int16)
                continue
            data = streams[i] = b"".join(frames)
        hdr = parse_adts_header(data[:7])
        probe = (parser.probe(data, hdr) if hdr.object_type in (1, 2)
                 else None)
        if probe is None:
            n_python += 1
            sbr, is34 = _python_probe(data, dev)
        else:
            sbr, is34 = probe["sbr"], probe["is34"]
        key = ("he" if sbr else "lc", hdr.sampling_index, hdr.chan_config,
               int(is34))
        buckets.setdefault(key, []).append(i)
    n_native = sum(map(len, buckets.values())) - n_python
    count("probe.native", n_native)
    count("probe.python", n_python)
    sp.set(native=n_native, python=n_python)
    return buckets


def _decode_bucket_retry(key, idxs, streams, results, device,
                         depth: int = 0):
    """Decode one bucket; on failure bisect it down to the stream at
    fault.  A single stream whose batched decode failed on a PS band-mode
    flip is decoded by ``decode_qwire_flip_stream`` (logged at INFO with
    a ``flip_stats`` dict: stream, frames, audio and wall seconds).  Any
    other single stream that fails, and a flip stream whose flip decode
    fails, falls back to the single-stream ``Decoder`` on ``device``
    (logged at WARNING, then at INFO with a ``single_stats`` dict:
    stream, frames, dropped frames, audio and wall seconds); an error of
    that decoder propagates."""
    try:
        with span("bucket", key=key) as sp:
            sp.set(**_decode_bucket(key, [streams[i] for i in idxs], idxs,
                                    results, device))
        return
    except Exception as exc:  # noqa: BLE001 - bisect, then fall back
        failed = exc
    if len(idxs) > 1:
        if depth == 0:
            log.warning("decode_batch: bucket %s (%d streams) failed (%s: "
                        "%s); bisecting to isolate the offender", key,
                        len(idxs), type(failed).__name__, failed)
        count("bucket.bisections")
        mid = len(idxs) // 2
        with span("bucket.retry", key=key, streams=len(idxs)):
            _decode_bucket_retry(key, idxs[:mid], streams, results, device,
                                 depth + 1)
            _decode_bucket_retry(key, idxs[mid:], streams, results, device,
                                 depth + 1)
        return
    i = idxs[0]
    if isinstance(failed, NotImplementedError) \
            and "PS band mode" in str(failed):
        # mid-stream 20<->34 flip: the flip-capable scan first
        try:
            _decode_flip(i, streams[i], results, device)
            return
        except Exception as exc:  # noqa: BLE001 - the single-stream decoder
            log.warning("decode_batch: flip-scan decode of stream %d failed "
                        "(%s: %s); using the single-stream decoder", i,
                        type(exc).__name__, exc)
    log.warning("decode_batch: stream %d fell back to the single-stream "
                "decoder: %s: %s", i, type(failed).__name__, failed)
    _decode_single(i, streams[i], results, device)


def _decode_single(i: int, data: bytes, results, device) -> None:
    t0 = time.perf_counter()
    count("single.fallbacks")
    dec = Decoder(adts_probe=data[:7], device=device)
    with span("single", stream=i):
        results[i] = dec.decode(data)
    frames = count_adts_frames(data)
    rows = results[i].shape[0]
    stats = dict(stream=i, frames=frames, dropped=dec.error_count,
                 audio_s=rows / max(dec.sample_rate, 1),
                 wall_s=time.perf_counter() - t0)
    log.info("decode_batch: stream %d decoded by the single-stream decoder: "
             "%d frames (%d dropped), %.3f s of audio in %.6f s", i,
             frames, dec.error_count, stats["audio_s"], stats["wall_s"],
             extra={"single_stats": stats})


def _decode_flip(i: int, data: bytes, results, device) -> None:
    t0 = time.perf_counter()
    count("flip.decodes")
    with span("flip", stream=i):
        results[i] = decode_qwire_flip_stream(data, device=device)
    rows = results[i].shape[0]                 # 2048 per frame at 2x rate
    stats = dict(stream=i, frames=rows // 2048,
                 audio_s=rows / (2 * parse_adts_header(data[:7]).sample_rate),
                 wall_s=time.perf_counter() - t0)
    log.info("decode_batch: stream %d decoded via the PS band-mode-flip "
             "scan: %d frames, %.3f s of audio in %.6f s", i, stats["frames"],
             stats["audio_s"], stats["wall_s"], extra={"flip_stats": stats})


def _decode_bucket(key, group, idxs, results, device) -> dict:
    """Decode one bucket into ``results`` -> its ``bucket_stats`` dict
    (also logged)."""
    t0 = time.perf_counter()
    if key[0] == "lc":
        bd = LcStreamBatchDecoder(group, device=device)
        init_s = time.perf_counter() - t0        # the whole parse + upload
        pcm = bd.decode()                        # [T, B*lane_block, 1024]
        with span("bucket.pcm"):
            pcm = pcm.cpu()
            ch, lb = bd.channels, bd.lane_block
            for j, i in enumerate(idxs):
                lanes = pcm[:bd.frame_counts[j], j * lb:j * lb + ch]
                results[i] = lanes.permute(0, 2, 1).reshape(-1, ch)
        errored = 0          # the LC decoders drop no frame: an error
        #                      fails the bucket
    else:
        bd = QwirePipelinedDecoder(group, device=device)
        init_s = time.perf_counter() - t0        # the profile; parse later
        outs = bd.decode()                       # [T, L, 2, 2048] each
        with span("bucket.pcm"):
            for i, pcm in zip(idxs, bd.stream_pcm(outs)):
                results[i] = pcm
        errored = bd.error_count
    stats = dict(key=key, streams=len(idxs), frames=sum(bd.frame_counts),
                 steps=bd.T if key[0] == "lc" else sum(bd.group_T),
                 errored=errored, audio_s=bd.audio_seconds(), init_s=init_s,
                 wall_s=time.perf_counter() - t0)
    log.info("decode_batch: bucket %s: %d streams, %d frames (%d errored), "
             "%.3f s of audio in %.6f s", key, stats["streams"],
             stats["frames"], errored, stats["audio_s"], stats["wall_s"],
             extra={"bucket_stats": stats})
    return stats


# ---------------------------------------------------------------------------
# Plan-record decoders: host-built per-frame plans (dense frame_plan or
# compact compact_plan records) scanned through the frame graph
# ---------------------------------------------------------------------------
def _pad_plan_frames(d: dict, defaults: dict, T: int, nl: int) -> dict:
    """Pad each [T_i, nl, ...] leaf to T frames with the per-key silence
    default (a shorter stream must not truncate the batch)."""
    T_i = len(next(iter(d.values())))
    if T_i >= T:
        return {k: v[:T] for k, v in d.items()}
    out = {}
    for k, v in d.items():
        dv = np.asarray(defaults[k])
        pad = np.broadcast_to(dv, (T - T_i, nl) + dv.shape)
        out[k] = np.concatenate([np.asarray(v), pad], axis=0)
    return out


def _he_plan_defaults(compact: bool = False) -> tuple:
    """(core, sbr, ps) plan leaves of one silent frame-lane."""
    core = dict(coeffs=np.zeros(1024, np.float32), ws=np.int32(0),
                wsp=np.int32(0), kbd=np.int32(0), kbdp=np.int32(0))
    if compact:
        return core, compact_plan.zeros_compact(), \
            compact_plan.zeros_ps_compact()
    zp = frame_plan._zeros_plan()
    sbr = {k: np.asarray(getattr(zp, k)) for k in frame_plan.PLAN_FIELDS}
    return core, sbr, frame_plan.build_ps_plan(None, 64)


def _to_device(d: dict, device) -> dict:
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in d.items()}


class StreamBatchDecoder:
    """Whole-stream batched decode with the plans resident on ``device``
    (the card unless the caller passes ``device="cpu"``).

    Takes B streams (one plan sequence per lane, [T, B * lanes_per_stream,
    ...]; with ``batch`` the streams repeat to fill B slots), parses them
    (``planner.parse_stream_plans``: compact records with ``compact``,
    the default, else the dense plans), uploads once and decodes all T
    frames of all lanes in one scan (``heaac_graph.scan_decode``).
    Shorter streams are padded to the longest with silence plans; their
    own lengths are in ``frame_counts`` (one entry per batch slot).
    Streams of different PS band or synthesis modes raise
    NotImplementedError; of different lanes per stream, ValueError."""

    def __init__(self, streams, batch: int | None = None,
                 asc: bytes | None = None, max_frames: int | None = None,
                 compact: bool = True, device="cuda"):
        self.device = resolve(device)
        if isinstance(streams, (bytes, bytearray)):
            streams = [bytes(streams)]
        self.compact = compact
        per = [parse_stream_plans(s, asc=asc, max_frames=max_frames,
                                  compact=compact) for s in streams]
        rate = per[0][3]
        self.lanes_per_stream = nl = per[0][4]
        self.is34 = per[0][5]
        self.ds = per[0][6]
        if any(p[5] != self.is34 or p[6] != self.ds for p in per):
            raise NotImplementedError(
                "mixed PS band / synthesis modes in one batch")
        if any(p[4] != nl for p in per):
            raise ValueError("streams of different lanes in one batch: "
                             f"{sorted({p[4] for p in per})}")
        T = max(len(p[0]["coeffs"]) for p in per)
        n = len(per)
        B = batch or n
        self.B, self.T, self.sample_rate = B, T, rate
        self.frame_counts = [len(per[i % n][0]["coeffs"]) for i in range(B)]
        dflt = _he_plan_defaults(compact)
        padded = [tuple(_pad_plan_frames(p[idx], dflt[idx], T, nl)
                        for idx in range(3)) for p in per]
        self._place(tuple(
            {k: np.concatenate([padded[i % n][idx][k] for i in range(B)],
                               axis=1)
             for k in padded[0][idx]} for idx in range(3)))

    def _place(self, host: tuple) -> None:
        """Upload the stacked (core, sbr, ps) numpy plans."""
        self.core, self.sbr, self.ps = (_to_device(d, self.device)
                                        for d in host)

    def plan_bytes(self) -> int:
        """Bytes of the plans resident on the device."""
        return sum(v.numel() * v.element_size()
                   for d in (self.core, self.sbr, self.ps)
                   for v in d.values())

    def _init_state(self, lanes: int, device):
        return (init_compact_state(lanes, device) if self.compact
                else init_state(lanes, device))

    def decode(self):
        """pcm [T, B * lanes_per_stream, 2, 2048] int16 on the device
        ([..., 1024] in downsampled mode), after the device is done."""
        _, pcm = scan_decode(self.core, self.sbr, self.ps,
                             self._init_state(self.B * self.lanes_per_stream,
                                              self.device),
                             self.is34, self.ds, self.compact)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return pcm

    def audio_seconds(self) -> float:
        return self.B * self.T * (1024 << (not self.ds)) / self.sample_rate


class BatchDecoder:
    """Decode B copies of one stream on ``device`` (the card unless the
    caller passes ``device="cpu"``): the stream's dense plans are parsed
    and uploaded once, and each frame's plan is tiled across the B
    copies (lanes b * nl onwards) as the frame graph runs.

    Difference from the JAX package: the JAX class tiles the [nl, ...]
    plan of a frame to [B, nl, ...] and hands that to the frame graph,
    which fails on it (``TypeError`` on the first frame: the plan leaves
    gained their lane axis after the class was written); the port tiles
    to [B * nl, ...], the lane layout of ``StreamBatchDecoder([stream],
    batch=B, compact=False)``, which it equals."""

    def __init__(self, stream: bytes, batch: int = 512, device="cuda"):
        self.device = resolve(device)
        self.B = batch
        core, sbr, ps, rate, nl, is34, ds = parse_stream_plans(stream)
        self.sample_rate, self.nl, self.is34, self.ds = rate, nl, is34, ds
        self.T = len(core["coeffs"])
        self.core, self.sbr, self.ps = (_to_device(d, self.device)
                                        for d in (core, sbr, ps))
        self.state = None

    def _tile(self, d: dict, t: int) -> dict:
        return {k: v[t].expand(self.B, *v[t].shape).reshape(
                    self.B * self.nl, *v.shape[2:])
                for k, v in d.items()}

    def frame_inputs(self, t: int) -> tuple:
        return (self._tile(self.core, t), self._tile(self.sbr, t),
                self._tile(self.ps, t))

    def _step(self, t: int, state):
        return heaac_frame(*self.frame_inputs(t), state, self.is34, self.ds)

    def _sync(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def warmup(self) -> None:
        """One frame on a fresh state (the first use builds the frame
        graph's constants); the timed run starts fresh again."""
        self._step(0, init_state(self.B * self.nl, self.device))
        self._sync()
        self.state = init_state(self.B * self.nl, self.device)

    def run(self) -> float:
        """Decode all frames once, after the device is done; returns the
        decoded audio seconds."""
        state = self.state if self.state is not None else init_state(
            self.B * self.nl, self.device)
        for t in range(self.T):
            _, state = self._step(t, state)
        self._sync()
        self.state = None
        return self.B * self.T * (1024 << (not self.ds)) / self.sample_rate

    def decode_all(self):
        """int16 PCM [B * nl, T * N, 2] on the CPU (for validation)."""
        state = init_state(self.B * self.nl, self.device)
        outs = []
        for t in range(self.T):
            pcm, state = self._step(t, state)
            outs.append(to_int16(pcm))
        return torch.cat(outs, 2).transpose(1, 2).cpu()


class QStreamBatchDecoder:
    """Whole-stream batched decode over the quantized wire format, every
    stream parsed by the Python planner (``parse_stream_qwire``): the
    streams' frame-lane payloads go into one byte heap, the records
    index it (``pack_planner_frames``), and ``decode()`` runs the qwire
    scan on ``device`` (the card unless the caller passes
    ``device="cpu"``).  Shorter streams are padded to the longest with
    silence lanes; with ``batch`` the streams repeat to fill B slots."""

    def __init__(self, streams, batch: int | None = None,
                 max_frames: int | None = None, device="cuda"):
        self.device = resolve(device)
        infos = [dict() for _ in streams]
        parsed = [parse_stream_qwire(s, max_frames=max_frames,
                                     info_out=infos[i])
                  for i, s in enumerate(streams)]
        rate, nl, is34, ds = parsed[0][1:5]
        self.sample_rate, self.nl = rate, nl
        self.out_nl = infos[0]["out_nl"]
        self.is34, self.ds = is34, ds
        self.T = max(len(p[0]) for p in parsed)
        B = batch or len(parsed)
        self.L = B * nl
        heap, cur, recs = pack_planner_frames(
            [parsed[b % len(parsed)][0] for b in range(B)], nl, self.T)
        S = max(64, int((recs[:, :, R_W1] & 0xFFFF).max()))
        sa = spec_static_args(recs)
        self.static = dict(
            S=-(-S // 64) * 64,
            rate_idx=parse_adts_header(bytes(streams[0][:7])).sampling_index,
            NB=sa["NB"], MS=sa["MS"], NS=sa["NS"], SEC=sa["SEC"],
            rows_pair=rows_pair_static(heap[:cur], recs))
        self.heap = torch.from_numpy(heap).to(self.device)
        self.recs = torch.from_numpy(recs).to(self.device)
        self._frames_total = sum(len(parsed[b % len(parsed)][0])
                                 for b in range(B))
        couple = _flatten_couple(
            [_planner_couple(infos[b % len(parsed)]["couple"])
             for b in range(B)], nl, self.T)
        self.couple = None if couple is None else tuple(
            torch.from_numpy(a).to(self.device) for a in couple)

    def decode(self):
        """pcm [T, B * nl, 2, 2048] int16 on the device, after the device
        is done."""
        carry = init_qwire_carry(self.L, self.device)
        _, pcm = qwire_scan_decode(self.heap, self.recs, carry, self.is34,
                                   self.ds, couple=self.couple,
                                   **self.static)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return pcm

    def audio_seconds(self) -> float:
        # real (non-padding) frames only
        return self._frames_total * self.nl \
            * (1024 << (not self.ds)) / self.sample_rate
