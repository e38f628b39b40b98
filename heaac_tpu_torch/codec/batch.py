"""Pipelined batched decode of many independent HE-AAC v2 streams.

Counterpart: ``heaac_tpu/codec/batch.py`` QwirePipelinedDecoder.  The
native parser (``native.py``) writes each group of streams into a byte
heap + per-frame-lane records (the qwire format) in host staging buffers
(pinned when the device is CUDA, two sets); each group is uploaded with
non-blocking copies and decoded by the whole-stream scan
(``heaac_graph.qwire_scan_decode``).  The parse of group g+1 runs on a
worker thread (the native call releases the GIL) while the main thread
issues group g's decode.

Differences from the JAX decoder:
  - the stream profile (lanes, SBR, PS band mode) comes from a native
    probe of the first stream, not the Python planner;
  - a stream the native parser cannot take raises NotImplementedError
    (the Python-planner fallback is not ported), as do PS band-mode 34,
    device M/S, coupled-CPE SBR rows and AFTER_IMDCT coupling;
  - the heap travels as a uint8 tensor (the f32 view existed only for
    the TPU transport).
"""
from __future__ import annotations

import ctypes as C
import logging
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import native
from ..device import resolve
from ..host import (R_W1, REC_W, count_adts_frames, parse_adts_header,
                    rows_pair_static, silence_lane, spec_static_args)
from .heaac_graph import init_qwire_carry, qwire_scan_decode

log = logging.getLogger("heaac_tpu_torch")


class QwirePipelinedDecoder:
    """End-to-end pipelined batched decode over the quantized wire
    format; ``decode()`` returns one pcm tensor [T, L, 2, 2048] int16 per
    stream group, on ``device``: the card unless the caller passes
    ``device="cpu"`` (without a card the default raises RuntimeError)."""

    def __init__(self, streams, group_streams: int = 256,
                 max_frames: int | None = None, token_cap: int = 640,
                 device="cuda"):
        self.device = resolve(device)
        self.streams = [bytes(s) for s in streams]
        self.hdr = parse_adts_header(self.streams[0][:7])
        self.G = min(group_streams, len(self.streams))
        self.parser = native.Parser()
        lanes, sbr_on, is34, edges = self._probe(self.streams[0])
        if is34:
            raise NotImplementedError(
                "stream 0: 34-band parametric stereo is not ported")
        if edges:
            raise NotImplementedError(
                "stream 0: AFTER_IMDCT channel coupling is not ported")
        self.nl = lanes
        counts = [count_adts_frames(s) for s in self.streams]
        if max_frames is not None:
            counts = [min(c, max_frames) for c in counts]
        self.T = max_frames if max_frames is not None else max(counts)
        n = len(self.streams)
        # length bucketing: groups in ascending frame-count order, each
        # scanned over its own longest stream (rounded up to 32)
        self.order = sorted(range(n), key=lambda i: counts[i])
        self.group_T = []
        for g0 in range(0, n, self.G):
            tg = max(counts[i] for i in self.order[g0:g0 + self.G])
            self.group_T.append(min(self.T, -(-max(tg, 1) // 32) * 32))
        self.sample_rate = self.hdr.sample_rate << (1 if sbr_on else 0)
        self.is34, self.ds = 0, 0
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
        self._uploaded = [None, None]   # CUDA event per staging set

    def _probe(self, data: bytes):
        """Native parse of the first two frames -> (lanes, sbr, is34,
        coupling edges)."""
        h = self.hdr
        heap = np.zeros(1 << 16, np.uint8)
        recs = np.zeros((2, 8, REC_W), np.int32)
        info = np.zeros(8, np.int32)
        cur = C.c_int64(0)
        r = self.parser.parse_qwire(
            data, min(len(data), 1 << 14), h.sampling_index, h.sample_rate,
            h.chan_config, heap.ctypes.data_as(C.POINTER(C.c_uint8)),
            heap.nbytes, C.byref(cur),
            recs.ctypes.data_as(C.POINTER(C.c_int32)), 2, 8, 0,
            info.ctypes.data_as(C.POINTER(C.c_int32)), None, None, 0)
        if r < 0:
            raise NotImplementedError(
                "stream 0 needs the Python planner, which is not ported")
        return int(info[0]), int(info[1]), int(info[2]), int(info[4])

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
            ev = self._uploaded[b]
            if ev is not None:
                ev.synchronize()
                self._uploaded[b] = None

    def _grow(self) -> None:
        """Double the heap staging; all uploads must have finished."""
        self._wait_uploads()
        self._cap *= 2
        self._bufsets = [None, None]
        log.info("qwire pipelined decode: heap grown to %d KB",
                 self._cap >> 10)

    def _parse_group(self, group: list, bufset: int, T: int,
                     n_real: int | None = None):
        """Parse one group into staging set ``bufset`` -> (heap, cur, recs)
        numpy views, or None when the heap overflowed (grow + retry)."""
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
        for gi, data in enumerate(group):
            lane0 = gi * self.nl
            nf = fn(data, len(data), h.sampling_index, h.sample_rate,
                    h.chan_config, heap_p, heap.nbytes, C.byref(cur_c),
                    recs_p, T, recs.shape[1], lane0, info_p, cedges_p,
                    cgains_p, native.EDGE_MAX)
            if nf == -3:
                del self.frame_counts[n_counts0:]
                self.error_count = err0
                return None
            if nf < 0 or int(info[0]) != self.nl:
                raise NotImplementedError(
                    f"stream {gi} of the group needs the Python planner, "
                    "which is not ported")
            if int(info[4]):
                raise NotImplementedError(
                    f"stream {gi} of the group uses AFTER_IMDCT coupling, "
                    "which is not ported")
            cur = int(cur_c.value)
            if n_real is None or gi < n_real:
                self.error_count += int(info[3])
            self.frame_counts.append(nf)
            if nf < T:
                recs[nf:T, lane0:lane0 + self.nl] = \
                    self._sil_recs[nf:T, lane0:lane0 + self.nl]
        maxtok = int((recs[:T, :, R_W1] & 0xFFFF).max())
        if maxtok > self.S:
            self.S = -(-maxtok // 64) * 64
        sa = spec_static_args(recs[:T])
        self.NB = max(self.NB, sa["NB"])
        self.MS = max(self.MS, sa["MS"])
        self.NS = max(self.NS, sa["NS"])
        self.SEC = max(self.SEC, sa["SEC"])
        self.RP = max(self.RP, rows_pair_static(heap[:cur], recs[:T]))
        return heap, cur, recs

    def _static_args(self) -> dict:
        return dict(S=self.S, rate_idx=self.rate_idx, NB=self.NB, MS=self.MS,
                    NS=self.NS, SEC=self.SEC, rows_pair=self.RP)

    def _parse_with_retry(self, gidx: int):
        """Parse group ``gidx`` into staging set gidx % 2 -> (cur, Tg,
        static decode sizes as of this group)."""
        idxs = self.order[gidx * self.G:(gidx + 1) * self.G]
        group = [self.streams[i] for i in idxs]
        n_real = len(group)
        if len(group) < self.G:
            group = group + [group[0]] * (self.G - len(group))
        Tg = self.group_T[gidx]
        for _ in range(6):
            r = self._parse_group(group, gidx % 2, Tg, n_real)
            if r is not None:
                return r[1], Tg, self._static_args()
            self._grow()
        raise MemoryError("qwire heap kept overflowing")

    def _upload(self, bufset: int, cur: int, Tg: int):
        """Staging set -> device tensors (non-blocking from pinned memory
        on CUDA, with an event the next parse of this set waits on)."""
        heap_t, recs_t, _, _ = self._bufsets[bufset]
        n_up = min(cur + (1 << 18), self._cap)
        cuda = self.device.type == "cuda"
        heap_d = heap_t[:n_up].to(self.device, non_blocking=cuda)
        recs_d = recs_t[:Tg].to(self.device, non_blocking=cuda)
        if cuda:
            ev = torch.cuda.Event()
            ev.record(torch.cuda.current_stream(self.device))
            self._uploaded[bufset] = ev
        return heap_d, recs_d

    def _scan(self, heap_d, recs_d, sa: dict):
        if sa["MS"] or sa["rows_pair"]:
            raise NotImplementedError(
                "device M/S and coupled-CPE SBR rows are not ported")
        carry = init_qwire_carry(self.L, self.device)
        _, pcm = qwire_scan_decode(heap_d, recs_d, carry, self.is34, self.ds,
                                   **sa)
        return pcm

    def decode(self):
        """Parse + upload + decode all streams, pipelined by group: the
        parse of group g+1 runs on a worker thread while this thread
        issues group g's decode.  Returns pcm tensors [T, L, 2, 2048]
        int16 (one per group) on the device, after the device is done."""
        n = len(self.streams)
        ngroups = -(-n // self.G)
        self.frame_counts = []
        self.error_count = 0
        outs = []
        with ThreadPoolExecutor(max_workers=1) as pool:
            fut = pool.submit(self._parse_with_retry, 0)
            for gidx in range(ngroups):
                cur, Tg, sa = fut.result()
                heap_d, recs_d = self._upload(gidx % 2, cur, Tg)
                if gidx + 1 < ngroups:
                    fut = pool.submit(self._parse_with_retry, gidx + 1)
                outs.append(self._scan(heap_d, recs_d, sa))
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        by_orig = [0] * n
        for k, i in enumerate(self.order):
            by_orig[i] = self.frame_counts[k]
        self.frame_counts = by_orig
        return outs

    def audio_seconds(self) -> float:
        spf = 1024 << (not self.ds)
        return sum(fc * spf / self.sample_rate for fc in self.frame_counts)
