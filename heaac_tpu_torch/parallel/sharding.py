"""The decode spread over several cards of one process.

Counterpart of ``heaac_tpu/parallel/sharding.py`` (make_mesh,
sharded_core_step, ShardedStreamBatchDecoder, ShardedQwireDecoder).
Streams are independent, so the parallel axis is the lane axis: each
card decodes a contiguous slice of the lanes with the unchanged scan
(the plan scan for ``ShardedStreamBatchDecoder``, the qwire scan for
``ShardedQwireDecoder``), and no card ever needs another card's data.
``ShardedQwireDecoder`` is a ``QwirePipelinedDecoder`` that keeps its
base class's group loop, parse and spans (``group.parse``,
``group.parse_wait``, ``group.upload``, ``group.scan``) and overrides
only the per-group upload, scan and collection.

Differences from the JAX package:
  - the cut follows stream boundaries (``shard_bounds``): card k takes
    whole streams, never the even ``L / n`` lanes of the JAX mesh, so a
    CPE's two lanes (the device M/S butterfly) and a stream's coupling
    channel lanes (the AFTER_IMDCT mix) stay on one card.  The JAX
    decoder lets XLA insert the collectives that join a stream cut in
    two; PyTorch inserts none, and this cut needs none.  The lane count
    must still divide by the number of devices, as in JAX;
  - ``ShardedQwireDecoder`` counts frames and errors as its base class
    does: each group's real streams only, reset by every ``decode()``
    call; the JAX class counts the corrupt frames of a short last
    group's padding copies again and adds every ``decode()`` call to
    the last;
  - a device is a ``torch.device`` in a list, not a mesh.  One card may
    stand in the list more than once: it then runs that many shards;
  - ``ShardedStreamBatchDecoder`` cuts the lanes evenly, as the JAX
    mesh does (a plan lane never reads another lane, so any cut is
    exact), and its ``decode()`` returns the lanes of every card joined
    on the CPU, where the JAX one returns a sharded device array.

One host thread issues the cards one after the other, and the frame
loop is bound by that issue, so several cards fed by one process decode
no faster than one (two H100s of one process ran 512 streams at 0.49x
of one card's ``QwirePipelinedDecoder``, before the step graph); one
process per card (``multihost``) is the way to use them.
"""
from __future__ import annotations

import torch

from ..codec.batch import QwirePipelinedDecoder, StreamBatchDecoder, \
    _to_device
from ..codec.core import consts, core_frame
from ..codec.heaac_graph import scan_decode
from ..device import resolve


def make_devices(n: int | None = None) -> list:
    """The first ``n`` visible cards (all of them when None) as
    ``torch.device``s; raises RuntimeError without a card or with fewer
    than ``n``."""
    if not torch.cuda.is_available():
        raise RuntimeError("make_devices: torch.cuda.is_available() is "
                           "False")
    count = torch.cuda.device_count()
    n = count if n is None else n
    if not 1 <= n <= count:
        raise RuntimeError(f"make_devices: {n} cards requested, {count} "
                           "visible")
    return [torch.device("cuda", k) for k in range(n)]


def shard_bounds(G: int, nl: int, n: int) -> list:
    """[(lo, hi)] lane range of each of ``n`` cards for a group of ``G``
    streams of ``nl`` lanes each (stream b at lanes b * nl onwards): card
    k takes streams k * G // n up to (k + 1) * G // n, so no stream is
    cut; a card gets no lanes when G < n."""
    return [(k * G // n * nl, (k + 1) * G // n * nl) for k in range(n)]


def sharded_core_step(devices):
    """``codec.core.core_frame`` with the batch axis cut into contiguous
    per-device slices: the returned function takes core_frame's inputs
    (coeffs [B, 1024], saved [B, 512], win_seq, win_seq_prev, use_kbd,
    use_kbd_prev [B]) and returns (time [B, 1024], new_saved [B, 512])
    on ``devices[0]``."""
    devices = [resolve(d) for d in devices]

    def step(coeffs, saved, win_seq, win_seq_prev, use_kbd, use_kbd_prev):
        B, n = coeffs.shape[0], len(devices)
        outs = []
        for k, dev in enumerate(devices):
            lo, hi = k * B // n, (k + 1) * B // n
            if lo < hi:
                args = [x[lo:hi].to(dev) for x in (
                    coeffs, saved, win_seq, win_seq_prev, use_kbd,
                    use_kbd_prev)]
                outs.append(core_frame(*args, *consts(dev)))
        return tuple(torch.cat([o[i].to(devices[0]) for o in outs])
                     for i in range(2))

    return step


class ShardedStreamBatchDecoder(StreamBatchDecoder):
    """``StreamBatchDecoder`` with the lanes cut into ``len(devices)``
    contiguous shards of equal width, one per entry of ``devices``
    (``make_devices()`` when None: every visible card, so without a card
    the constructor raises); each shard's plans are uploaded to its
    device and scanned there (K1 once a frame on each shard), with no
    collective.  Same contract as ``StreamBatchDecoder``, except that
    ``decode()`` returns the CPU int16 tensor [T, L, 2, N] of all lanes,
    after every device is done.  Raises ValueError when the lanes do not
    divide by the number of devices, as the JAX class does."""

    def __init__(self, streams, batch: int | None = None, devices=None,
                 asc: bytes | None = None, max_frames: int | None = None,
                 compact: bool = True):
        self.devices = [resolve(d) for d in (
            make_devices() if devices is None else devices)]
        super().__init__(streams, batch=batch, asc=asc,
                         max_frames=max_frames, compact=compact,
                         device=self.devices[0])

    def _place(self, host: tuple) -> None:
        lanes = self.B * self.lanes_per_stream
        n = len(self.devices)
        if lanes % n:
            raise ValueError(f"{lanes} lanes not divisible by {n} devices")
        w = lanes // n
        self.shards = [tuple(
            _to_device({k: v[:, k0:k0 + w] for k, v in d.items()}, dev)
            for d in host) for k0, dev in zip(range(0, lanes, w),
                                              self.devices)]
        self.core, self.sbr, self.ps = self.shards[0]

    def plan_bytes(self) -> int:
        return sum(v.numel() * v.element_size() for shard in self.shards
                   for d in shard for v in d.values())

    def decode(self):
        pcms = []
        for dev, (core, sbr, ps) in zip(self.devices, self.shards):
            lanes = core["coeffs"].shape[1]
            _, pcm = scan_decode(core, sbr, ps, self._init_state(lanes, dev),
                                 self.is34, self.ds, self.compact)
            pcms.append(pcm)
        return torch.cat([p.cpu() for p in pcms], 1)


def _card_couple(couple, lo: int, hi: int, dev):
    """The group's AFTER_IMDCT edges (``batch._flatten_couple``) whose
    target lane lies in [lo, hi), rebased to the card's lanes, as tensors
    on ``dev``; None where none does."""
    if couple is None:
        return None
    etgt, etch, esrc, gains = couple
    keep = (etgt >= lo) & (etgt < hi)
    if not keep.any():
        return None
    return tuple(torch.from_numpy(a).to(dev) for a in (
        etgt[keep] - lo, etch[keep], esrc[keep] - lo,
        gains[:, keep].copy()))


class ShardedQwireDecoder(QwirePipelinedDecoder):
    """``QwirePipelinedDecoder`` with each stream group's lanes spread
    over ``devices`` (``make_devices()`` when None: every visible card,
    so without a card the constructor raises).  The group loop, its
    spans, the profile, the grouping and the host parse are the base
    class's, on ``devices[0]``; this class replaces only its per-group
    steps: each group's byte heap goes whole to every distinct card and
    its records are cut by ``shard_bounds``, every card runs the qwire
    scan on its lanes (K1 once a frame on each card that has lanes), and
    the cards' PCM is joined on the CPU.  ``decode()`` returns one CPU
    int16 tensor [Tg, L, 2, 2048] per group, lanes in the unsharded
    order (the padding lanes of a short last group included), after
    every card is done.  Raises ValueError when the lanes of a group do
    not divide by the number of devices, as the JAX class does."""

    def __init__(self, streams, devices=None, group_streams: int = 256,
                 max_frames: int | None = None):
        self.devices = [resolve(d) for d in (
            make_devices() if devices is None else devices)]
        super().__init__(streams, group_streams, max_frames,
                         device=self.devices[0])
        n = len(self.devices)
        if self.L % n:
            raise ValueError(
                f"{self.L} lanes per group not divisible by {n} devices")
        self.bounds = shard_bounds(self.G, self.nl, n)

    def _upload(self, bufset: int, cur: int, Tg: int, couple=None):
        """Staging set ``bufset`` -> per card (in ``devices``' order) its
        heap, records and coupling edges on the card, as three lists
        holding None for a card without lanes; the heap goes once to
        each distinct card.  Every CUDA copy is followed by an event, all
        of which the next parse of this set waits on."""
        heap_t, recs_t, _, _ = self._bufsets[bufset]
        n_up = min(cur + (1 << 18), self._cap)
        on_card, events = {}, []
        heaps, recs, couples = [], [], []
        for dev, (lo, hi) in zip(self.devices, self.bounds):
            if lo == hi:
                heaps.append(None)
                recs.append(None)
                couples.append(None)
                continue
            cuda = dev.type == "cuda"
            if dev not in on_card:
                on_card[dev] = heap_t[:n_up].to(dev, non_blocking=cuda)
            recs_d = recs_t[:Tg, lo:hi].to(dev, non_blocking=cuda)
            if cuda:
                ev = torch.cuda.Event()
                ev.record(torch.cuda.current_stream(dev))
                events.append(ev)
            heaps.append(on_card[dev])
            recs.append(recs_d.contiguous())
            couples.append(_card_couple(couple, lo, hi, dev))
        self._uploaded[bufset] = events
        return heaps, recs, couples

    def _scan(self, heaps, recs, sa: dict, couples=None) -> list:
        """The qwire scan of each card with lanes, issued card after card
        -> their pcm tensors, on their cards."""
        scan = super()._scan
        return [scan(h, r, sa, c)
                for h, r, c in zip(heaps, recs, couples) if h is not None]

    def _collect(self, outs: list) -> list:
        """Per group the cards' pcm tensors -> one CPU tensor a group, the
        cards' lanes joined in order, after every card is done."""
        for dev in dict.fromkeys(self.devices):
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
        return [torch.cat([p.cpu() for p in pcms], 1) for pcms in outs]
