"""CUDA-graph capture and replay of a whole-stream scan's frame step.

``qwire_scan_decode`` steps one frame graph over T frames, and one step
is thousands of small kernels (~7,300 at 256 lanes) that Python issues
one by one.  On a CUDA device ``run_steps`` captures the step in a CUDA
graph the first time it meets a shape and replays it for every later
step, in this scan and in every later scan of the same shape: the host
then issues a step as three copies and one graph launch.  The step is
the same function either way, so the card runs the same kernels on the
same values.

The graph reads fixed buffers: the step's coefficients and record row,
the heap (a buffer of power-of-two capacity; the step clamps its reads
to the heap's real last index, a device scalar) and the carry; at its
end it copies the new carry back into the carry buffers.  Per step the
host copies the inputs in, replays, and copies the graph's output into
the scan's PCM.  The carry a scan returns is a copy of the buffers, so
no later replay overwrites it.

The graphs live in a per-process cache: the decoders are made anew for
every bucket of every ``decode_batch`` call, and all of them replay the
graph the first one captured.  The key is everything the step depends
on that Python sees: the device, the input and carry shapes, the heap's
capacity and the step's static arguments.  A card keeps at most
``GRAPHS_PER_DEVICE`` graphs, the least recently used dropped, so the
graphs' memory pools stay bounded when lane counts vary.

A CPU device, and a scan of one step, run every step eagerly.  Counters:
``scan.graph.captures``, ``scan.graph.replays``,
``scan.graph.eager_steps``.  The hand-written kernels' ``launches``
(K1's and the row decoders') keep counting kernel launches: a capture
takes back the Python calls it made and records how many launches its
graph holds, and each replay adds them.
"""
from __future__ import annotations

import collections
import threading

import torch

from ..ops import ps_decorrelate, qwire_rows
from ..utils.trace import count, span

GRAPHS_PER_DEVICE = 4
# the kernels' launch counts, {key: launches} each, that a graph replays
LAUNCHES = (ps_decorrelate.launches, qwire_rows.launches)

_graphs: collections.OrderedDict = collections.OrderedDict()  # oldest first
_lock = threading.Lock()


def _map(fn, tree):
    """``fn`` on every tensor of a carry (tuples, NamedTuples, dicts)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    vals = [_map(fn, v) for v in tree]
    return type(tree)(*vals) if hasattr(tree, "_fields") else type(tree)(vals)


def _zip(a, b):
    """(leaf of a, leaf of b) pairs of two carries of one structure, in
    a's order (dicts matched by key)."""
    if isinstance(a, torch.Tensor):
        yield a, b
    elif isinstance(a, dict):
        if a.keys() != b.keys():
            raise ValueError(f"carry keys {sorted(b)}, expected {sorted(a)}")
        for k in a:
            yield from _zip(a[k], b[k])
    else:
        for x, y in zip(a, b, strict=True):
            yield from _zip(x, y)


class _StepGraph:
    """One captured step with its input, carry and output buffers."""

    def __init__(self, step, coeffs, rec, heap, cap: int, carry):
        dev = heap.device
        own = lambda x: x.clone(memory_format=torch.contiguous_format)  # noqa
        self.coeffs, self.rec, self.carry = own(coeffs), own(rec), _map(own,
                                                                       carry)
        self.heap = heap.new_zeros(cap)
        self.heap_hi = torch.zeros((), dtype=torch.long, device=dev)
        self.lock = threading.Lock()     # one scan at a time on the buffers
        self.graph = torch.cuda.CUDAGraph()
        before = [dict(c) for c in LAUNCHES]
        # thread_local: the parse worker waits on upload events meanwhile;
        # a stream of this card (the default capture stream is the first
        # capture's card's)
        with torch.cuda.graph(self.graph, stream=torch.cuda.Stream(dev),
                              capture_error_mode="thread_local"):
            self.out = self._step(step)
        self.launches = [{k: n - b[k] for k, n in c.items()}
                         for c, b in zip(LAUNCHES, before)]
        self._add_launches(-1)
        count("scan.graph.captures")

    def _add_launches(self, sign: int) -> None:
        for c, held in zip(LAUNCHES, self.launches):
            for k, n in held.items():
                c[k] += sign * n

    def _step(self, step):
        """The captured work: one step on the buffers, its new carry
        copied back into the carry buffers -> its output."""
        out, new = step(self.coeffs, self.rec, self.heap, self.carry,
                        self.heap_hi)
        pairs = [(b, n) for b, n in _zip(self.carry, new) if n is not b]
        # a new leaf that views a carry buffer is read before any buffer
        # is written
        bufs = {b.untyped_storage().data_ptr() for b, _ in pairs}
        pairs = [(b, n.clone() if n.untyped_storage().data_ptr() in bufs
                  else n) for b, n in pairs]
        for b, n in pairs:
            b.copy_(n)
        return out

    def load(self, heap, carry) -> None:
        n = heap.shape[0]
        self.heap[:n].copy_(heap)
        self.heap_hi.fill_(n - 1)
        for b, c in _zip(self.carry, carry):
            b.copy_(c)

    def replay(self, coeffs, rec):
        """One step from these inputs -> the graph's output buffer."""
        self.coeffs.copy_(coeffs)
        self.rec.copy_(rec)
        self.graph.replay()
        self._add_launches(1)
        count("scan.graph.replays")
        return self.out


def _lookup(key):
    with _lock:
        g = _graphs.get(key)
        if g is not None:
            _graphs.move_to_end(key)
        return g


def _insert(key, g) -> None:
    with _lock:
        _graphs[key] = g
        mine = [k for k in _graphs if k[0] == key[0]]
        for k in mine[:-GRAPHS_PER_DEVICE]:
            del _graphs[k]


def _eager_steps(step, coeffs, rec_seq, heap, carry, pcm, stop: int):
    """Steps 0 .. stop - 1 called eagerly -> the carry after them."""
    for t in range(stop):
        with span("scan.step"):
            out, carry = step(coeffs[t], rec_seq[t], heap, carry)
            pcm[t] = out
        count("scan.graph.eager_steps")
    return carry


def run_steps(step, coeffs, rec_seq, heap, carry, pcm, static: tuple):
    """Step over the T frames of ``coeffs`` [T, L, ...] and ``rec_seq``
    [T, L, W] with the heap, writing step t's output into pcm[t] -> the
    carry after the last step.  ``step(coeffs, rec, heap, carry,
    heap_hi=None)`` -> (out, new carry), with ``heap_hi`` as
    ``qwire.expand_frame`` takes it; ``static``: every argument ``step``
    closes over (part of the graph's key)."""
    T = rec_seq.shape[0]
    dev = heap.device
    if dev.type != "cuda" or T < 2:
        return _eager_steps(step, coeffs, rec_seq, heap, carry, pcm, T)
    cap = 1 << max(heap.shape[0] - 1, 1).bit_length()
    key = (dev, tuple(coeffs.shape[1:]), tuple(rec_seq.shape[1:]), cap,
           tuple((tuple(x.shape), x.dtype) for x, _ in _zip(carry, carry)),
           static)
    t0 = 0
    with torch.cuda.device(dev):
        g = _lookup(key)
        if g is None:
            # step 0 eagerly: it also makes every per-device table
            carry = _eager_steps(step, coeffs, rec_seq, heap, carry, pcm, 1)
            with span("scan.capture"):
                g = _StepGraph(step, coeffs[0], rec_seq[0], heap, cap, carry)
            _insert(key, g)
            t0 = 1
        with g.lock:
            g.load(heap, carry)
            for t in range(t0, T):
                with span("scan.step", graph=1):
                    pcm[t] = g.replay(coeffs[t], rec_seq[t])
            return _map(torch.clone, g.carry)
