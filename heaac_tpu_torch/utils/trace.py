"""Profiling and tracing: the port's counterpart of
``heaac_tpu/utils/trace.py``.

The reference's affordances are START_TIMER rdtsc macros, ``-benchmark``
wall-time, and TRACE-gated bit logging (libavutil/timer.h,
get_bits.h:620-663).  Here:

* ``span(name, **attrs)`` — a named stretch of the program at a layer
  boundary (``decode_batch`` -> ``bucket`` -> ``group.*`` -> ``scan.step``
  -> ``expand_frame`` (-> ``qwire_rows``) / ``expand_ps`` /
  ``frame_graph`` -> ``k1``;
  ``decode_frame`` -> ``frame.parse`` / ``prep`` / ``issue`` /
  ``download``).  Spans are kept only inside ``recording()``, the one
  switch; outside it ``span`` returns the shared ``NO_SPAN`` after one
  module-level check, so it allocates no record, never synchronizes the
  card and launches nothing.
* ``count(name, n)`` — counters at the same boundaries, always kept
  (``counters``); ``snapshot()`` adds the hand-written kernels'
  launches from ``ops/ps_decorrelate.launches`` (K1) and
  ``ops/qwire_rows.launches`` (the row decoders).
* ``device_trace(logdir, device)`` — a ``torch.profiler`` trace of any
  decode region, written as a Chrome trace (``logdir/trace.json``,
  viewable in chrome://tracing or Perfetto) with the program's spans
  beside the profiler's records, on the profiler's clock; it records
  the card's kernels when the decode runs on one.
* bit-level tracing — ``bitstream.reader.TracingBitReader`` (see the CLI
  ``--bit-trace`` flag).

Clock: a span is stamped with ``time.perf_counter_ns()``.  The
profiler stamps its host records, and the card's records it converts,
with ``time.time_ns()`` (Linux, PyTorch 2.x).  ``recording()`` reads both
clocks at its start and at its end; ``Recording.to_trace_ns`` maps a
span's stamps onto the profiler's clock between those two offsets, and
``Recording.drift_ns`` is how far the offset moved over the recording.
"""
from __future__ import annotations

import contextlib
import itertools
import json
import os
import sys
import threading
import time

TRACE_FILE = "trace.json"

# the switch: True while a ``recording()`` is open (read once per span)
_on = False
_recordings: list = []          # the open recordings, innermost last
_local = threading.local()      # .stack: this thread's open spans, .tid
_ids = itertools.count(1)       # span ids
_calls = itertools.count(1)     # call ids: one per root span

# counters at the layer boundaries, always kept (``count``)
counters: dict = {}
_count_lock = threading.Lock()


class _NoSpan:
    """The shared span handed out while nothing records."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs) -> None:
        pass


NO_SPAN = _NoSpan()


class Span:
    """One recorded stretch: ``name``, ``start_ns`` / ``end_ns``
    (``time.perf_counter_ns``), its ``id``, its ``parent``'s id (None
    for a root), ``call`` (the root's call id, shared by every span of
    one request), ``thread`` (the native thread id) and ``attrs``.  A
    span left by an exception carries ``attrs["error"]``, the
    exception's type name."""
    __slots__ = ("name", "attrs", "parent", "id", "call", "thread",
                 "start_ns", "end_ns", "_up")

    def __init__(self, name: str, parent, attrs: dict):
        self.name = name
        self.attrs = attrs
        self._up = parent

    def set(self, **attrs) -> None:
        """Add attributes known only inside the span."""
        self.attrs.update(attrs)

    def __enter__(self):
        here = _thread()
        stack = here.stack
        up = self._up if self._up is not None else (
            stack[-1] if stack else None)
        self.parent = None if up is None else up.id
        self.call = next(_calls) if up is None else up.call
        self.id = next(_ids)
        self.thread = here.tid
        stack.append(self)
        self.start_ns = time.perf_counter_ns()
        return self

    def __exit__(self, etype, exc, tb):
        self.end_ns = time.perf_counter_ns()
        _thread().stack.pop()
        self._up = None
        if etype is not None:
            self.attrs["error"] = etype.__name__
        for rec in _recordings:
            rec.spans.append(self)
        return False


def _thread():
    """This thread's open spans (``.stack``) and native id (``.tid``,
    read once: it is a system call)."""
    if not hasattr(_local, "stack"):
        _local.stack = []
        _local.tid = threading.get_native_id()
    return _local


def span(name: str, parent: Span | None = None, **attrs):
    """A context manager around one stretch of the program.  Its parent
    is the innermost span open on this thread, or ``parent`` (a span
    opened on another thread: the parse worker's ``group.parse`` takes
    its ``bucket``).  Outside ``recording()``: ``NO_SPAN``."""
    if not _on:
        return NO_SPAN
    return Span(name, parent, attrs)


def current() -> Span | None:
    """The innermost span open on this thread (None when nothing
    records): what a span opened on another thread takes as parent."""
    if not _on:
        return None
    stack = _thread().stack
    return stack[-1] if stack else None


def count(name: str, n=1) -> None:
    """Add ``n`` to counter ``name``."""
    with _count_lock:
        counters[name] = counters.get(name, 0) + n


def snapshot() -> dict:
    """The counters, with K1's launches by napb (``k1.launches.<napb>``)
    and the row decoders' by pair (``qwire_rows.launches.<pair>``) where
    the kernels' modules are loaded."""
    with _count_lock:
        out = dict(counters)
    for prefix, mod in (("k1", "ps_decorrelate"),
                        ("qwire_rows", "qwire_rows")):
        m = sys.modules.get(f"heaac_tpu_torch.ops.{mod}")
        if m is not None:
            out.update((f"{prefix}.launches.{k}", n)
                       for k, n in m.launches.items())
    return out


def _clocks() -> tuple:
    """(perf_counter_ns, the profiler's clock in ns), read together."""
    return time.perf_counter_ns(), time.time_ns()


class Recording:
    """What one ``recording()`` kept: ``spans`` (in the order they
    ended), ``counters`` (each counter's change over the recording,
    nonzero ones) and the two clock readings ``clock0`` / ``clock1``
    ((perf_counter_ns, profiler clock ns) at its start and end)."""

    def __init__(self):
        self.spans: list = []
        self.counters: dict = {}
        self.clock0 = self.clock1 = _clocks()

    @property
    def drift_ns(self) -> int:
        """How far the profiler clock's offset from ``perf_counter_ns``
        moved between the recording's start and its end."""
        return ((self.clock1[1] - self.clock1[0])
                - (self.clock0[1] - self.clock0[0]))

    def to_trace_ns(self, t):
        """``perf_counter_ns`` stamps (an int or a numpy array) -> the
        profiler's clock, the offset interpolated between the
        recording's start and end."""
        (p0, c0), (p1, _) = self.clock0, self.clock1
        d = t - p0
        return c0 + d + (d * self.drift_ns) // max(p1 - p0, 1)


@contextlib.contextmanager
def recording():
    """Record every span inside the block (on any thread) -> yields a
    ``Recording``, filled when the block ends."""
    global _on
    rec = Recording()
    before = snapshot()
    _recordings.append(rec)
    _on = True
    try:
        yield rec
    finally:
        rec.clock1 = _clocks()
        _recordings.remove(rec)
        _on = bool(_recordings)
        after = snapshot()
        rec.counters = {k: v - before.get(k, 0) for k, v in after.items()
                        if v != before.get(k, 0)}


def chrome_events(rec: Recording, base_ns: int = 0) -> list:
    """The recording's spans as Chrome trace complete events ("ph": "X",
    microseconds from ``base_ns`` on the profiler's clock)."""
    pid = os.getpid()
    out = []
    for s in rec.spans:
        t0 = rec.to_trace_ns(s.start_ns)
        out.append(dict(
            ph="X", cat="program_span", name=s.name, pid=pid, tid=s.thread,
            ts=(t0 - base_ns) / 1e3, dur=(s.end_ns - s.start_ns) / 1e3,
            args=dict(s.attrs, id=s.id, parent=s.parent, call=s.call)))
    return out


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Profile everything inside the block with ``torch.profiler`` (host
    activity, and the card's when ``device`` is a CUDA device), record
    the program's spans, and export both as one Chrome trace into
    ``logdir`` (the spans as "program_span" events; the counters'
    changes under the trace's ``heaac_counters`` key)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with recording() as rec:
        with profile(activities=activities) as prof:
            yield prof
            if cuda:
                torch.cuda.synchronize()
    path = os.path.join(logdir, TRACE_FILE)
    prof.export_chrome_trace(path)
    with open(path) as f:
        doc = json.load(f)
    doc["traceEvents"] += chrome_events(rec, doc.get("baseTimeNanoseconds",
                                                     0))
    doc["heaac_counters"] = rec.counters
    with open(path, "w") as f:
        json.dump(doc, f, default=str)
