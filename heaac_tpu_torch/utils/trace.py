"""Profiling and tracing: the port's counterpart of
``heaac_tpu/utils/trace.py``.

The reference's affordances are START_TIMER rdtsc macros, ``-benchmark``
wall-time, and TRACE-gated bit logging (libavutil/timer.h,
get_bits.h:620-663).  Here:

* ``device_trace(logdir, device)`` — a ``torch.profiler`` trace of any
  decode region, written as a Chrome trace (``logdir/trace.json``,
  viewable in chrome://tracing or Perfetto); it records the card's
  kernels when the decode runs on one.
* ``timed(label)`` — wall time of a block.
* bit-level tracing — ``bitstream.reader.TracingBitReader`` (see the CLI
  ``--bit-trace`` flag).
"""
from __future__ import annotations

import contextlib
import os

TRACE_FILE = "trace.json"


@contextlib.contextmanager
def device_trace(logdir: str, device="cuda"):
    """Profile everything inside the block with ``torch.profiler`` (host
    activity, and the card's when ``device`` is a CUDA device) and export
    it as a Chrome trace into ``logdir``."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    cuda = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if cuda:
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(logdir, TRACE_FILE))


@contextlib.contextmanager
def timed(label: str, sink=None):
    """START_TIMER/STOP_TIMER analogue (libavutil/timer.h:46)."""
    import time

    t0 = time.perf_counter()
    try:
        yield
    finally:
        dt = time.perf_counter() - t0
        (sink or (lambda m: print(m)))(f"{label}: {dt * 1e3:.3f} ms")
