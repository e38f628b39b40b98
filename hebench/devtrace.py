"""A profiler trace reduced to the arrays the per-layer readers use.

``capture()`` runs a block under ``torch.profiler`` and returns a
``Trace``: every device operation (kernel, memcpy, memset) as start /
end nanoseconds with its name, and, where host operations were recorded
too, every host operation likewise, on the same clock.  From it: the
union of device busy time, kernel launch counts, device time by kernel
name, and the idle gaps between device operations, each named by the
innermost host operation that was running at the gap's middle.

Recording host operations stretches a host-bound block (about 2.2x for
a batched decode call), so a block's busy and idle shares are read from
a capture of device activity alone (``host_ops=False``), and only the
naming of its gaps from a second capture with host operations.
"""
from __future__ import annotations

import contextlib
import sys
import time
from dataclasses import dataclass

import numpy as np

NAME_CHARS = 160           # kernel names are cut to this in a breakdown
NO_HOST_OP = "host: no op recorded"
COPY_PREFIXES = ("Memcpy", "Memset", "memcpy", "memset")
# innermost candidates searched per gap (host ops nest only a few deep)
INNER_DEPTH = 64


def _is_runtime_call(name: str) -> bool:
    """CUDA runtime / driver API records (cudaLaunchKernel, cuLaunch...):
    leaves inside an operation, never what names a gap."""
    return name.startswith("cuda") or (name.startswith("cu")
                                       and name[2:3].isupper())


@dataclass
class Trace:
    window_ns: tuple | None              # (start, end) of the traced block
                                         # on the profiler's clock, where
                                         # host operations were recorded
    dev_start: np.ndarray                # int64 ns, device operations
    dev_end: np.ndarray
    dev_name: list
    host_start: np.ndarray               # int64 ns, host operations
    host_end: np.ndarray
    host_name: list
    wall_s: float = 0.0                  # the block on the host's clock

    @property
    def window_s(self) -> float:
        if self.window_ns is None:
            return self.wall_s
        return (self.window_ns[1] - self.window_ns[0]) / 1e9

    def kernel_mask(self) -> np.ndarray:
        return np.array([not n.startswith(COPY_PREFIXES)
                         for n in self.dev_name], bool)

    def launches(self, substring: str | None = None) -> int:
        """Kernel launches, or those whose name holds ``substring``."""
        if substring is None:
            return int(self.kernel_mask().sum())
        return sum(substring in n for n in self.dev_name)

    def kernel_durations_s(self, substring: str) -> np.ndarray:
        sel = np.array([substring in n for n in self.dev_name], bool)
        if not sel.any():
            return np.zeros(0)
        return (self.dev_end[sel] - self.dev_start[sel]) / 1e9

    def busy_intervals(self) -> tuple:
        """Union of the device operations, clipped to the window where
        it is known on their clock -> (starts, ends) int64 ns, sorted and
        disjoint."""
        if self.window_ns is None:
            return union(self.dev_start, self.dev_end)
        return union(np.clip(self.dev_start, *self.window_ns),
                     np.clip(self.dev_end, *self.window_ns))

    def busy_s(self) -> float:
        s, e = self.busy_intervals()
        return float((e - s).sum()) / 1e9

    def device_ops(self, top: int = 10) -> list:
        """[[kernel name, device seconds summed], ...], most first."""
        tot: dict = {}
        for n, d in zip(self.dev_name, (self.dev_end - self.dev_start)):
            tot[n] = tot.get(n, 0) + int(d)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], v / 1e9] for n, v in rows]

    def idle_gaps(self, top: int = 10) -> list:
        """[[host operation, idle device seconds summed], ...]: every gap
        between device operations inside the window, named by the
        innermost host operation running at its middle, most first;
        none without host operations."""
        if self.window_ns is None:
            return []
        s, e = self.busy_intervals()
        g0 = np.concatenate([[self.window_ns[0]], e])
        g1 = np.concatenate([s, [self.window_ns[1]]])
        keep = g1 > g0
        g0, g1 = g0[keep], g1[keep]
        if len(g0) == 0:
            return []
        names = self.name_at((g0 + g1) // 2)
        tot: dict = {}
        for n, d in zip(names, g1 - g0):
            tot[n] = tot.get(n, 0) + int(d)
        rows = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
        return [[n[:NAME_CHARS], v / 1e9] for n, v in rows]

    def name_at(self, t: np.ndarray) -> list:
        """Name of the innermost host operation running at each time in
        t (the one that started last among those that contain it)."""
        order = np.argsort(self.host_start, kind="stable")
        hs, he = self.host_start[order], self.host_end[order]
        pos = np.searchsorted(hs, t, side="right") - 1
        found = np.full(len(t), -1, np.int64)
        for k in range(INNER_DEPTH):
            c = pos - k
            ok = (found < 0) & (c >= 0)
            cc = np.where(ok, c, 0)
            hit = ok & (hs[cc] <= t) & (he[cc] >= t)
            found[hit] = order[cc[hit]]
            if (found >= 0).all():
                break
        return [self.host_name[i] if i >= 0 else NO_HOST_OP for i in found]


def union(starts: np.ndarray, ends: np.ndarray) -> tuple:
    """Disjoint sorted union of the intervals [starts, ends)."""
    if len(starts) == 0:
        return np.zeros(0, np.int64), np.zeros(0, np.int64)
    o = np.argsort(starts, kind="stable")
    s, e = starts[o], ends[o]
    run_end = np.maximum.accumulate(e)
    new = np.ones(len(s), bool)
    new[1:] = s[1:] > run_end[:-1]
    idx = np.flatnonzero(new)
    out_s = s[idx]
    out_e = np.append(run_end[idx[1:] - 1], run_end[-1])
    return out_s, out_e


def _record(e) -> tuple:
    return (e.name(), e.device_type(), e.start_ns(), e.duration_ns(),
            e.is_user_annotation())


WINDOW_SPAN = "hebench::window"


@contextlib.contextmanager
def capture(device, host_ops: bool = True):
    """Profile the block -> yields a dict that holds ``"trace"`` (a
    Trace) once the block has ended.  A synchronize opens and closes the
    block.  With ``host_ops`` the host's operations are recorded too and
    the window is a host span around the block, read on the profiler's
    own clock; without, only the card's activity is recorded and the
    window is the block's wall on the host's clock.  On the CPU (the
    tests) only host activity exists, and is recorded either way.  The
    profiler is stopped at its lowest level, so only its raw records are
    read: PyTorch's own post-processing builds a Python object tree for
    every record, minutes for the ~3 million records of one batched
    call."""
    import torch
    from torch.autograd import DeviceType, _disable_profiler
    from torch.autograd.profiler import profile, record_function

    cuda = torch.device(device).type == "cuda"
    host_ops = host_ops or not cuda

    def sync():
        if cuda:
            torch.cuda.synchronize(device)

    box: dict = {}
    sync()
    prof = profile(use_device="cuda" if cuda else None, use_kineto=True,
                   use_cpu=host_ops)
    prof._prepare_trace()
    prof._start_trace()
    span = record_function(WINDOW_SPAN) if host_ops \
        else contextlib.nullcontext()
    try:
        t0 = time.perf_counter()
        with span:
            yield box
            sync()
        wall = time.perf_counter() - t0
    finally:
        t = time.perf_counter()
        result = _disable_profiler()
    raw = [_record(e) for e in result.events()]
    print(f"# profiler ({'host and card' if host_ops else 'card only'}): "
          f"{len(raw)} records stopped and read in "
          f"{time.perf_counter() - t:.3f} s", file=sys.stderr, flush=True)
    window = None
    if host_ops:
        win = [r for r in raw
               if r[0] == WINDOW_SPAN and r[1] == DeviceType.CPU]
        if len(win) != 1:
            raise RuntimeError(f"profiler returned {len(win)} window spans")
        window = (win[0][2], win[0][2] + win[0][3])
    # a host span is mirrored on the device's timeline as an annotation:
    # it is no device operation
    dev = [r for r in raw if r[1] == DeviceType.CUDA and not r[4]
           and r[0] != WINDOW_SPAN]
    host = [r for r in raw if host_ops and r[1] == DeviceType.CPU
            and r[0] != WINDOW_SPAN and not _is_runtime_call(r[0])]
    box["trace"] = Trace(
        window_ns=window,
        dev_start=np.array([r[2] for r in dev], np.int64),
        dev_end=np.array([r[2] + r[3] for r in dev], np.int64),
        dev_name=[r[0] for r in dev],
        host_start=np.array([r[2] for r in host], np.int64),
        host_end=np.array([r[2] + r[3] for r in host], np.int64),
        host_name=[r[0] for r in host], wall_s=wall)
