"""A spawned process pool for the benchmark's host work outside the
measured window (stream generation, the reference decode)."""
from __future__ import annotations

import gc
import multiprocessing as mp
import os
from multiprocessing import resource_tracker, util


def pool_map(fn, items, workers: int | None = None, initializer=None,
             initargs=()) -> list:
    """fn over items in spawned worker processes, in order; every worker
    is joined before it returns.  fn (and ``initializer``, run once in
    each worker with ``initargs``) must be importable by name and import
    only what the worker needs (NumPy and ``hebench.ref`` / ``.gen``).
    With one worker it all runs in this process."""
    items = list(items)
    if not items:
        return []
    n = max(1, min(workers or os.cpu_count() or 1, len(items)))
    if n == 1:
        if initializer is not None:
            initializer(*initargs)
        return [fn(x) for x in items]
    pool = mp.get_context("spawn").Pool(n, initializer, initargs)
    try:
        return pool.map(fn, items, chunksize=max(1, len(items) // (4 * n)))
    finally:
        pool.close()
        pool.join()
        del pool
        _stop_tracker()


def _stop_tracker() -> None:
    """Stop, and wait for, the resource tracker process that a spawned
    pool's locks start and that would outlive this process: once the
    pool's locks are collected and their finalizers have run, nothing
    asks for it again."""
    gc.collect()
    util._run_finalizers(0)
    resource_tracker._resource_tracker._stop()
