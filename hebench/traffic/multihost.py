"""Multi-process closed loop: an ingest host with one card per rank.
One rank process per card runs the program's
``parallel.multihost.decode_shard_and_reduce`` on its round-robin shard
(stream i on rank ``i % ranks``) and hands back its shard's PCM on its
host; the ranks share the program's one all-reduce of the decode counts.

Set-up: first the program is asked whether a rank hands back its PCM
(``decode_shard_and_reduce`` takes ``pcm_out``); a program that does
not cannot run the cell and the run stops at once.  Then the streams
from the seed (in spawned processes), and one spawned rank process per
card (rank k on card k), each with one intra-op thread
(``RANK_THREADS``), receiving its shard over a pipe, joining the process
group (``init_process_group`` with a finite timeout) and making one
warm-up call.  Window: calls until ``--seconds`` have
passed.  The harness is the one coordinator: it tells every rank to
start a call, and the call ends when every rank has replied after its
``decode_shard_and_reduce(..., pcm_out=...)``.  ``realtime_x`` is the
audio seconds the window's calls all-reduced over the wall time from the
window's start to the end of its last call.  Every stream of every call
is held to the length its frames give, and every rank's reduced counts
to the plain sums of ``ref.multihost``: a call whose counts differ
counts all its streams failed.  Ranks send back the PCM of a sample of
streams drawn from the seed, from every call.

``--trace 1``: after set-up, calls with every rank recording its spans
(``utils.trace.recording``): one with rank 0's card profiled alone (the
traced window: busy and idle shares), one unprofiled, and one with rank
0's host operations profiled too (only to name the idle gaps; its spans
are not read, the profiler stretches it).  The span readers take the
mean over ranks of the first two.

A rank that raises sends its traceback and exits; a rank that dies, or
stays silent past its call's limit, is noticed by the coordinator.
Either way every rank is killed and the run raises: no rank is left
waiting in a collective.

Mix parameters: ``ranks``, ``backend``, ``invf_modes``,
``check_streams``, ``limits``; for the tests: ``streams`` in place of
the configuration's count, ``frames`` (each stream's first frames) and
``rank_init`` ("module:function" each rank calls with its rank before
it joins the group).
"""
from __future__ import annotations

import contextlib
import importlib
import inspect
import multiprocessing as mp
import socket
import time
import traceback
from multiprocessing.connection import wait

import numpy as np

from .. import harness
from ..gen import make_streams
from ..pool import _stop_tracker
from ..ref import multihost as ref
from ..ref.bitstream.adts import split_adts_stream

# seconds into a traced run after which the call that only names the
# idle gaps is left out, so that a slow host still ends the run in 360 s
GAP_TRACE_UNTIL_S = 150
# limits on the coordinator's wait for every rank's reply: set-up (rank
# start, group rendezvous, builds, the warm-up call and its step-graph
# capture), a call, a profiled call, and the ranks' goodbye
READY_TIMEOUT_S = 300
CALL_TIMEOUT_S = 60
TRACED_CALL_TIMEOUT_S = 240
STOP_TIMEOUT_S = 30
GROUP_TIMEOUT_S = 120          # init_process_group's and collectives'
# each rank's intra-op threads: one, as torchrun sets OMP_NUM_THREADS for
# several processes a host.  More threads a rank crawl here: the PCM
# split is a thousand small parallel copies a call, whose thread teams
# wait on each other once four ranks' teams and the card and NCCL
# threads share the cores (on a 32-core host with four H100s,
# multihost.pcm took ~40 s a call at 32 threads a rank, 0.2-11 s at 8)
RANK_THREADS = 1
# the spans the readers take, each summed over a call in milliseconds;
# group.parse_wait only where a multihost.decode holds it
SPANS = ("multihost.decode", "multihost.allreduce", "multihost.pcm")
NESTED = ("group.parse_wait", "multihost.decode")


def _span_ms(rec) -> dict:
    """One recorded call's spans -> {name: milliseconds summed}; a name
    the program did not record is left out."""
    by_id = {s.id: s for s in rec.spans}

    def under(s, name):
        while s.parent is not None:
            s = by_id.get(s.parent)
            if s is None:
                return False
            if s.name == name:
                return True
        return False

    out: dict = {}
    for s in rec.spans:
        if s.name in SPANS or (s.name == NESTED[0] and under(s, NESTED[1])):
            out[s.name] = out.get(s.name, 0.0) + (s.end_ns - s.start_ns) / 1e6
    return out


def _rank(rank: int, ranks: int, device: str, backend: str, addr: str,
          conn, rank_init: str | None) -> None:
    """A rank process: receive the shard, join the group, warm up, then
    serve the coordinator's calls until it says stop."""
    try:
        import datetime

        import torch
        import torch.distributed as dist

        from heaac_tpu_torch.parallel import multihost
        from heaac_tpu_torch.utils import trace

        from .. import devtrace

        torch.set_num_threads(RANK_THREADS)
        if rank_init:
            mod, fn = rank_init.split(":")
            getattr(importlib.import_module(mod), fn)(rank)
        shard = conn.recv()
        dev = torch.device(device)
        cuda = dev.type == "cuda"
        if cuda:
            torch.cuda.set_device(dev)
            torch.cuda.reset_peak_memory_stats(dev)
        dist.init_process_group(
            backend, init_method=addr, world_size=ranks, rank=rank,
            timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))

        def call(keep=(), mode=None) -> dict:
            pcm, info = [], {}
            prof = rank == 0 and mode in ("trace", "gap_trace")
            cap0 = trace.snapshot().get("scan.graph.captures", 0)
            with contextlib.ExitStack() as stack:
                rec = stack.enter_context(trace.recording()) if mode \
                    else None
                box = stack.enter_context(devtrace.capture(
                    dev, host_ops=mode == "gap_trace")) if prof else {}
                t = time.perf_counter()
                out = multihost.decode_shard_and_reduce(
                    shard, dev, info_out=info, pcm_out=pcm)
                wall = time.perf_counter() - t
            counts = dict(out, num_devices=info["num_devices"])
            return dict(
                counts=counts, wall_s=wall, decode_s=info["decode_s"],
                shapes=[tuple(p.shape) for p in pcm],
                kept=[pcm[j].numpy() for j in keep],
                captures=trace.snapshot().get("scan.graph.captures", 0)
                - cap0,
                spans=_span_ms(rec) if rec is not None else None,
                trace=box.get("trace"),
                peak=int(torch.cuda.max_memory_allocated(dev)) if cuda
                else 0)

        conn.send(("ok", call()))                        # warm-up
        while True:
            msg = conn.recv()
            if msg[0] == "stop":
                break
            conn.send(("ok", call(*msg[1:])))
        dist.destroy_process_group()
        conn.send(("ok", None))
    except BaseException:
        with contextlib.suppress(OSError):
            conn.send(("error", traceback.format_exc()))
        raise


class _Ranks:
    """The coordinator's side: the rank processes and their pipes."""

    def __init__(self, shards: list, devices: list, backend: str,
                 rank_init: str | None):
        n = len(shards)
        with socket.socket() as s:                  # a free local port
            s.bind(("127.0.0.1", 0))
            addr = f"tcp://127.0.0.1:{s.getsockname()[1]}"
        spawn = mp.get_context("spawn")
        self.procs, self.conns = [], []
        try:
            for r in range(n):
                here, there = spawn.Pipe()
                p = spawn.Process(target=_rank, name=f"rank{r}", args=(
                    r, n, devices[r], backend, addr, there, rank_init))
                p.start()
                there.close()           # a dead rank's pipe then breaks
                self.procs.append(p)
                self.conns.append(here)
            for c, sh in zip(self.conns, shards):
                c.send(sh)
        except BaseException:
            self.kill()
            raise

    def gather(self, timeout: float, stopping: bool = False) -> list:
        """Every rank's next reply; raises if a rank reports an error,
        dies before it replied (or, inside a call, at all: the others
        would wait for it in the collective) or is silent past
        ``timeout``."""
        n = len(self.procs)
        out: list = [None] * n
        pending = set(range(n))
        deadline = time.monotonic() + timeout
        while pending:
            left = deadline - time.monotonic()
            if left <= 0:
                raise RuntimeError(f"ranks {sorted(pending)} silent for "
                                   f"{timeout} s")
            wait([self.conns[r] for r in pending]
                 + [p.sentinel for p in self.procs], min(left, 1.0))
            for r, p in enumerate(self.procs):
                # whether it has exited is read first: a rank that had
                # exited left every message it sent in its pipe
                dead = p.exitcode is not None
                if r in pending:
                    msg = self._next(r)
                    if msg is not None and msg[0] == "ok":
                        out[r] = msg[1]
                        pending.discard(r)
                    elif msg is not None:
                        raise RuntimeError(f"rank {r} failed:\n{msg[1]}")
                    elif dead:
                        raise RuntimeError(f"rank {r} exited with "
                                           f"{p.exitcode}")
                elif dead and not stopping:
                    raise RuntimeError(f"rank {r} exited with {p.exitcode}")
        return out

    def _next(self, r: int):
        """Rank r's next message if one is waiting, else None."""
        try:
            return self.conns[r].recv() if self.conns[r].poll() else None
        except (EOFError, OSError):
            return None

    def call(self, keeps: list, mode, timeout: float) -> list:
        for c, keep in zip(self.conns, keeps):
            c.send(("call", keep, mode))
        return self.gather(timeout)

    def stop(self) -> None:
        for c in self.conns:
            c.send(("stop",))
        self.gather(STOP_TIMEOUT_S, stopping=True)

    def kill(self) -> None:
        """Kill and reap every rank still alive; close the pipes."""
        for p in self.procs:
            if p.is_alive():
                p.kill()
        for p, c in zip(self.procs, self.conns):
            p.join(10)
            c.close()
        _stop_tracker()


def _check_program() -> None:
    """Stop at once where the program's ranks hand back no PCM."""
    from heaac_tpu_torch.parallel import multihost
    params = inspect.signature(multihost.decode_shard_and_reduce).parameters
    if "pcm_out" not in params:
        raise SystemExit("the program's decode_shard_and_reduce takes no "
                         "pcm_out: its ranks hand back no PCM, so it cannot "
                         "run this cell")


def run(ctx: harness.Context) -> harness.Outcome:
    _check_program()
    cfg, mix = ctx.config, ctx.mix
    ranks = mix["ranks"]
    n = mix.get("streams", cfg["streams"])
    t = time.perf_counter()
    streams = make_streams(ctx.root, cfg["generator"], n, ctx.seed,
                           mix["invf_modes"], ctx.workers)
    if mix.get("frames"):
        streams = [b"".join(split_adts_stream(s)[:mix["frames"]])
                   for s in streams]
    frames = ref.frame_counts(streams)
    want = ref.global_counts(frames, ranks, cfg["output_rate"])
    harness.log(f"streams: {n} made in {time.perf_counter() - t:.3f} s; "
                f"{want['frames']} frames")
    ch = cfg["output_channels"]
    shard_idx = [ref.shard(n, ranks, r) for r in range(ranks)]
    rng = np.random.default_rng(ctx.seed % (1 << 63))
    sample = sorted(rng.choice(n, size=min(mix["check_streams"], n),
                               replace=False).tolist())
    # rank r keeps local index i // ranks of each sampled stream i it holds
    keeps = [[i // ranks for i in sample if ref.rank_of(i, ranks) == r]
             for r in range(ranks)]
    devices = [f"cuda:{r}" if ctx.device == "cuda" else ctx.device
               for r in range(ranks)]

    kept = {i: [] for i in sample}
    tally = {"attempted": 0, "failed": 0}

    def hold(replies: list) -> float:
        """Hold one call's replies to the plain reference -> its audio
        seconds; keep the sampled streams' PCM."""
        bad = 0
        for r, rep in enumerate(replies):
            bad += sum(tuple(s) != (ref.pcm_rows(frames[i]), ch)
                       for s, i in zip(rep["shapes"], shard_idx[r]))
            if len(rep["shapes"]) != len(shard_idx[r]):
                bad += len(shard_idx[r])
            for j, p in zip(keeps[r], rep["kept"]):
                kept[shard_idx[r][j]].append(p)
        if not all(ref.counts_agree(rep["counts"], want) for rep in replies):
            harness.log(f"reduced counts {[rep['counts'] for rep in replies]}"
                        f" differ from the plain sums {want}")
            bad = n
        tally["attempted"] += n
        tally["failed"] += min(bad, n)
        return replies[0]["counts"]["audio_seconds"]

    t = time.perf_counter()
    pool = _Ranks([[streams[i] for i in ix] for ix in shard_idx], devices,
                  mix["backend"], mix.get("rank_init"))
    data: dict = {}
    try:
        warm = pool.gather(READY_TIMEOUT_S)
        harness.log(f"ranks up and warm in {time.perf_counter() - t:.3f} s, "
                    f"{RANK_THREADS} intra-op thread each; warm-up call "
                    f"{[round(w['wall_s'], 3) for w in warm]} s, captures "
                    f"{[w['captures'] for w in warm]}")
        setup_s = harness.setup_done(ctx)
        e2e: dict = {}
        last = warm
        if not ctx.trace:
            audio = 0.0
            walls = []
            w0 = time.perf_counter()
            while True:
                t = time.perf_counter()
                last = pool.call(keeps, None, CALL_TIMEOUT_S)
                walls.append(time.perf_counter() - t)
                audio += hold(last)
                wall = time.perf_counter() - w0
                if wall >= ctx.seconds:
                    break
            harness.log(
                f"window: {len(walls)} calls, {audio:.3f} s of audio in "
                f"{wall:.3f} s; calls {[round(w, 3) for w in walls]} s; "
                f"last call's rank walls "
                f"{[round(x['wall_s'], 3) for x in last]} s, decode "
                f"{[round(x['decode_s'], 3) for x in last]} s, captures "
                f"{[x['captures'] for x in last]}")
            e2e = {"realtime_x": audio / wall, "setup_s": setup_s}
        else:
            spans = []
            for mode in ("trace", "record", "gap_trace"):
                if mode == "gap_trace" and \
                        time.perf_counter() - ctx.t0 > GAP_TRACE_UNTIL_S:
                    harness.log("the call that names the idle gaps is left "
                                f"out: {GAP_TRACE_UNTIL_S} s have passed")
                    break
                last = pool.call(keeps, mode, TRACED_CALL_TIMEOUT_S)
                hold(last)
                if mode == "gap_trace":
                    data["gap_trace"] = last[0]["trace"]
                    continue
                if mode == "trace":
                    data["trace"] = last[0]["trace"]
                spans += [rep["spans"] for rep in last]
                harness.log(f"{mode} call: rank walls "
                            f"{[round(x['wall_s'], 3) for x in last]} s, "
                            f"spans {[rep['spans'] for rep in last]}")
            data["spans"] = spans
            tr = data["trace"]
            harness.log(f"traced call: {tr.window_s:.3f} s on rank 0, "
                        f"{tr.launches()} kernel launches")
        peak = max(rep["peak"] for rep in last)
        harness.log(f"card memory peaks {[rep['peak'] for rep in last]} B")
        pool.stop()
    finally:
        pool.kill()
    return harness.Outcome(
        attempted=tally["attempted"], failed=tally["failed"], e2e=e2e,
        memory_peak_bytes=peak, streams=[streams[i] for i in sample],
        pcm=[kept[i] for i in sample], data=data)
