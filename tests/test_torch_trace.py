"""The port's span and counter recorder (``heaac_tpu_torch.utils.trace``)
on the CPU: nothing is recorded outside ``recording()``; inside it, a
``decode_batch`` call gives the span tree decode_batch -> probe / bucket
-> group.parse (on the parse worker) / parse_wait / upload / scan ->
scan.prologue / scan.step -> expand_frame (-> qwire_rows) / expand_ps /
frame_graph -> k1, with the bucket's attributes equal to its ``bucket_stats`` record;
``decode_frame`` gives its four stages; a ``multihost`` rank's call
gives multihost.decode (with the group spans) -> multihost.pcm, then
multihost.allreduce, and its three counters; spans land on the
profiler's clock; on the CPU the scan steps eagerly (no CUDA graph); a
step graph keeps the hand-written kernels' launch counts across its
capture and replays (a stand-in graph on the CPU), and the PS row
decoder's table comes from the per-device cache."""
import collections
import contextlib
import functools
import logging

import numpy as np
import pytest
import torch
from torch.autograd.profiler import profile, record_function

from heaac_tpu_torch import Decoder, decode_batch
from heaac_tpu_torch.codec import batch, step_graph
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.ops import ps_decorrelate, ps_huff, qwire_rows
from heaac_tpu_torch.utils import trace
from test_torch_common import streams_of

FRAMES = 3


def _heads(n: int) -> list:
    return [b"".join(split_adts_stream(d)[:FRAMES])
            for d in streams_of("he20", n)]


def _by_id(rec) -> dict:
    return {s.id: s for s in rec.spans}


def _parent_name(s, by_id) -> str | None:
    return None if s.parent is None else by_id[s.parent].name


def test_off_records_nothing(monkeypatch):
    """Outside ``recording()`` every span is the shared no-op and no span
    object is made; counters still count."""
    assert trace.span("x", a=1) is trace.NO_SPAN
    assert trace.current() is None
    with trace.span("x") as sp:
        sp.set(b=2)

    def no_span(*a, **kw):
        raise AssertionError("a span was made while nothing records")

    monkeypatch.setattr(trace, "Span", no_span)
    before = trace.snapshot().get("probe.native", 0)
    decode_batch(_heads(1), device="cpu")
    assert trace.snapshot()["probe.native"] == before + 1


def test_decode_batch_span_tree(monkeypatch, caplog):
    """Two groups of two streams: one group.parse per group on the
    worker thread under the bucket, one scan.step per frame step, every
    span inside its parent and in the call's one call id."""
    monkeypatch.setattr(batch, "QwirePipelinedDecoder", functools.partial(
        batch.QwirePipelinedDecoder, group_streams=2))
    caplog.set_level(logging.INFO, logger="heaac_tpu_torch")
    with trace.recording() as rec:
        decode_batch(_heads(4), device="cpu")
    by_id = _by_id(rec)
    tree = collections.Counter((s.name, _parent_name(s, by_id))
                               for s in rec.spans)
    groups, steps = 2, 2 * FRAMES
    assert tree == {
        ("decode_batch", None): 1, ("probe", "decode_batch"): 1,
        ("bucket", "decode_batch"): 1, ("bucket.pcm", "bucket"): 1,
        ("group.parse", "bucket"): groups,
        ("group.parse_wait", "bucket"): groups,
        ("group.upload", "bucket"): groups, ("group.scan", "bucket"): groups,
        ("scan.prologue", "group.scan"): groups,
        ("scan.step", "group.scan"): steps,
        ("expand_frame", "scan.step"): steps,
        ("qwire_rows", "expand_frame"): steps,
        ("expand_ps", "scan.step"): steps,
        ("frame_graph", "scan.step"): steps, ("k1", "frame_graph"): steps}
    root = next(s for s in rec.spans if s.name == "decode_batch")
    assert {s.call for s in rec.spans} == {root.call}
    parse = [s for s in rec.spans if s.name == "group.parse"]
    assert {s.thread for s in parse} != {root.thread}
    assert sorted(s.attrs["group"] for s in parse) == [0, 1]
    assert [s.attrs["frames"] for s in parse] == [2 * FRAMES] * groups
    for s in rec.spans:
        assert s.start_ns <= s.end_ns
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, \
                s.name
    probe = next(s for s in rec.spans if s.name == "probe")
    assert probe.attrs == dict(native=4, python=0)
    assert rec.counters["probe.native"] == 4
    stats = [r.bucket_stats for r in caplog.records
             if hasattr(r, "bucket_stats")]
    bucket = next(s for s in rec.spans if s.name == "bucket")
    assert [bucket.attrs] == stats
    assert stats[0]["errored"] == 0 and stats[0]["steps"] == steps


def test_decode_frame_stages():
    """Two frames of the single-stream Decoder: each a call of its own
    with frame.parse, prep, issue and download in that order."""
    data = _heads(1)[0]
    dec = Decoder(adts_probe=data[:7], device="cpu")
    with trace.recording() as rec:
        for f in split_adts_stream(data)[:2]:
            dec.decode_frame(f)
    by_id = _by_id(rec)
    frames = [s for s in rec.spans if s.name == "decode_frame"]
    assert len(frames) == 2 and len({s.call for s in frames}) == 2
    for fr in frames:
        kids = sorted((s for s in rec.spans if s.parent == fr.id),
                      key=lambda s: s.start_ns)
        assert [s.name for s in kids] == ["frame.parse", "frame.prep",
                                          "frame.issue", "frame.download"]
    assert all(_parent_name(s, by_id) == "frame.issue"
               for s in rec.spans if s.name == "k1")


def test_multihost_spans_and_counters(tmp_path):
    """One rank in a gloo group of one, twice: with ``pcm_out`` the call
    is multihost.decode (attrs rank, streams, frames) holding the group
    spans and multihost.pcm, then multihost.allreduce; without it, no
    multihost.pcm.  Counters: calls, streams, frames."""
    import torch.distributed as dist

    from heaac_tpu_torch.parallel.multihost import decode_shard_and_reduce

    streams = _heads(2)
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0)
    try:
        with trace.recording() as rec:
            decode_shard_and_reduce(streams, "cpu", pcm_out=[])
        with trace.recording() as bare:
            decode_shard_and_reduce(streams, "cpu")
    finally:
        dist.destroy_process_group()
    by_id = _by_id(rec)
    tree = collections.Counter((s.name, _parent_name(s, by_id))
                               for s in rec.spans
                               if _parent_name(s, by_id) in (
                                   None, "multihost.decode"))
    assert tree == {
        ("multihost.decode", None): 1, ("multihost.allreduce", None): 1,
        ("multihost.pcm", "multihost.decode"): 1,
        ("group.parse", "multihost.decode"): 1,
        ("group.parse_wait", "multihost.decode"): 1,
        ("group.upload", "multihost.decode"): 1,
        ("group.scan", "multihost.decode"): 1}
    assert sum(s.name == "scan.step" for s in rec.spans) == FRAMES
    dec = next(s for s in rec.spans if s.name == "multihost.decode")
    red = next(s for s in rec.spans if s.name == "multihost.allreduce")
    assert dec.attrs == dict(rank=0, streams=2, frames=2 * FRAMES)
    assert dec.end_ns <= red.start_ns
    for s in rec.spans:
        if s.parent is not None:
            up = by_id[s.parent]
            assert up.start_ns <= s.start_ns and s.end_ns <= up.end_ns, \
                s.name
    for r in (rec, bare):
        assert {k: v for k, v in r.counters.items()
                if k.startswith("multihost.")} == {
            "multihost.calls": 1, "multihost.streams": 2,
            "multihost.frames": 2 * FRAMES}
    assert "multihost.pcm" not in {s.name for s in bare.spans}
    assert "multihost.decode" in {s.name for s in bare.spans}


def test_spans_on_the_profiler_clock():
    """``to_trace_ns`` moves perf_counter stamps by the offset, drifting
    linearly between the recording's two clock readings; a live span
    holds the profiler record made inside it once mapped."""
    rec = trace.Recording()
    rec.clock0, rec.clock1 = (1_000, 5_000), (2_000, 6_010)
    assert rec.drift_ns == 10
    assert rec.to_trace_ns(1_000) == 5_000
    assert rec.to_trace_ns(1_500) == 5_505
    assert list(rec.to_trace_ns(np.array([1_000, 2_000], np.int64))) == \
        [5_000, 6_010]
    with profile(use_kineto=True) as prof, trace.recording() as live:
        with trace.span("outer"):
            with record_function("inner"):
                torch.ones(4).sum()
    (outer,) = live.spans
    (inner,) = [e for e in prof.kineto_results.events()
                if e.name() == "inner"]
    t0, t1 = (live.to_trace_ns(t) for t in (outer.start_ns, outer.end_ns))
    slack = 200_000                      # two clock reads, in ns
    assert t0 - slack <= inner.start_ns()
    assert inner.start_ns() + inner.duration_ns() <= t1 + slack
    assert abs(live.drift_ns) < slack


def test_cpu_scan_steps_eagerly():
    """On the CPU every frame step of the qwire scan runs eagerly: the
    scan counts one eager step a frame and never captures or replays a
    CUDA graph."""
    with trace.recording() as rec:
        decode_batch(_heads(2), device="cpu")
    graph = {k: v for k, v in rec.counters.items()
             if k.startswith("scan.graph.")}
    assert graph == {"scan.graph.eager_steps": FRAMES}
    assert [s.attrs for s in rec.spans if s.name == "scan.step"] == \
        [{}] * FRAMES


@pytest.mark.parametrize("kernel,key,counter", [
    (ps_decorrelate, 30, "k1.launches.30"),
    (qwire_rows, 0, "qwire_rows.launches.0"),
    (qwire_rows, 1, "qwire_rows.launches.1")], ids=["k1", "rows", "rows-pair"])
def test_step_graph_keeps_launch_counts(monkeypatch, kernel, key, counter):
    """A step graph's capture takes back the launches its Python calls
    counted, and each replay adds the launches the graph holds, so a
    kernel's counter reads its launches on the card whether a step ran
    eagerly or from a graph (a stand-in for the CUDA graph here: the
    step runs once, at capture)."""
    class Graph:
        def replay(self):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", Graph)
    monkeypatch.setattr(torch.cuda, "Stream", lambda device: None)
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **kw: contextlib.nullcontext())

    def step(coeffs, rec, heap, carry, heap_hi=None):
        kernel.launches[key] += 2
        return coeffs + 1, dict(x=carry["x"] + 1)

    def moved(before):
        return {k: v - before.get(k, 0) for k, v in trace.snapshot().items()
                if v != before.get(k, 0)}

    before = trace.snapshot()
    z = torch.zeros(3)
    g = step_graph._StepGraph(step, z, z, torch.zeros(5), 8,
                              dict(x=torch.zeros(2)))
    assert moved(before) == {"scan.graph.captures": 1}
    for _ in range(3):
        g.replay(z, z)
    assert moved(before) == {"scan.graph.captures": 1,
                             "scan.graph.replays": 3, counter: 6}


def test_ps_huff_table_from_the_device_cache(monkeypatch):
    """The PS row decoder's iid table comes from the per-device LUT, the
    same tensor on every call: a frame step uploads nothing (a CUDA graph
    cannot capture an upload)."""
    dev = torch.device("cpu")
    tab = ps_huff._luts(dev)[4]
    assert tab is ps_huff._luts(dev)[4]
    assert tab.tolist() == [ps_huff.IID_DF0, ps_huff.IID_DF1,
                            ps_huff.IID_DT0, ps_huff.IID_DT1]
    B = 2
    z = torch.zeros(B, dtype=torch.long)
    one = torch.ones(B, dtype=torch.long)
    args = dict(region=torch.zeros((B, ps_huff.RW), dtype=torch.long),
                start_off=z, rbits=z + 64, enable_iid=one, iq=z,
                nr_iid=z + 20, enable_icc=one, nr_icc=z + 20, enable_ext=z,
                ne_pre=one, penv=one, nipd=z, header=one)
    first = ps_huff.decode_ps_region(**args,
                                     carry=ps_huff.init_ps_carry(B, dev))

    def no_upload(*a, **kw):
        raise AssertionError("decode_ps_region made a tensor from data")

    monkeypatch.setattr(torch, "tensor", no_upload)
    again = ps_huff.decode_ps_region(**args,
                                     carry=ps_huff.init_ps_carry(B, dev))
    for a, b in zip(first[:6], again[:6]):
        assert torch.equal(a, b)
