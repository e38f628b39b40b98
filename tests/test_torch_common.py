"""Shared helpers of the PyTorch-port parity tests (no tests here).

Inputs are made with numpy (from a seed, or parsed from the bundled
benchdata streams) and handed to both the JAX function and its port.
"""
import ctypes
import functools
import gc
import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _drop_compiled_jax():
    jax = sys.modules.get("jax")
    if jax is not None:
        jax.clear_caches()
    gc.collect()
    ctypes.CDLL("libc.so.6").malloc_trim(0)


@pytest.fixture(autouse=True, scope="module")
def release_jax_memory():
    """Drop compiled XLA:CPU executables before and after each parity
    module (import this fixture into the module). The reference graphs
    these modules compile take a few GB, and a pytest-xdist worker keeps
    every executable it has compiled until it exits; without this the
    whole suite's workers can outgrow the host's memory.  While the
    module runs, torch computes on one intra-op thread: each worker
    would otherwise start a thread per core for the port's small
    tensors, and six workers doing so oversubscribe the host (on an
    8-core CPU host at -n 6 the port's tests took 541 worker-s that way
    and 287 with this fixture)."""
    _drop_compiled_jax()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
    _drop_compiled_jax()


@functools.cache
def jit_ref(fn, **static):
    """``jax.jit`` of a JAX reference function with its static keyword
    arguments bound.  One XLA compile per function and input shapes,
    where calling it eagerly compiles every primitive on its own (several
    times slower, and each compile is too short for the persistent
    compilation cache that tests/conftest.py sets up to keep)."""
    import jax
    return jax.jit(functools.partial(fn, **static))


def golden_tool():
    """tools/make_torch_golden.py as a module: the goldens' file names,
    the mixed decode_batch list and the JAX writers (which import the
    JAX package only when called)."""
    spec = importlib.util.spec_from_file_location(
        "make_torch_golden", os.path.join(REPO, "tools",
                                          "make_torch_golden.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the bundled streams by kind: 20-band HE-AAC v2 (benchdata), 34-band
# HE-AAC v2, stereo HE-AAC v1, HE-AAC with a coupling channel applied
# after the IMDCT or before TNS, HE-AAC v2 whose PS band mode flips
# mid-stream, alone or with an AFTER_IMDCT coupling channel
# (tools/make_torch_streams.py), and the AAC-LC cores; (file pattern,
# number of files)
STREAM_FILES = {
    "he20": ("benchdata/heaac_bench_stream_{}.aac", 8),
    "he34": ("tests/data/heaac_v2_34band_{}.aac", 8),
    "he_v1s": ("tests/data/heaac_v1_stereo_{}.aac", 8),
    "cce_after": ("tests/data/heaac_cce_after_{}.aac", 2),
    "cce_before": ("tests/data/heaac_cce_before_{}.aac", 2),
    "lc": ("benchdata/lc_core_24k_{}.aac", 8),
    "flip": ("tests/data/heaac_v2_flip_{}.aac", 8),
    "flip_cce": ("tests/data/heaac_flip_cce_{}.aac", 1),
}


def streams_of(kind: str, n: int) -> list:
    """Streams 0..n-1 (modulo the number of files) of one kind, as
    bytes."""
    pat, files = STREAM_FILES[kind]
    return [open(os.path.join(REPO, pat.format(i % files)), "rb").read()
            for i in range(n)]


def bench_streams(n: int) -> list:
    return streams_of("he20", n)


@functools.cache
def port_parse(n: int, T: int, kind: str = "he20") -> dict:
    """Native parse of streams 0..n-1 of an HE kind (first T frames)
    through the port: heap bytes, records [T, n, 4], the static decode
    sizes and the PS band mode."""
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    streams = streams_of(kind, n)
    dec = QwirePipelinedDecoder(streams, group_streams=n, max_frames=T,
                                device="cpu")
    heap, cur, recs, _ = dec._parse_group(streams, 0, T)
    return dict(heap=heap[:cur + 4096].copy(), recs=recs[:T].copy(),
                S=dec.S, NB=dec.NB, MS=dec.MS, NS=dec.NS, SEC=dec.SEC,
                RP=dec.RP, rate_idx=dec.rate_idx, is34=dec.is34)


def t(a, dtype=None):
    """numpy -> CPU tensor: floats as float32, integers as int64."""
    a = np.asarray(a)
    if dtype is None:
        dtype = torch.float32 if a.dtype.kind == "f" else torch.int64
    return torch.from_numpy(np.array(a)).to(dtype)


def n(x):
    """tensor / jax array / nested dict -> numpy."""
    if isinstance(x, dict):
        return {k: n(v) for k, v in x.items()}
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def assert_exact(got, want, what="", float_rtol: float = 0.0):
    """Integers exactly; floats exactly, or within ``float_rtol`` of each
    element where the caller states one."""
    got, want = n(got), n(want)
    if isinstance(want, dict):
        assert set(got) == set(want), what
        for k in want:
            assert_exact(got[k], want[k], f"{what}.{k}", float_rtol)
        return
    assert got.shape == want.shape, (what, got.shape, want.shape)
    if want.dtype.kind == "f":
        np.testing.assert_allclose(got.astype(np.float32),
                                   want.astype(np.float32), rtol=float_rtol,
                                   atol=0, err_msg=what)
    else:
        np.testing.assert_array_equal(got.astype(np.int64),
                                      want.astype(np.int64), err_msg=what)


def assert_peak_close(got, want, rel: float, what=""):
    """max |got - want| <= rel * max |want| (float stages: the two
    frameworks sum in different orders)."""
    got = n(got).astype(np.float64)
    want = n(want).astype(np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    peak = max(np.abs(want).max(), 1e-30)
    err = np.abs(got - want).max()
    assert err <= rel * peak, f"{what}: max diff {err} > {rel} x peak {peak}"


def assert_tree_close(got, want, rel: float, what=""):
    """Nested dicts / tuples of arrays (decode carries): the same keys,
    integers exactly, floats within ``rel`` of each tensor's peak."""
    if isinstance(want, (dict, tuple)):
        keys = want.keys() if isinstance(want, dict) else range(len(want))
        if isinstance(want, dict):
            assert set(got) == set(want), what
        assert len(got) == len(want), what
        for k in keys:
            assert_tree_close(got[k], want[k], rel, f"{what}.{k}")
    elif n(want).dtype.kind == "f":
        assert_peak_close(got, want, rel, what)
    else:
        assert_exact(got, want, what)


@functools.cache
def port_trace(n_streams: int, T: int, kind: str = "he20"):
    """Per-frame port expansion of real streams: list of dicts of numpy
    dicts (core_meta, plan, pc, ps_plan), one per frame."""
    from heaac_tpu_torch.codec import compact_plan, qwire
    p = port_parse(n_streams, T, kind)
    heap = t(p["heap"])
    recs = t(p["recs"])
    qc = qwire.init_qcarry(n_streams, "cpu")
    ph = compact_plan.init_ps_hist(n_streams, "cpu")
    frames = []
    for f in range(T):
        core_meta, plan, pc, qc = qwire.expand_frame(heap, recs[f], qc,
                                                     p["is34"])
        ps_plan, ph = compact_plan.expand_ps(pc, ph, p["is34"])
        frames.append(dict(core_meta=n(core_meta), plan=n(plan), pc=n(pc),
                           ps_plan=n(ps_plan)))
    return frames
