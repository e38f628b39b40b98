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


def row_decoder_inputs(B: int, seed: int, pair: bool, device="cpu",
                       wild: bool = False):
    """Fuzzed arguments of ``ops/qwire_rows.decode_rows`` -> (sbr, ps):
    random region bytes (dense, sparse, or runs of ones, so that rows
    decode, overrun their windows and meet codes that are not in a
    table), control fields drawn as tests/test_torch_sbr_huff.py and
    tests/test_torch_ps_huff.py draw them, and random carries; ``wild``
    widens the controls to every value the wire's bit fields can hold
    (ne 0-7, nnoise 0-3, bands 0-60, ...)."""
    rng = np.random.default_rng(seed)
    i = lambda lo, hi: rng.integers(lo, hi + 1, B)  # noqa: E731
    pick = lambda vals: rng.choice(vals, B)  # noqa: E731

    def region(nbytes):
        kind = rng.integers(0, 3)
        r = rng.integers(0, 256, (B, nbytes))
        if kind == 1:
            r = r * (rng.random((B, nbytes)) < 0.1)
        elif kind == 2:
            r = np.full((B, nbytes), 255) * (rng.random((B, nbytes)) < 0.5)
        return r

    n0 = i(1, 25)
    sbr = dict(phase=i(0, 7), rbits=i(0, 8191) if wild else i(0, 640 * 8),
               ne=i(0, 7) if wild else i(0, 5),
               nnoise=i(0, 3) if wild else i(1, 2), frbits=i(0, 31),
               n0=i(0, 60) if wild else n0,
               n1=i(0, 60) if wild else np.minimum(n0 * 2 - i(0, 1), 48),
               nq=i(0, 7) if wild else i(1, 5), ampres=i(0, 1),
               coupled=(rng.random(B) < 0.6) * int(pair),
               region=region(640))
    sbr = {k: t(v) for k, v in sbr.items()}
    sbr["active"] = t(rng.random(B) < 0.8, torch.bool)
    sbr["carry"] = dict(env_last=t(rng.integers(0, 60, (B, 2, 48))),
                        noise_last=t(rng.integers(0, 30, (B, 2, 5))),
                        fr_last=t(rng.integers(0, 2, (B, 2))))
    widths = [0, 10, 20, 34] if wild else [10, 20, 34]
    ne_pre = i(0, 7) if wild else i(0, 4)
    ps = dict(start_off=i(0, 7), rbits=i(0, 4095) if wild else i(0, 288 * 8),
              enable_iid=i(0, 1), iq=i(0, 1), nr_iid=pick(widths),
              enable_icc=i(0, 1), nr_icc=pick(widths), enable_ext=i(0, 1),
              ne_pre=ne_pre,
              penv=i(0, 7) if wild else np.minimum(ne_pre + i(0, 1), 5),
              nipd=pick([0, 5, 11, 17] if wild else [5, 11, 17]),
              header=i(0, 1), region=region(288))
    ps = {k: t(v) for k, v in ps.items()}
    ps["carry"] = dict(
        iid_last=t(rng.integers(-15, 16, (B, 34))),
        icc_last=t(rng.integers(0, 8, (B, 34))),
        ipd_full=t(rng.integers(0, 8, (B, 5, 17))),
        opd_full=t(rng.integers(0, 8, (B, 5, 17))),
        pd_enable=t(i(-1, 3) if wild else i(0, 1)),
        penv_prev=t(i(-2, 8) if wild else i(0, 5)), ps_ok=t(i(0, 1)))
    move = lambda d: {k: move(v) if isinstance(v, dict)  # noqa: E731
                      else v.to(device) for k, v in d.items()}
    return move(sbr), move(ps)


def leaves(tree) -> list:
    """The tensors of nested tuples / dicts, in order."""
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in leaves(v)]
    if isinstance(tree, (tuple, list)):
        return [x for v in tree for x in leaves(v)]
    return [tree]


def lanes(tree, idx):
    """A nested dict of [B, ...] tensors at lanes ``idx``."""
    if isinstance(tree, dict):
        return {k: lanes(v, idx) for k, v in tree.items()}
    return tree.index_select(0, idx)
