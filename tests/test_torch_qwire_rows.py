"""The qwire step's row decoders (``ops/qwire_rows.py``) on the CPU: for
CPU tensors ``decode_rows`` is the two plain decoders, unchanged, under
one ``qwire_rows`` span and with no launch counted; any other device
than the CPU or a card raises; the kernel's argument struct and tables
match what the wrapper passes; and the kernel's source, built by g++
against a stand-in for the CUDA runtime (its launch run as a loop over
blocks and threads), equals the plain decoders on fuzzed regions.  The
CUDA kernel itself is held to the plain decoders on the card
(tests/test_torch_gpu.py)."""
import ctypes
import re
import subprocess

import numpy as np
import pytest
import torch

from heaac_tpu_torch import tables as TB
from heaac_tpu_torch.ops import ps_huff, qwire_rows, sbr_huff
from heaac_tpu_torch.utils import trace
from test_torch_common import leaves, row_decoder_inputs


@pytest.mark.parametrize("pair,wild", [(False, False), (True, False),
                                       (False, True), (True, True)],
                         ids=["sbr", "pair", "sbr-wild", "pair-wild"])
def test_decode_rows_on_cpu_is_the_plain_decoders(pair, wild):
    sbr, ps = row_decoder_inputs(8, seed=10 + 2 * pair + wild, pair=pair,
                                 wild=wild)
    before = dict(qwire_rows.launches)
    with trace.recording() as rec:
        got = qwire_rows.decode_rows(sbr, ps, pair)
    want = (sbr_huff.decode_sbr_rows(**sbr, pair=pair),
            ps_huff.decode_ps_region(**ps))
    assert len(leaves(got)) == len(leaves(want)) == 21
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert [(s.name, s.attrs) for s in rec.spans] == [
        ("qwire_rows", {"pair": int(pair)})]
    assert qwire_rows.launches == before
    # the fuzzed rows reach both outcomes of the row checks
    assert 0 < int(got[0][4].sum()) < 8 or 0 < int(got[1][5].sum()) < 8


def test_decode_rows_raises_on_an_unsupported_device():
    sbr, ps = row_decoder_inputs(2, seed=0, pair=False, device="meta")
    with pytest.raises(ValueError, match="unsupported device meta"):
        qwire_rows.decode_rows(sbr, ps, False)


def test_rows_args_are_the_kernel_struct():
    """The ctypes struct the wrapper fills has the CUDA struct's fields in
    the CUDA struct's order, every one a pointer; each output has its
    shape, and the inputs are exactly the decoders' tensor arguments."""
    src = open(qwire_rows.SRC).read()
    body = re.search(r"struct RowsArgs \{(.*?)\n\};", src, re.S).group(1)
    fields = re.findall(r"^\s*(?:const )?\w+\* (\w+);", body, re.M)
    assert len(fields) == len(re.findall(r";", body))
    assert fields == qwire_rows.FIELDS
    assert [f for f, _ in qwire_rows.RowsArgs._fields_] == fields
    assert set(qwire_rows.LUTS) <= set(fields)
    sbr, ps = row_decoder_inputs(1, seed=0, pair=True)
    assert set(qwire_rows.SBR_IN) | {"carry"} == set(sbr)
    assert set(qwire_rows.PS_IN) | {"carry"} == set(ps)
    assert set(qwire_rows.SBR_CARRY) == set(sbr["carry"])
    assert set(qwire_rows.PS_CARRY) == set(ps["carry"])


def test_kernel_tables_are_the_plain_decoders():
    """The kernel's LUTs hold the plain decoders' values in narrower
    types, and are made once per device; a prefix-table entry is the
    flat LUT's entry at every window under its prefix, and the entries it
    leaves to the flat LUT are codes longer than the prefix, or none."""
    dev = torch.device("cpu")
    luts = qwire_rows._luts(dev)
    assert luts is qwire_rows._luts(dev)
    assert {luts[k].dtype for k in ("sbr_flat", "ps_flat", "sbr_prefix",
                                    "ps_prefix")} == {torch.int16}
    plain = dict(zip(("sbr_flat", "sbr_bases", "sbr_maxlens", "sbr_lav"),
                     sbr_huff._luts(dev)))
    ps_plain = ps_huff._luts(dev)
    plain.update(ps_flat=ps_plain[0], ps_bases=ps_plain[1],
                 ps_maxlens=ps_plain[2], ps_offsets=ps_plain[3],
                 ps_iid_tabsel=ps_plain[4])
    assert set(plain) | {"sbr_prefix", "ps_prefix"} == set(luts)
    for k, v in plain.items():
        assert torch.equal(luts[k].long(), v), k
    P = qwire_rows.PREFIX_BITS
    for kind, (flat, bases, maxlens, *_) in (("sbr", TB.sbr_huff_luts()),
                                             ("ps", TB.ps_huff_luts())):
        pre = luts[f"{kind}_prefix"].long().reshape(len(bases), 1 << P)
        resolved = 0
        for t, (base, ml) in enumerate(zip(bases, maxlens)):
            pb = min(P, int(ml))
            block = flat[base:base + (1 << ml)].astype(np.int64).reshape(
                1 << pb, -1)
            row = pre[t].numpy()
            assert (row[1 << pb:] == -1).all()
            hit = row[:1 << pb] >= 0
            assert (block[hit] == row[:1 << pb][hit, None]).all()
            assert ((block[~hit, 0] & 31) > pb).all()
            resolved += int(hit.sum())
        assert resolved > 0


# what the kernel's source needs of the CUDA runtime, for a host build
CUDA_STANDIN = """
#define __global__
#define __device__
#define __forceinline__ inline
#define __launch_bounds__(x)
struct Dim3 { unsigned x, y, z; };
static Dim3 threadIdx, blockIdx;
typedef void* cudaStream_t;
inline int cudaGetLastError() { return 0; }
template <class T> inline T __ldg(const T* p) { return *p; }
"""


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel's source as a host library: each block's threads run
    one after another (each thread touches only its own lane's memory,
    and the kernel has no shared memory or barrier)."""
    d = tmp_path_factory.mktemp("qwire_rows_host")
    (d / "cuda_runtime.h").write_text(CUDA_STANDIN)
    src, n = re.subn(
        r"qwire_rows_kernel<<<(.*?),\s*2 \* kLanes, 0,\s*"
        r"\(cudaStream_t\)stream>>>\(\*a, B, pair\);",
        r"for (unsigned bx = 0; bx < (unsigned)(\1); ++bx)"
        r" for (unsigned tx = 0; tx < 2 * kLanes; ++tx) {"
        r" blockIdx.x = bx; threadIdx.x = tx;"
        r" qwire_rows_kernel(*a, B, pair); }",
        open(qwire_rows.SRC).read(), flags=re.S)
    assert n == 1
    (d / "k.cc").write_text(src)
    subprocess.run(["g++", "-O2", "-std=c++17", "-shared", "-fPIC",
                    "-Wno-unknown-pragmas", f"-I{d}", str(d / "k.cc"), "-o",
                    str(d / "k.so")], check=True)
    lib = ctypes.CDLL(str(d / "k.so"))
    lib.qwire_rows_launch.restype = ctypes.c_int
    lib.qwire_rows_launch.argtypes = [ctypes.POINTER(qwire_rows.RowsArgs),
                                      ctypes.c_int, ctypes.c_int,
                                      ctypes.c_void_p]
    return lib


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("pair,wild", [(False, False), (True, False),
                                       (False, True), (True, True)],
                         ids=["sbr", "pair", "sbr-wild", "pair-wild"])
def test_kernel_source_on_the_host_is_the_plain_decoders(host_kernel, pair,
                                                          wild, seed,
                                                          monkeypatch):
    """``decode_rows``' CUDA route on CPU tensors, with the host build in
    place of the card's library: every output equal to the plain
    decoders', bit for bit, on fuzzed regions at 64 lanes (two
    blocks)."""
    monkeypatch.setattr(qwire_rows, "_lib", lambda: host_kernel)
    monkeypatch.setattr(torch.cuda, "device", lambda dev: trace.NO_SPAN)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev: type("S", (), {"cuda_stream": 0}))
    sbr, ps = row_decoder_inputs(64, seed=1000 + 10 * seed + 2 * pair + wild,
                                 pair=pair, wild=wild)
    want = qwire_rows.decode_rows_plain(sbr, ps, pair)
    before = dict(qwire_rows.launches)
    got = qwire_rows._launch(sbr, ps, pair, torch.device("cpu"))
    assert qwire_rows.launches == {**before, pair: before[pair] + 1}
    for a, b in zip(leaves(got), leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
