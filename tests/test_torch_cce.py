"""Coupling channel elements in the PyTorch port against the JAX package:
the output lanes the port reads from a program config element against
``parse_pce_layout``; the AFTER_IMDCT coupling mix, duplicate targets
included, against the JAX scan's expression
(heaac_tpu/codec/heaac_graph.py, qwire_scan_decoder_couple); and the
coupling edges and gains the port's QwirePipelinedDecoder collects per
stream group against the JAX decoder's, over the committed CCE streams
(tools/make_torch_streams.py)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from heaac_tpu.bitstream.aac_syntax import T as TT
from heaac_tpu.bitstream.aac_syntax import parse_pce_layout
from heaac_tpu.bitstream.reader import BitReader
from heaac_tpu.codec.batch import QwirePipelinedDecoder as JaxDecoder
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
from heaac_tpu_torch.host import pce_lanes, split_adts_stream
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, n, release_jax_memory, streams_of, t)


def _jax_pce_lanes(frame: bytes) -> tuple:
    """(output lanes, CCE lanes) of the PCE that opens ``frame``'s raw
    data block, by the JAX package's parser."""
    br = BitReader(frame)
    br.skip(56 if frame[1] & 1 else 72)
    while True:
        elem = br.get(3)
        if elem == TT.TYPE_PCE:
            break
        if elem == TT.TYPE_FIL:
            cnt = br.get(4)
            if cnt == 15:
                cnt += br.get(8) - 1
            br.skip(8 * cnt)
        else:
            assert elem == TT.TYPE_DSE
            br.get(4)
            align, cnt = br.get1(), br.get(8)
            if cnt == 255:
                cnt += br.get(8)
            if align:
                br.align()
            br.skip(8 * cnt)
    br.get(4)                               # element tag
    lay = parse_pce_layout(br)
    out = sum(2 if et == TT.TYPE_CPE else 1
              for g in ("front", "side", "back") for et, _ in lay[g])
    return out + len(lay["lfe"]), len(lay["cc"])


def _synthetic_pce_frame() -> bytes:
    """An ADTS frame (with CRC) whose raw data block leads with a FIL and
    a byte-aligned DSE, then a PCE of front CPE + SCE, a side CPE, a back
    SCE, one LFE, one associated data element, two coupling channels and
    every mixdown flag set."""
    fields = [(3, 6), (4, 2), (16, 0xA5A5),                  # FIL, 2 bytes
              (3, 4), (4, 1), (1, 1), (8, 1)]                # DSE, aligned
    bits = sum(b for b, _ in fields)
    fields.append((-bits % 8, 0))
    fields += [(8, 0x5A),
               (3, 5), (4, 0), (2, 1), (4, 3),               # PCE head
               (4, 2), (4, 1), (4, 1), (2, 1), (3, 1), (4, 2),
               (1, 1), (4, 0), (1, 1), (4, 0), (1, 1), (3, 0),
               (1, 1), (4, 0), (1, 0), (4, 1),               # front
               (1, 1), (4, 1), (1, 0), (4, 2),               # side, back
               (4, 0), (4, 0),                               # lfe, assoc
               (1, 0), (4, 0), (1, 1), (4, 1)]               # cc
    bits = sum(b for b, _ in fields)
    fields += [(-bits % 8, 0), (8, 0), (3, 7)]               # comment, END
    word, nb = 0, 0
    for b, v in fields:
        word, nb = (word << b) | v, nb + b
    word <<= -nb % 8
    body = word.to_bytes((nb + 7) // 8, "big")
    flen = 9 + len(body)
    hdr = bytes([0xFF, 0xF0, 0x58, 0x00 | (flen >> 11), (flen >> 3) & 0xFF,
                 ((flen & 7) << 5) | 0x1F, 0xFC, 0, 0])
    return hdr + body


@pytest.mark.parametrize("name", ["cce_after_0", "cce_after_1",
                                  "cce_before_0", "cce_before_1",
                                  "synthetic"])
def test_pce_lanes_match_parse_pce_layout(name):
    if name == "synthetic":
        frame = _synthetic_pce_frame()
        want = (7, 2)
    else:
        kind, j = name.rsplit("_", 1)
        frame = split_adts_stream(streams_of(kind, 2)[int(j)])[0]
        want = (1, 1)
    assert _jax_pce_lanes(frame) == want
    assert pce_lanes(frame) == want


def test_pce_lanes_raise_without_a_leading_pce():
    frame = split_adts_stream(streams_of("he_v1s", 1)[0])[0]   # a CPE
    with pytest.raises(NotImplementedError):
        pce_lanes(frame)


def test_couple_mix_matches_jax_with_duplicate_targets():
    """Two edges onto one (lane, channel), a target that is also another
    edge's source, and both sub-channels of one lane."""
    rng = np.random.default_rng(11)
    T, L, N = 3, 6, 64
    pcm = (rng.standard_normal((T, L, 2, N)) * 8000).astype(np.float32)
    etgt = np.array([0, 0, 3, 2, 0, 3])
    etch = np.array([0, 0, 1, 0, 1, 0])
    esrc = np.array([5, 4, 5, 0, 5, 0])
    gains = rng.standard_normal((T, len(etgt))).astype(np.float32)
    jp, jg_ = jnp.asarray(pcm), jnp.asarray(gains)
    add = jg_[:, :, None] * jp[:, jnp.asarray(esrc), 0]
    want = jp.at[:, jnp.asarray(etgt), jnp.asarray(etch)].add(add)
    got = heaac_graph.couple_mix(t(pcm), t(etgt), t(etch), t(esrc),
                                 t(gains))
    assert_peak_close(got, want, 1e-6, "pcm")
    # the duplicate pair adds both edges, from the sources' old values
    np.testing.assert_allclose(
        n(got)[:, 0, 0], pcm[:, 0, 0] + gains[:, :1] * pcm[:, 5, 0]
        + gains[:, 1:2] * pcm[:, 4, 0], rtol=1e-6, atol=1e-2)
    assert not np.array_equal(n(got)[:, 0, 0], pcm[:, 0, 0])


def test_coupling_edges_match_jax_decoder():
    """A group of an AFTER_IMDCT stream, a dependent-coupling stream (no
    edges) and another AFTER_IMDCT stream, 8 frames: the port's group
    edges and gains equal the JAX QwirePipelinedDecoder's, with the
    second stream's lanes free of the first's gains."""
    streams = [streams_of("cce_after", 1)[0], streams_of("cce_before", 1)[0],
               streams_of("cce_after", 2)[1]]
    T = 8
    jd = JaxDecoder(streams, group_streams=3, max_frames=T)
    while jd._parse_group(streams, 0, T) is None:
        jd._grow()
    pd = QwirePipelinedDecoder(streams, group_streams=3, max_frames=T,
                               device="cpu")
    while (r := pd._parse_group(streams, 0, T)) is None:
        pd._grow()
    assert (pd.nl, pd.out_nl) == (2, 1) == (jd.nl, jd.out_nl)
    got, want = r[3], jd._cur_couple
    assert got is not None and len(got[0]) == 2
    for k, name in enumerate(("etgt", "etch", "esrc", "gains")):
        np.testing.assert_array_equal(got[k], want[k], err_msg=name)
    assert set(got[0]) == {0, 4} and set(got[2]) == {1, 5}
    assert np.abs(got[3]).min() > 0


def test_couple_scan_on_cpu_couples():
    """decode through the coupling scan: the AFTER_IMDCT stream's output
    lane differs from the same decode with its edges' gains zeroed."""
    data = [b"".join(split_adts_stream(streams_of("cce_after", 1)[0])[:4])]
    dec = QwirePipelinedDecoder(data, group_streams=1, device="cpu")
    coupled = dec.decode()[0]
    cur, Tg, sa, couple = dec._parse_with_retry(0)
    heap_d, recs_d, couple_d = dec._upload(0, cur, Tg, couple)
    etgt, etch, esrc, gains = couple_d
    plain = dec._scan(heap_d, recs_d, sa,
                      (etgt, etch, esrc, torch.zeros_like(gains)))
    assert coupled.dtype == plain.dtype == torch.int16
    d = (coupled[:, 0, 0].int() - plain[:, 0, 0].int()).abs()
    assert int(d.max()) > 100
    assert torch.equal(coupled[:, 0, 1], plain[:, 0, 1])
