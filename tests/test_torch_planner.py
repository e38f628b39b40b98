"""The port's Python qwire planner (heaac_tpu_torch.codec.planner and the
host writers of codec/qwire_host.py) against the JAX package's
(heaac_tpu.codec.batch.parse_stream_qwire): byte for byte on every
committed stream — each frame-lane's payload and record, rate, lanes,
PS band mode, downsampled flag, corrupt-frame count, the per-frame band
mode trail, output lanes and the AFTER_IMDCT coupling series — and on a
stream with corrupt frames.  Both planners are numpy: nothing compiles."""
import numpy as np
import pytest

from heaac_tpu.codec import batch as jbatch
from heaac_tpu.codec import qwire as jq
from heaac_tpu.ops import spec_huff as jsh
from heaac_tpu_torch.codec import planner
from heaac_tpu_torch.codec import qwire_host as QH
from heaac_tpu_torch.host import split_adts_stream
from test_torch_common import (  # noqa: F401 (autouse fixture)
    STREAM_FILES, release_jax_memory, streams_of)

KINDS = ("he20", "he34", "he_v1s", "cce_after", "cce_before", "flip",
         "flip_cce")
CASES = [(kind, i) for kind in KINDS for i in range(STREAM_FILES[kind][1])]


def _parse_both(data: bytes):
    out = []
    for fn in (jbatch.parse_stream_qwire, planner.parse_stream_qwire):
        err, trail, info = [], [], {}
        res = fn(data, err_out=err, is34_out=trail, info_out=info)
        out.append((res, err, trail, info))
    return out


def _assert_same_parse(data: bytes) -> dict:
    (jr, jerr, jtrail, jinfo), (pr, perr, ptrail, pinfo) = _parse_both(data)
    assert pr[1:] == jr[1:], "rate, lanes, is34, downsampled"
    assert (perr, ptrail, pinfo["out_nl"]) == (jerr, jtrail, jinfo["out_nl"])
    assert (pinfo["couple"] is None) == (jinfo["couple"] is None)
    if jinfo["couple"] is not None:
        assert pinfo["couple"][0] == jinfo["couple"][0]
        np.testing.assert_array_equal(pinfo["couple"][1], jinfo["couple"][1])
    assert len(pr[0]) == len(jr[0])
    nbytes = 0
    for t, (pfr, jfr) in enumerate(zip(pr[0], jr[0])):
        assert len(pfr) == len(jfr), f"frame {t}"
        for ln, ((pp, prec), (jp, jrec)) in enumerate(zip(pfr, jfr)):
            assert pp == jp, f"frame {t} lane {ln} payload"
            np.testing.assert_array_equal(prec, jrec, f"frame {t} lane {ln}")
            nbytes += len(pp)
    return dict(frames=len(pr[0]), nbytes=nbytes, trail=ptrail,
                err=perr[0], couple=pinfo["couple"])


@pytest.mark.parametrize("kind,i", CASES)
def test_planner_matches_jax_byte_for_byte(kind, i):
    data = streams_of(kind, i + 1)[i]
    r = _assert_same_parse(data)
    assert r["frames"] == 50 and r["err"] == 0 and r["nbytes"] > 0
    assert (r["couple"] is not None) == (kind in ("cce_after", "flip_cce"))
    flips = sum(a != b for a, b in zip(r["trail"], r["trail"][1:]))
    assert flips == (0 if not kind.startswith("flip")
                     else 1 + (kind == "flip" and i % 4 >= 2))


def test_planner_matches_jax_on_corrupt_frames():
    """Frames with scrambled payloads: per-frame error isolation (silence
    lanes, the error count) and the state after them."""
    frames = split_adts_stream(streams_of("flip", 3)[2])[:14]
    rng = np.random.default_rng(3)
    for f in (3, 8):
        b = bytearray(frames[f])
        b[9:40] = rng.integers(0, 256, 31).astype(np.uint8).tobytes()
        frames[f] = bytes(b)
    r = _assert_same_parse(b"".join(frames))
    assert r["err"] > 0 and r["frames"] == 14


def test_spec_writers_match_jax():
    """BitWriter + encode_section (every codebook, escapes included),
    pack_spec_block with an M/S mask and short-window grouping,
    concat_bit_ranges and extract_bits: the same bytes."""
    rng = np.random.default_rng(9)
    for cb in range(1, 12):
        dim, lav, signed = QH.TB.CODEBOOK_INFO[cb]
        hi = 300 if cb == 11 else lav
        q = rng.integers(-hi, hi + 1, 8 * dim)
        if not signed:
            q = np.where(np.abs(q) > hi, 0, q)
        pw, jw = QH.BitWriter(), jsh.BitWriter()
        QH.encode_section(pw, cb, q)
        jsh.encode_section(jw, cb, q)
        assert pw.tobytes() == jw.tobytes(), cb
    secs = [(1, 3, 40), (11, 5, 900), (0, 2, 0)]
    raw = rng.integers(0, 256, 130).astype(np.uint8).tobytes()
    kw = dict(ms_mask=[1, 0, 1, 1, 0, 0, 1, 0, 1, 1], grouping=0x5A, phase=5)
    assert QH.pack_spec_block(secs, 77, raw, 940, **kw) == \
        jsh.pack_spec_block(secs, 77, raw, 940, **kw)
    ranges = [(3, 17), (40, 41), (100, 131), (1030, 1050)]
    assert QH.concat_bit_ranges(raw, ranges) == \
        jsh.concat_bit_ranges(raw, ranges)
    assert QH.extract_bits(raw, 13, 77) == jq.extract_bits(raw, 13, 77)
    assert QH.pack_nibbles([1, 15, 7]) == jq.pack_nibbles([1, 15, 7])
    for sf in (-QH.pow2sf_tab()[130], 0.37):
        assert QH.sfidx_from_sf(sf) == jq.sfidx_from_sf(sf)


def test_planner_matches_jax_on_a_layout_change():
    """A coupling channel element that appears at frame 3 (the PCE before
    it declares none): both planners realign every frame onto the union
    lane layout (_align_union_layout)."""
    from heaac_tpu.bitstream.aac_syntax import T as TT
    from heaac_tpu.io.heaac_testgen import (SbrStreamWriter,
                                            splice_cce_into_lc,
                                            splice_sbr_multi)
    core = b"".join(split_adts_stream(streams_of("lc", 1)[0])[:8])
    cce = splice_cce_into_lc(core, coupling_point="after", start_frame=3)
    w = SbrStreamWriter(core_rate=24000, is_cpe=False, env_hi_shift=-12,
                        seed=3, invf_modes=(0,))
    r = _assert_same_parse(splice_sbr_multi(cce, {(TT.TYPE_SCE, 0): w}))
    assert r["frames"] == 8 and r["couple"] is not None
