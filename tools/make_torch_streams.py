#!/usr/bin/env python
"""Write the 34-band HE-AAC v2 test streams of the PyTorch port.

    JAX_PLATFORMS=cpu python tools/make_torch_streams.py [out_dir]

Splices SBR + 34-band parametric stereo into the bundled LC cores
(benchdata/lc_core_24k_{i}.aac, 24 kHz mono, 50 frames) the way bench.py
makes its distinct streams (its writer seeds), and writes
tests/data/heaac_v2_34band_{i}.aac for i in 0..7 (48 kHz stereo out).

The SBR data signals no inverse filtering (invf_mode 0).  The cores are
tonal, so a whitened patch (invf_mode 2 or 3) is the small residual of a
nearly exact two-tap prediction, which the envelope gains then scale up
to full energy: its float32 rounding reaches the PCM.  On such streams
the JAX decoder's own jitted and eager runs of one frame differ by
several int16 LSB, so a 2 LSB check would measure the reference's
rounding, not the port (tools/torch_ref_noise.py measures both).  The
inverse filter is exercised by the 20-band bench streams (invf_mode
0..3) and tests/test_torch_sbr.py.

PS runs at iid_mode / icc_mode 2 (34 bands, coarse IID quantisation);
stream 1 uses iid_mode 5 (fine quantisation), stream 2 enables IPD/OPD,
stream 3 both.  Each stream is
checked with the native probe (is34 = 1).  The streams are committed:
chip_smoke.py and the tests read them as files.
"""
import functools
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(REPO, "tests", "data")
N = 8
# PS bytes per frame: 34-band parameters drawn at random can fill the FIL
# element's 269 bytes alone, leaving no room for the SBR data beside them;
# the writer re-draws any frame above this bound
PS_MAX_BYTES = 160
# (iid_mode, enable_ipdopd) per stream; icc_mode is 2 throughout
MODES = {1: (5, False), 2: (2, True), 3: (5, True)}
INVF_MODES = (0,)      # SBR inverse filtering: none (see above)


def make_stream(i: int, invf_modes=INVF_MODES) -> bytes:
    from heaac_tpu.io.heaac_testgen import (PsStreamWriter, SbrStreamWriter,
                                            splice_sbr_into_lc)
    core = open(os.path.join(REPO, "benchdata", f"lc_core_24k_{i}.aac"),
                "rb").read()
    iid_mode, ipdopd = MODES.get(i, (2, False))
    for tries in range(8):
        # a rare parameter draw overflows the single-FIL payload bound
        # (269 bytes); re-draw deterministically, as bench.py does
        try:
            ps = PsStreamWriter(seed=2000 + 5 * i,
                                iid_mode=iid_mode, icc_mode=2,
                                enable_ipdopd=ipdopd)
            ps.ps_payload = functools.partial(
                PsStreamWriter.ps_payload, ps, max_bytes=PS_MAX_BYTES)
            w = SbrStreamWriter(
                core_rate=24000, is_cpe=False, env_hi_shift=-12,
                seed=1000 + 7 * i + 1000003 * tries,
                invf_modes=invf_modes, ps_writer=ps)
            return splice_sbr_into_lc(core, w)
        except AssertionError:
            continue
    raise RuntimeError(f"stream {i}: could not fit the FIL payload")


def main() -> None:
    sys.path.insert(0, REPO)
    from heaac_tpu import native
    from heaac_tpu.bitstream.adts import parse_adts_header
    from heaac_tpu.bitstream.reader import BitReader
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)
    for i in range(N):
        data = make_stream(i)
        h = parse_adts_header(BitReader(data[:7]))
        p = native.probe_he_stream(data, h.sampling_index, h.sample_rate,
                                   h.chan_config)
        if p is None or (p["sbr"], p["is34"]) != (1, 1):
            raise SystemExit(f"stream {i}: probe gave {p}, expected SBR "
                             "with 34-band PS")
        path = os.path.join(out, f"heaac_v2_34band_{i}.aac")
        with open(path, "wb") as f:
            f.write(data)
        print(f"wrote {path}: {len(data)} bytes, probe {p}")


if __name__ == "__main__":
    main()
