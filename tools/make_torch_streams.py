#!/usr/bin/env python
"""Write the test streams of the PyTorch port.

    python tools/make_torch_streams.py [out_dir [kind ...]]

Every stream is made here from the port's own encoder and SBR / PS / CCE
splicers (``heaac_tpu_torch.codec.encoder``,
``heaac_tpu_torch.io.heaac_testgen``: no downloaded data, no jax, so it
runs on a machine without jax too), all written to tests/data (or
out_dir) and committed: chip_smoke.py and the tests read them as files.  With
kinds (he34, stereo, cce, flip, lc_cce, ds) only those are written;
every stream is deterministic, so a rerun rewrites each byte for byte.

heaac_v2_34band_{i}.aac, i in 0..7 (48 kHz stereo out): SBR + 34-band
parametric stereo spliced into the bundled LC cores
(benchdata/lc_core_24k_{i}.aac, 24 kHz mono, 50 frames) by the port's
distinct-stream recipe (``heaac_testgen.distinct_stream``: bench.py's
writer seeds), each PS payload at most PS_MAX_BYTES.  PS runs at iid_mode /
icc_mode 2 (34 bands, coarse IID quantisation); stream 1 uses iid_mode 5
(fine quantisation), stream 2 enables IPD/OPD, stream 3 both.  Checked
with the native probe (is34 = 1).

heaac_v1_stereo_{i}.aac, i in 0..7 (48 kHz stereo out, 50 frames): stereo
HE-AAC v1.  The core is the encoder's 64 kb/s 24 kHz CPE with M/S stereo
over a seeded two-channel signal; odd streams switch windows on added
transients, so EIGHT_SHORT M/S pairs occur.  The SBR is a coupled CPE
(balance-coded second channel).  Checked with the port's native probe
(SBR, 2 lanes) and its parse: device M/S (MS = 1) and coupled raw SBR
rows (rows_pair = 1) on every stream, short-window M/S lanes on the odd
ones, and none of the frame shape the JAX package decodes wrongly (an
uncoupled byte-mode SBR frame after a raw-rows frame on one CPE).

heaac_cce_{after,before}_{j}.aac, j in 0..1: a mono HE-AAC v1 stream
(24 kHz core, benchdata/lc_core_24k_{j}.aac) in a PCE layout (channel
configuration 0) with a coupling channel element each frame, applied
after the IMDCT ("after": independent coupling, mixed at the output
rate) or before TNS ("before": dependent coupling, which the native
parser applies on the host).  Checked with the port's parse: 2 lanes
(the output SCE, then the CCE lane), one output lane from the PCE, and
coupling edges on the "after" streams only.  Stream 1's SBR writer is
seeded 514, not 513: with 513 one band of frame 2 asks a gain of
3.6e4 of a nearly empty patch, which scales f32 rounding of the patch
(1e-7 of its peak) up to 2.7 LSB between the port and JAX (JAX jitted
against eager: 0 LSB); seeds 514-517 give 1 LSB over all 50 frames.

heaac_v2_flip_{i}.aac, i in 0..7 (48 kHz stereo out, 50 frames): HE-AAC
v2 whose PS band mode flips mid-stream, SBR + PS spliced into core
benchdata/lc_core_24k_{i}.aac with the PS writer's mode switches
(``PsStreamWriter(switch_at=...)``).  Schedules (``FLIP_SCHEDULES``):
20 -> 34 bands at frame 6 (streams 0 and 4); 34 -> 20 at frame 9 (1 and
5); 20 -> 34 -> 20 at frames 5 and 11 (2 and 6); 34 -> 20 -> 34 at
frames 2 and 11 (3 and 7: frame 2 of cores 0-3 is EIGHT_SHORT, so stream
3 flips on a short-window frame).  20 bands is iid_mode 1 / icc_mode 1,
34 bands iid_mode 2 / icc_mode 2; streams 4-7 use fine IID quantisation
(iid_mode 4 or 5) with IPD/OPD, so a flip also resets the phase
histories.  The native parser refuses these streams (the band mode
changes); checked with the port's Python planner: the per-frame band
mode trail flips exactly at the scheduled frames.

heaac_flip_cce_0.aac (50 frames): a flip plus an AFTER_IMDCT coupling
channel: core benchdata/lc_core_24k_2.aac in a PCE layout with a CCE
each frame (applied after the IMDCT), SBR and PS flipping 20 -> 34 at
frame 6 (tests/test_ps_flip.py's flip + coupling recipe on a bundled
core).  Checked with the planner: the trail, 2 lanes, 1 output lane and
coupling edges.

lc_cce_{after,before}_{j}.aac, j in 0..3 (24 kHz mono out, 50 frames):
AAC-LC with no SBR, core benchdata/lc_core_24k_{j}.aac rebuilt in a PCE
layout (channel configuration 0) with a coupling channel element each
frame (``splice_cce_into_lc``, seeded j), applied after the IMDCT or
before TNS.  The native whole-stream parser takes channel
configurations 1-7 only, so these go through the LC Python planner.
Checked with the port's native probe (no SBR) and its LC planner: 2
lanes (the SCE, then the CCE lane), 1 output channel, coupling edges on
the "after" streams only.

heaac_ds_{i}.aac, i in 0..7 (24 kHz stereo out, 50 frames), and
heaac_ds.asc: downsampled SBR.  SBR + 20-band PS spliced into core
benchdata/lc_core_24k_{i}.aac; the stream signals nothing of the mode,
the AudioSpecificConfig does: AOT 5, rate index 6, 1 channel, extension
rate index 6, AOT 2 (tests/test_batch_device.py's recipe), so the
extension rate equals the core rate and the decoder runs the 32-band
synthesis (1024 samples a frame).  Checked with the port's Python
planner given the ASC: downsampled, 24 kHz, 1 lane, 20-band PS.

Every SBR writer here signals no inverse filtering (invf_mode 0).  The
cores are tonal, so a whitened patch (invf_mode 2 or 3) is the small
residual of a nearly exact two-tap prediction, which the envelope gains
then scale up to full energy: its float32 rounding reaches the PCM.  On
such streams the JAX decoder's own jitted and eager runs of one frame
differ by several int16 LSB, so a 2 LSB check would measure the
reference's rounding, not the port (tools/torch_ref_noise.py measures
both).  The inverse filter is exercised by the 20-band bench streams
(invf_mode 0..3) and tests/test_torch_sbr.py.
"""
import functools
import os
import sys

import numpy as np

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
STEREO_FRAMES = 50     # ADTS frames of every stereo stream
CORE_RATE = 24000
CCE_POINTS = ("after", "before")
CCE_SBR_SEEDS = (500, 514)    # per core j (see above)
# PS band modes as (iid_mode, icc_mode): coarse (streams 0-3) and fine
# IID with IPD/OPD (4-7)
PS_MODES = {(False, 20): (1, 1), (False, 34): (2, 2),
            (True, 20): (4, 1), (True, 34): (5, 2)}
# stream i % 4 -> (first band mode, {frame: band mode from that frame})
FLIP_SCHEDULES = {0: (20, {6: 34}), 1: (34, {9: 20}),
                  2: (20, {5: 34, 11: 20}), 3: (34, {2: 20, 11: 34})}
FLIP_CCE_CORE = 2
LC_CCE_N = 4           # LC + CCE streams per coupling point
DS_ASC = "heaac_ds.asc"


def ds_asc() -> bytes:
    """The downsampled streams' AudioSpecificConfig: AOT 5 (SBR), rate
    index 6 (24 kHz), 1 channel, extension rate index 6, AOT 2 (LC),
    then GASpecificConfig's three zero bits."""
    from heaac_tpu_torch.io.bitwriter import BitWriter
    bw = BitWriter()
    for nbits, value in ((5, 5), (4, 6), (4, 1), (4, 6), (5, 2), (3, 0)):
        bw.put(nbits, value)
    bw.align()
    return bw.bytes()


def make_stream(i: int, invf_modes=INVF_MODES) -> bytes:
    """34-band stream i: the distinct-stream recipe over core i."""
    from heaac_tpu_torch.io.heaac_testgen import distinct_stream
    cores = [open(os.path.join(REPO, "benchdata", f"lc_core_24k_{j}.aac"),
                  "rb").read() for j in range(N)]
    iid_mode, ipdopd = MODES.get(i, (2, False))
    return distinct_stream(cores, i, invf_modes=invf_modes,
                           ps_max_bytes=PS_MAX_BYTES, iid_mode=iid_mode,
                           icc_mode=2, enable_ipdopd=ipdopd)


def flip_trail(i: int, frames: int) -> list:
    """Flip stream i's expected per-frame PS band mode (1 = 34 bands)."""
    first, switches = FLIP_SCHEDULES[i % 4]
    mode, out = first, []
    for f in range(frames):
        mode = switches.get(f, mode)
        out.append(int(mode == 34))
    return out


def make_flip_stream(i: int) -> bytes:
    from heaac_tpu_torch.io.heaac_testgen import (PsStreamWriter, SbrStreamWriter,
                                            splice_sbr_into_lc)
    core = open(os.path.join(REPO, "benchdata", f"lc_core_24k_{i}.aac"),
                "rb").read()
    fine = i >= 4
    first, switches = FLIP_SCHEDULES[i % 4]
    iid0, icc0 = PS_MODES[fine, first]
    for tries in range(8):
        try:
            ps = PsStreamWriter(
                seed=3000 + 5 * i, iid_mode=iid0, icc_mode=icc0,
                enable_ipdopd=fine,
                switch_at={f: PS_MODES[fine, m] for f, m in switches.items()})
            ps.ps_payload = functools.partial(
                PsStreamWriter.ps_payload, ps, max_bytes=PS_MAX_BYTES)
            w = SbrStreamWriter(
                core_rate=CORE_RATE, is_cpe=False, env_hi_shift=-12,
                seed=1500 + 7 * i + 1000003 * tries,
                invf_modes=INVF_MODES, ps_writer=ps)
            return splice_sbr_into_lc(core, w)
        except ValueError:
            continue
    raise RuntimeError(f"flip stream {i}: could not fit the FIL payload")


def make_flip_cce_stream() -> bytes:
    from heaac_tpu_torch import tables as TT
    from heaac_tpu_torch.io.heaac_testgen import (PsStreamWriter, SbrStreamWriter,
                                            splice_cce_into_lc,
                                            splice_sbr_multi)
    core = open(os.path.join(REPO, "benchdata",
                             f"lc_core_24k_{FLIP_CCE_CORE}.aac"), "rb").read()
    cce = splice_cce_into_lc(core, coupling_point="after")
    psw = PsStreamWriter(seed=5, iid_mode=1, icc_mode=1,
                         switch_at={6: (1, 2)})
    w = SbrStreamWriter(core_rate=CORE_RATE, is_cpe=False, env_hi_shift=-12,
                        seed=11, invf_modes=INVF_MODES, grid_classes=(0,),
                        fix_num_env=1, ps_writer=psw)
    return splice_sbr_multi(cce, {(TT.TYPE_SCE, 0): w})


def make_lc_cce_stream(point: str, j: int) -> bytes:
    from heaac_tpu_torch.io.heaac_testgen import splice_cce_into_lc
    core = open(os.path.join(REPO, "benchdata", f"lc_core_24k_{j}.aac"),
                "rb").read()
    return splice_cce_into_lc(core, coupling_point=point, seed=j)


def make_ds_stream(i: int) -> bytes:
    from heaac_tpu_torch.io.heaac_testgen import (PsStreamWriter, SbrStreamWriter,
                                            splice_sbr_into_lc)
    core = open(os.path.join(REPO, "benchdata", f"lc_core_24k_{i}.aac"),
                "rb").read()
    ps = PsStreamWriter(seed=4000 + 5 * i, iid_mode=1, icc_mode=1)
    ps.ps_payload = functools.partial(PsStreamWriter.ps_payload, ps,
                                      max_bytes=PS_MAX_BYTES)
    w = SbrStreamWriter(core_rate=CORE_RATE, is_cpe=False, env_hi_shift=-12,
                        seed=6000 + 7 * i, invf_modes=INVF_MODES,
                        ps_writer=ps)
    return splice_sbr_into_lc(core, w)


def check_lc_cce(point: str, j: int, data: bytes) -> str:
    from heaac_tpu_torch import native
    from heaac_tpu_torch.codec.batch import LcStreamBatchDecoder
    from heaac_tpu_torch.host import parse_adts_header
    probe = native.Parser().probe(data, parse_adts_header(data[:7]))
    dec = LcStreamBatchDecoder([data], device="cpu")
    edges = dec.couple is not None
    if (probe is None or probe["sbr"] or dec.T != 50
            or (dec.lane_block, dec.channels) != (2, 1)
            or edges != (point == "after")):
        raise SystemExit(f"LC + CCE stream {point} {j}: probe {probe}, "
                         f"{dec.T} frames, lanes {dec.lane_block}, channels "
                         f"{dec.channels}, edges {edges}")
    return f"probe {probe}, 2 lanes, 1 channel, edges {edges}"


def check_ds(i: int, data: bytes, asc: bytes) -> str:
    from heaac_tpu_torch.codec.planner import parse_stream_qwire
    frames, rate, nl, is34, ds = parse_stream_qwire(data, asc=asc)
    if (len(frames), rate, nl, is34, ds) != (50, CORE_RATE, 1, 0, 1):
        raise SystemExit(f"downsampled stream {i}: {len(frames)} frames, "
                         f"rate {rate}, lanes {nl}, is34 {is34}, ds {ds}")
    return "downsampled, 24 kHz, 1 lane, 20-band PS"


def planner_parse(data: bytes) -> dict:
    """The port's Python planner over one stream: frames, lanes, output
    lanes, coupling series and the per-frame PS band-mode trail."""
    from heaac_tpu_torch.codec.planner import parse_stream_qwire
    trail, info = [], {}
    frames, _, nl, _, _ = parse_stream_qwire(data, is34_out=trail,
                                             info_out=info)
    return dict(frames=len(frames), nl=nl, out_nl=info["out_nl"],
                couple=info["couple"], trail=trail)


def check_flip(name: str, data: bytes, want_trail: list, nl: int,
               couple: bool) -> str:
    from heaac_tpu_torch import native
    from heaac_tpu_torch.host import parse_adts_header
    p = planner_parse(data)
    bad = []
    if p["trail"] != want_trail[:p["frames"]] or p["frames"] != 50:
        bad.append(f"trail {p['trail']} over {p['frames']} frames")
    if (p["nl"], p["out_nl"], p["couple"] is not None) != (nl, 1, couple):
        bad.append(f"lanes {p['nl']}, output lanes {p['out_nl']}, "
                   f"coupling {p['couple'] is not None}")
    if native.Parser().probe(data, parse_adts_header(data[:7])) is None:
        bad.append("the native probe refuses it")
    if bad:
        raise SystemExit(f"{name}: " + "; ".join(bad))
    flips = [f for f in range(1, 50) if want_trail[f] != want_trail[f - 1]]
    return f"band mode flips at frames {flips}, {nl} lanes"


def stereo_pcm(i: int) -> np.ndarray:
    """Stream i's two-channel int16 signal: a mid tone with noise and a
    small side tone (tests/test_spec_cpe.py's M/S signal, per-stream
    frequencies); odd streams are quieter and carry a transient burst in
    both channels every 2048 samples (its short-window M/S case)."""
    rng = np.random.default_rng(100 + i)
    n = (STEREO_FRAMES - 1) * 1024     # the encoder adds a lead-in frame
    t = np.arange(n) / CORE_RATE
    f_mid, f_side = 500 + 60 * i, 1700 + 90 * i
    if i % 2:
        mid = 0.05 * np.sin(2 * np.pi * f_mid * t) \
            + 0.005 * rng.standard_normal(n)
        side = 0.01 * np.sin(2 * np.pi * f_side * t)
        left, right = mid + side, mid - side
        for p in range(512, n - 96, 2048):
            left[p:p + 96] += np.hanning(96) * 2.0
            right[p:p + 96] += np.hanning(96) * 2.0
    else:
        mid = 0.4 * np.sin(2 * np.pi * f_mid * t) \
            + 0.05 * rng.standard_normal(n)
        side = 0.03 * np.sin(2 * np.pi * f_side * t)
        left, right = mid + side, mid - side
    return np.clip(np.stack([left, right], 1) * 3000,
                   -32768, 32767).astype(np.int16)


def make_stereo_stream(i: int) -> bytes:
    from heaac_tpu_torch.codec.encoder import AacEncoder
    from heaac_tpu_torch.io.heaac_testgen import SbrStreamWriter, splice_sbr_into_lc
    core = AacEncoder(CORE_RATE, 2, bitrate=64000, ms=True,
                      window_switching=bool(i % 2)).encode(stereo_pcm(i))
    # envelopes 2 steps lower than the mono streams': the coupled pair's
    # balance would otherwise clip the louder channel
    w = SbrStreamWriter(core_rate=CORE_RATE, is_cpe=True, coupling=True,
                        env_hi_shift=-14, seed=300 + 11 * i,
                        invf_modes=INVF_MODES)
    return splice_sbr_into_lc(core, w)


def make_cce_stream(point: str, j: int) -> bytes:
    from heaac_tpu_torch import tables as TT
    from heaac_tpu_torch.io.heaac_testgen import (SbrStreamWriter,
                                            splice_cce_into_lc,
                                            splice_sbr_multi)
    core = open(os.path.join(REPO, "benchdata", f"lc_core_24k_{j}.aac"),
                "rb").read()
    cce = splice_cce_into_lc(core, coupling_point=point, seed=j)
    w = SbrStreamWriter(core_rate=CORE_RATE, is_cpe=False, env_hi_shift=-12,
                        seed=CCE_SBR_SEEDS[j], invf_modes=INVF_MODES)
    return splice_sbr_multi(cce, {(TT.TYPE_SCE, 0): w})


def port_parse(data: bytes) -> dict:
    """The port's native parse of one stream on the CPU: the decoder's
    lane counts and static decode sizes, its coupling edges, and per
    frame-lane side flags (raw SBR rows, coupled) and spec-mode w3."""
    from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
    from heaac_tpu_torch.host import R_TOKOFF, R_W1, R_W2, R_W3
    dec = QwirePipelinedDecoder([data], group_streams=1, device="cpu")
    while (r := dec._parse_group([data], 0, dec.T)) is None:
        dec._grow()                  # heap full: grow and parse again
    heap, cur, recs, couple = r
    T = dec.frame_counts[0]
    recs = recs[:T]
    w1 = recs[..., R_W1]
    soff = recs[..., R_TOKOFF] + (w1 & 0xFFFF) + ((w1 >> 16) & 0xFFFF)
    flags = heap[soff + 1].astype(np.int64)
    start = flags & 1
    spec = ((recs[..., R_W2] >> 24) & 15) == 1
    return dict(nl=dec.nl, out_nl=dec.out_nl, MS=dec.MS, RP=dec.RP,
                edges=couple, frames=T, start=start,
                rows=((flags >> 7) & 1) * start, coupled=(flags >> 2) & 1,
                w3=np.where(spec, recs[..., R_W3], 0))


def rows_then_uncoupled_bytes(p: dict) -> bool:
    """True iff some lane has an uncoupled byte-mode SBR frame after a
    raw-rows frame: the shape the JAX package's carry refresh gets wrong
    (it writes ch1's codes into ch0's chain slot), which the port keeps
    matching and its test streams avoid."""
    seen_rows = np.cumsum(p["rows"], 0) > 0
    byte_unc = (p["start"] > 0) & (p["rows"] == 0) & (p["coupled"] == 0)
    return bool((byte_unc[1:] & seen_rows[:-1]).any())


def check_stereo(i: int, data: bytes) -> str:
    from heaac_tpu_torch import native
    from heaac_tpu_torch.host import count_adts_frames, parse_adts_header
    probe = native.Parser().probe(data, parse_adts_header(data[:7]))
    p = port_parse(data)
    w3 = p["w3"]
    short_ms = int((((w3 >> 30) & 1) & ((w3 >> 28) & 1)).sum())
    bad = []
    if probe is None or (probe["sbr"], probe["lanes"]) != (1, 2):
        bad.append(f"probe {probe}")
    if count_adts_frames(data) != STEREO_FRAMES:
        bad.append(f"{count_adts_frames(data)} frames")
    if (p["MS"], p["RP"], p["nl"], p["out_nl"]) != (1, 1, 2, 2):
        bad.append(f"MS {p['MS']} rows_pair {p['RP']} lanes {p['nl']} "
                   f"output lanes {p['out_nl']}")
    if i % 2 and not short_ms:
        bad.append("no short-window M/S lanes")
    if rows_then_uncoupled_bytes(p):
        bad.append("an uncoupled byte-mode SBR frame after a raw-rows frame")
    if bad:
        raise SystemExit(f"stereo stream {i}: " + "; ".join(bad))
    return (f"probe {probe}, MS 1, rows_pair 1, {int(p['rows'].sum())} "
            f"raw-rows frame-lanes, {short_ms} short-window M/S lanes")


def check_cce(point: str, j: int, data: bytes) -> str:
    p = port_parse(data)
    want_edges = point == "after"
    if (p["nl"], p["out_nl"]) != (2, 1) or (p["edges"] is not None) \
            != want_edges:
        raise SystemExit(f"CCE stream {point} {j}: lanes {p['nl']}, output "
                         f"lanes {p['out_nl']}, edges {p['edges']}")
    ne = 0 if p["edges"] is None else len(p["edges"][0])
    return f"2 lanes, 1 output lane, {ne} coupling edges"


def main() -> None:
    sys.path.insert(0, REPO)
    from heaac_tpu_torch import native
    from heaac_tpu_torch.host import parse_adts_header
    out = sys.argv[1] if len(sys.argv) > 1 else OUT
    os.makedirs(out, exist_ok=True)

    def write(name: str, data: bytes, note: str) -> None:
        path = os.path.join(out, name)
        with open(path, "wb") as f:
            f.write(data)
        print(f"wrote {path}: {len(data)} bytes, {note}", flush=True)

    kinds = set(sys.argv[2:]) or {"he34", "stereo", "cce", "flip",
                                  "lc_cce", "ds"}
    if "he34" in kinds:
        for i in range(N):
            data = make_stream(i)
            p = native.Parser().probe(data, parse_adts_header(data[:7]))
            if p is None or (p["sbr"], p["is34"]) != (1, 1):
                raise SystemExit(f"stream {i}: probe gave {p}, expected SBR "
                                 "with 34-band PS")
            write(f"heaac_v2_34band_{i}.aac", data, f"probe {p}")
    if "stereo" in kinds:
        for i in range(N):
            data = make_stereo_stream(i)
            write(f"heaac_v1_stereo_{i}.aac", data, check_stereo(i, data))
    if "cce" in kinds:
        for point in CCE_POINTS:
            for j in range(2):
                data = make_cce_stream(point, j)
                write(f"heaac_cce_{point}_{j}.aac", data,
                      check_cce(point, j, data))
    if "flip" in kinds:
        for i in range(N):
            data = make_flip_stream(i)
            write(f"heaac_v2_flip_{i}.aac", data,
                  check_flip(f"flip stream {i}", data, flip_trail(i, 50), 1,
                             False))
        data = make_flip_cce_stream()
        write("heaac_flip_cce_0.aac", data,
              check_flip("flip + CCE stream", data, [0] * 6 + [1] * 44, 2,
                         True))
    if "lc_cce" in kinds:
        for point in CCE_POINTS:
            for j in range(LC_CCE_N):
                data = make_lc_cce_stream(point, j)
                write(f"lc_cce_{point}_{j}.aac", data,
                      check_lc_cce(point, j, data))
    if "ds" in kinds:
        asc = ds_asc()
        write(DS_ASC, asc, f"AudioSpecificConfig {asc.hex()}")
        for i in range(N):
            data = make_ds_stream(i)
            write(f"heaac_ds_{i}.aac", data, check_ds(i, data, asc))


if __name__ == "__main__":
    main()
