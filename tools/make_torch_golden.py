#!/usr/bin/env python
"""Write the JAX reference's outputs for the PyTorch port's checks.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [out_dir] [name ...]

Writes twelve goldens into tests/data (or out_dir), all from the JAX
package on the CPU (with 8 virtual XLA devices); with names (scan,
batch, stereo, qwire, flip, lc, probe, ds, single, front, sharded,
encode) only those:

  heaac_v2_golden_jax.npz      benchdata/heaac_bench_stream_{0,1}.aac
      parsed by its QwirePipelinedDecoder and decoded by its qwire scan,
      first 16 frames each (``golden_scan``): pcm int16 [16, 2, 2, 2048]
      (frame, stream, channel, sample), and the scan's carry after frames
      8 and 16 (``carry_mid/...``, ``carry_end/...``: ``flatten_tree``).
  decode_batch_golden_jax.npz  its ``decode_batch`` over the mixed list
      of ``batch_streams()`` (20-band and 34-band HE-AAC v2, stereo
      HE-AAC v1, HE-AAC with a coupling channel applied after the IMDCT
      or before TNS, AAC-LC and a buffer with no sync word, interleaved):
      ``names`` [12], and per entry k ``pcm_k``, the first 16 frames'
      samples of its [n, ch] int16 output, and ``n_k``, its whole
      length n.
  heaac_v1_stereo_expand_golden_jax.npz  tests/data/heaac_v1_stereo_0.aac
      (one coupled CPE: two lanes) parsed by its QwirePipelinedDecoder
      (``heap``, ``recs``) and expanded frame by frame by
      ``qwire.expand_frame_jax(rows_pair=1)`` and
      ``compact_plan.expand_ps`` (``expand_stereo``): the outputs (core
      meta, SBR plan, PS codes, PS plan) of frames 8 and 16
      (``frame_mid/...``, ``frame_end/...``) and the (qwire carry, PS
      history) after them (``carry_mid/...``, ``carry_end/...``); and the
      scan prologue with the device M/S butterfly
      (``_qwire_decode_all_coeffs`` with MS=1, ``prologue_stereo``) over
      stereo streams 0-1's first 4 frames: ``ms_heap``, ``ms_recs``,
      ``ms_coeffs`` [4, 4, 1024].
  qwire_expand_golden_jax.npz  streams 0-3 of the 20-band (benchdata)
      and of the 34-band kind, first QWIRE_FRAMES frames, parsed by its
      QwirePipelinedDecoder (``{kind}/heap``, ``{kind}/recs``) and
      expanded frame by frame by ``qwire.expand_frame_jax`` (is34 0 or
      1) from fresh carries, eagerly (``expand_streams``): each frame's
      outputs (core meta, SBR plan, PS codes) and the carry after it
      (``{kind}/frame_{f}/...``).
  flip_golden_jax.npz  the band-mode flip streams
      (tests/data/heaac_v2_flip_{0..7}.aac, heaac_flip_cce_0.aac; names
      ``flip_{i}``, ``flip_cce_0``), first FRAMES frames: its
      ``decode_qwire_flip_stream`` PCM (``pcm_{name}``, int16 [n, 2]) and
      the planner's band-mode trail (``trail_{name}``); for flip streams
      0 and 1 the planner's heap and records (``expand_{i}/heap``,
      ``/recs``) and ``expand_frame_jax(is34=-1)``'s outputs at the
      first flip frame and the frame after (``expand_{i}/frame_{f}``),
      the qwire carry before them and after each
      (``expand_{i}/carry_{f}``: after frame f); and the flip scan's
      carry after the first FLIP_CARRY_FRAMES frames of flip stream 1,
      whose band mode flips at frame 9 (``scan_carry/...``, with the
      ``scan_heap``, ``scan_recs`` and ``scan_static`` it ran on).
  lc_batch_golden_jax.npz  its ``decode_batch`` over ``lc_streams()``:
      the AAC-LC + CCE streams (tests/data/lc_cce_{after,before}_{0..3}
      .aac, its LC planner and coupled LC scan) and two 20-band streams
      whose frame 1 has a corrupted byte (the native probe refuses them,
      the Python prober buckets them, and the first is stream 0 of its
      bucket: the Python profile parse), interleaved: ``names``,
      ``pcm_k`` (first FRAMES frames) and ``n_k`` as in the batch golden;
      and, for each ``UNPORTED`` stream, ``single_{name}``: 1 where its
      ``decode_batch`` fell back to the single-stream decoder (its log
      line says so).
  prober_golden_jax.npz  the Python prober of its ``decode_batch``
      (batch.py:1791-1801: ``Decoder.decode_frame`` of the first frame;
      any exception is (False, False)) over every committed stream
      (``probe_streams()``: benchdata/*.aac, tests/data/*.aac) and the
      ``CORRUPT`` variants: ``names``, ``sbr`` and ``is34`` (int).
  downsampled_golden_jax.npz  tests/data/heaac_ds_{0..3}.aac with the
      AudioSpecificConfig tests/data/heaac_ds.asc, first FRAMES frames:
      its ``parse_stream_qwire(asc=)`` packed into a heap and records
      as the port packs planner frames (``heap``, ``recs``, ``static``)
      and decoded by
      ``qwire_scan_decoder(0, 1, ...)`` in two halves (``pcm`` int16
      [FRAMES, 4, 2, 1024]; ``carry_mid/...``, ``carry_end/...``); and
      the max LSB between that and its dense ``StreamBatchDecoder(asc=)``
      over the same frames (``dense_lsb``).
  single_golden_jax.npz  its single-stream ``Decoder`` (default parser
      choice, as its ``decode_batch`` builds it) over ``SINGLE_LIST``,
      first FRAMES ADTS frames each through ``Decoder.decode``; the
      downsampled stream ``heaac_ds_0`` through ``Decoder(asc=)
      .decode_frame`` of each frame's raw data block: ``names``, and per
      name ``pcm_{name}`` (int16 [n, ch]), ``errors_{name}`` (its
      ``error_count``), ``rate_{name}`` (its output rate) and
      ``ps_{name}`` ([frames whose PS ran in 20 bands, in 34 bands]).
  front_golden_jax.npz  the front doors.  First the ``.m4a`` inputs,
      written by its muxer (``heaac_tpu.io.mp4.mux_m4a``) as
      tests/data/front_{name}.m4a, FRAMES frames each (``FRONT_LIST``):
      bench stream 0 through its ADTS->ASC filter (``he20_0``; it
      re-wraps as ADTS), the same raw frames behind an explicit-SBR
      AudioSpecificConfig (``he20_explicit_0``; ``EXPLICIT_SBR_ASC``:
      the ASC-configured Decoder), ``heaac_ds_0`` behind heaac_ds.asc
      (``ds_0``), ``lc_core_24k_0`` (``lc_0``) and the explicit twin with
      frame ``FRONT_CORRUPT`` corrupted (``he20_explicit_bad_0``: both
      packages raise BitstreamError on it).  Then its ``decode`` of each
      (``pcm_{name}``, ``rate_{name}``, ``errors_{name}``: the
      Decoder's error_count); its CLI's ``--probe`` JSON, captured
      in-process, of each input and of each ``FRONT_ADTS`` stream
      (``probe_main_{name}``), and ``probe()``'s dict of each ADTS
      stream (``probe_{name}``, JSON); and the ``(pos, n, value)`` reads
      of its ``TracingBitReader`` over the first TRACE_FRAMES frames of
      lc_core_24k_0 (``trace``, int64 [reads, 2]: pos, n;
      ``trace_values``, each value in hex: a skip's is as wide as the
      skip).
  sharded_golden_jax.npz  its ``ShardedQwireDecoder`` on the 8-device
      CPU mesh (``SHARDED_CASES``, first FRAMES frames): bench streams
      0-7 on 4 devices (``he20``), stereo streams 0-3 (``stereo``) and
      coupling streams after_{0,1,0,1} (``cce``) on 8, where JAX splits
      every stream's lanes across devices: ``pcm_{case}`` (int16 [FRAMES,
      8, 2, 2048]), ``frames_{case}``, ``errors_{case}``; its
      ``error_count`` after each of two ``decode()`` calls over
      ``SHARDED_ERRORS`` (``errors_short_group``: the padding copy of the
      short last group counts again, and the calls add up); and its
      ``QwirePipelinedDecoder`` over each round-robin half (rank r takes
      streams r, r + 2) of ``multihost_streams()``:
      ``multihost_frames_{r}``, ``multihost_errors_{r}``,
      ``multihost_audio_{r}``.  ~10 min: five scan compiles.
  encode_golden_jax.npz  its AacEncoder (host numpy) over every
      ``ENCODE_CASES`` case: ``cases`` (the table as JSON), ``pcm_{name}``
      (the seeded int16 input, ``encode_pcm``) and ``adts_{name}`` (its
      bytes, uint8); and ``distinct_sha256``, the sha256 of the first
      DISTINCT_GOLDEN_N distinct HE-AAC v2 streams its generators make
      (the port's ``heaac_testgen.distinct_stream`` recipe, drawn
      with the JAX writers).  ~30 s, nothing compiled.

The 34-band, stereo, CCE, flip, LC + CCE and downsampled streams come
from tools/make_torch_streams.py.
chip_smoke.py holds the port's GPU output to the first two files;
tests/test_torch_golden.py regenerates the first and checks it,
tests/test_torch_decode_batch.py holds the port's CPU decode_batch to
the second and tests/test_torch_stereo.py its CPU expand_frame to the
third; tests/test_torch_qwire.py holds its expand_frame to the fourth;
tests/test_torch_flip.py and chip_smoke.py phase 7 hold the flip path
to the fifth; tests/test_torch_lc_planner.py and chip_smoke.py phase 8
hold the LC planner, the prober and the profile parse to the sixth and
seventh, tests/test_torch_downsampled.py and phase 8 the downsampled
scan to the eighth, tests/test_torch_single.py and phase 9 the port's
single-stream Decoder to the ninth, tests/test_torch_front.py and phase
10 the port's front doors and CLI to the tenth, tests/test_torch_sharding.py,
tests/test_torch_multihost.py and phase 11 the port's parallel layer to
the eleventh, tests/test_torch_encoder.py, tests/test_torch_nojax.py and
phase 12 the port's encoder and generators to the twelfth.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
GOLDEN = os.path.join(DATA, "heaac_v2_golden_jax.npz")
BATCH_GOLDEN = os.path.join(DATA, "decode_batch_golden_jax.npz")
EXPAND_GOLDEN = os.path.join(DATA, "heaac_v1_stereo_expand_golden_jax.npz")
STEREO_FILE = "tests/data/heaac_v1_stereo_{}.aac"
STREAMS = (0, 1)
FRAMES = 16
HALF = FRAMES // 2
MS_STREAMS, MS_FRAMES = 2, 4      # the M/S prologue golden
QWIRE_GOLDEN = os.path.join(DATA, "qwire_expand_golden_jax.npz")
QWIRE_KINDS = {"he20": "benchdata/heaac_bench_stream_{}.aac",
               "he34": "tests/data/heaac_v2_34band_{}.aac"}
QWIRE_STREAMS, QWIRE_FRAMES = 4, 6
FLIP_GOLDEN = os.path.join(DATA, "flip_golden_jax.npz")
FLIP_FILES = tuple((f"flip_{i}", f"tests/data/heaac_v2_flip_{i}.aac")
                   for i in range(8)) + (
    ("flip_cce_0", "tests/data/heaac_flip_cce_0.aac"),)
FLIP_EXPAND = {0: 6, 1: 9}        # flip stream -> its first flip frame
FLIP_CARRY_STREAM, FLIP_CARRY_FRAMES = 1, 10
# the mixed decode_batch list: (name, file relative to the repo); None is
# the buffer with no ADTS sync word
BATCH_LIST = (
    ("he20_0", "benchdata/heaac_bench_stream_0.aac"),
    ("he34_0", "tests/data/heaac_v2_34band_0.aac"),
    ("lc_0", "benchdata/lc_core_24k_0.aac"),
    ("garbage", None),
    ("he20_1", "benchdata/heaac_bench_stream_1.aac"),
    ("he34_1", "tests/data/heaac_v2_34band_1.aac"),
    ("lc_1", "benchdata/lc_core_24k_1.aac"),
    ("he_v1s_0", STEREO_FILE.format(0)),
    ("cce_after_0", "tests/data/heaac_cce_after_0.aac"),
    ("he_v1s_1", STEREO_FILE.format(1)),
    ("cce_before_0", "tests/data/heaac_cce_before_0.aac"),
    ("cce_after_1", "tests/data/heaac_cce_after_1.aac"),
)
GARBAGE = bytes(range(0x20, 0x7F)) * 4    # printable bytes: no 0xFF
LC_GOLDEN = os.path.join(DATA, "lc_batch_golden_jax.npz")
PROBE_GOLDEN = os.path.join(DATA, "prober_golden_jax.npz")
DS_GOLDEN = os.path.join(DATA, "downsampled_golden_jax.npz")
DS_FILE = "tests/data/heaac_ds_{}.aac"
DS_ASC = "tests/data/heaac_ds.asc"
DS_STREAMS = 4
# corrupted streams: name -> (file, frame, byte of that frame XOR 0xFF);
# the native probe refuses each.  Frame 1: the Python prober parses frame
# 0 and buckets the stream HE.  Frame 0: its parse fails, so (False,
# False), the AAC-LC bucket, where the JAX package's LC planner fails
# too and its decode_batch falls back to the single-stream decoder.
CORRUPT = {
    "he20_f1_0": ("benchdata/heaac_bench_stream_0.aac", 1, 9),
    "he20_f1_1": ("benchdata/heaac_bench_stream_1.aac", 1, 9),
    "he20_f0_0": ("benchdata/heaac_bench_stream_0.aac", 0, 61),
    "he34_f0_0": ("tests/data/heaac_v2_34band_0.aac", 0, 57),
    "lc_cce_f1_0": ("tests/data/lc_cce_after_0.aac", 1, 9),
}
LC_LIST = ("he20_f1_0", "lc_cce_after_0", "lc_cce_before_0",
           "lc_cce_after_1", "lc_cce_before_1", "he20_f1_1",
           "lc_cce_after_2", "lc_cce_before_2", "lc_cce_after_3",
           "lc_cce_before_3")
# streams whose JAX decode_batch falls back to its single-stream Decoder
UNPORTED = ("he20_f0_0",)
SINGLE_GOLDEN = os.path.join(DATA, "single_golden_jax.npz")
# the single-stream Decoder's streams: CORRUPT keys, or files relative to
# the repo; frame 0 of the two CORRUPT ones is dropped and PS never starts
SINGLE_LIST = (
    ("he20_f0_0", None),
    ("he34_f0_0", None),
    ("he20_0", "benchdata/heaac_bench_stream_0.aac"),
    ("he34_0", "tests/data/heaac_v2_34band_0.aac"),
    ("flip_0", "tests/data/heaac_v2_flip_0.aac"),
    ("he_v1s_1", STEREO_FILE.format(1)),
    ("cce_after_0", "tests/data/heaac_cce_after_0.aac"),
    ("cce_before_0", "tests/data/heaac_cce_before_0.aac"),
    ("lc_cce_after_0", "tests/data/lc_cce_after_0.aac"),
    ("lc_0", "benchdata/lc_core_24k_0.aac"),
    ("ds_0", DS_FILE.format(0)),
)


FRONT_GOLDEN = os.path.join(DATA, "front_golden_jax.npz")
FRONT_FILE = "tests/data/front_{}.m4a"
# AOT 5 (SBR), core rate index 6 (24 kHz), mono, extension rate index 3
# (48 kHz), AOT 2, GASpecificConfig flags 0 (tests/test_mp4.py:122-130)
EXPLICIT_SBR_ASC = bytes.fromhex("2b098800")
FRONT_CORRUPT = (3, 4)    # (frame, byte of its raw data block) XOR 0xFF
# name -> (ADTS file, AudioSpecificConfig: None for the ADTS->ASC
# filter's, "explicit" for EXPLICIT_SBR_ASC, else a file)
FRONT_LIST = (
    ("he20_0", "benchdata/heaac_bench_stream_0.aac", None),
    ("he20_explicit_0", "benchdata/heaac_bench_stream_0.aac", "explicit"),
    ("ds_0", DS_FILE.format(0), DS_ASC),
    ("lc_0", "benchdata/lc_core_24k_0.aac", None),
    ("he20_explicit_bad_0", "benchdata/heaac_bench_stream_0.aac",
     "explicit"),
)
# the ADTS streams the CLI probes: name -> file
FRONT_ADTS = (
    ("he20_0.aac", "benchdata/heaac_bench_stream_0.aac"),
    ("he34_0.aac", "tests/data/heaac_v2_34band_0.aac"),
    ("he_v1s_1.aac", STEREO_FILE.format(1)),
    ("cce_after_0.aac", "tests/data/heaac_cce_after_0.aac"),
    ("ds_0.aac", DS_FILE.format(0)),
    ("lc_0.aac", "benchdata/lc_core_24k_0.aac"),
)
SHARDED_GOLDEN = os.path.join(DATA, "sharded_golden_jax.npz")
# the sharded golden's cases: name -> (file pattern, stream indices, mesh
# devices); in JAX each device takes 8 / devices lanes, so every CPE pair
# and every coupling channel's lanes are split across devices
SHARDED_CASES = {
    "he20": ("benchdata/heaac_bench_stream_{}.aac", range(8), 4),
    "stereo": (STEREO_FILE, range(4), 8),
    "cce": ("tests/data/heaac_cce_after_{}.aac", (0, 1, 0, 1), 8),
}
# a short last group whose stream has a corrupt frame: bench streams 1
# and 2, then CORRUPT["he20_f1_0"], in groups of 2 over 2 devices,
# first 4 frames (the last group is that stream and its padding copy)
SHARDED_ERRORS = (("benchdata/heaac_bench_stream_1.aac",
                   "benchdata/heaac_bench_stream_2.aac", "he20_f1_0"), 4)
MULTIHOST_STREAMS, MULTIHOST_FRAMES = 4, 8
TRACE_FILE = "benchdata/lc_core_24k_0.aac"
TRACE_FRAMES = 2
ENCODE_GOLDEN = os.path.join(DATA, "encode_golden_jax.npz")
# the encoder's cases (tests/test_encoder.py's, cut to a few frames):
# name -> (sample rate, channels, signal, encoder keyword arguments);
# signal "tone" is test_encoder.py's two tones per channel, "bursts" adds
# a Hann-windowed noise burst every 3072 samples (short windows); both
# with seeded noise
ENCODE_CASES = {
    "lc_mono_44k": (44100, 1, "tone", {}),
    "lc_mono_24k": (24000, 1, "tone", {}),
    "lc_stereo_48k": (48000, 2, "tone", {}),
    "window_switching": (48000, 1, "bursts", {}),
    "rate_48k": (44100, 1, "tone", {"bitrate": 48000}),
    "rate_96k": (44100, 1, "tone", {"bitrate": 96000}),
    "twoloop_64k": (44100, 1, "tone", {"bitrate": 64000}),
    "anmr_64k": (44100, 1, "bursts", {"bitrate": 64000, "coder": "anmr"}),
    "main_mono": (44100, 1, "tone", {"object_type": 1}),
    "main_stereo": (44100, 2, "tone", {"object_type": 1}),
    "ms": (24000, 2, "tone", {"bitrate": 96000, "ms": True}),
    "intensity": (24000, 2, "tone", {"bitrate": 48000, "intensity": True}),
    "tns_inject": (24000, 1, "tone", {
        "bitrate": 32000, "window_switching": False,
        "tns_inject": {"coefs": [2, 5, 3], "coef_res": 0}}),
}
# ADTS frames a case encodes (the encoder adds a lead-in frame): 8; 5
# where it runs its rate loop (a bitrate), which costs 4-5x a frame, and
# 4 where it does so on a stereo pair (the case stays under 3 s a test)
ENCODE_FRAMES = {(False, 1): 8, (False, 2): 8, (True, 1): 5, (True, 2): 4}
# tns_inject writes filter data the encoder never applied, so its output
# does not reproduce its input: no round-trip SNR for it
ENCODE_NO_SNR = ("tns_inject",)
# the distinct HE-AAC v2 streams whose sha256 the encode golden holds
DISTINCT_GOLDEN_N = 8


def batch_streams(repo: str = REPO) -> list:
    """The mixed decode_batch list as [(name, bytes)] in its fixed
    order."""
    out = []
    for name, rel in BATCH_LIST:
        if rel is None:
            out.append((name, GARBAGE))
        else:
            with open(os.path.join(repo, rel), "rb") as f:
                out.append((name, f.read()))
    return out


def frame_samples(name: str) -> int:
    """Output samples per frame of a BATCH_LIST entry."""
    return 1024 if name.startswith("lc") else 2048


def channels(name: str) -> int:
    """Output channels of a BATCH_LIST entry: AAC-LC mono gives one; PS,
    a mono HE core (with or without a coupling channel) and stereo
    HE-AAC v1 give two."""
    return 1 if name.startswith("lc") else 2


def _numpy_tree(x):
    """A JAX carry (NamedTuple / dict / array leaves) -> numpy copies."""
    if hasattr(x, "_asdict"):
        x = x._asdict()
    if isinstance(x, (dict, tuple)):
        items = x.items() if isinstance(x, dict) else enumerate(x)
        out = {str(k): _numpy_tree(v) for k, v in items}
        return out if isinstance(x, dict) else tuple(out.values())
    return np.array(x)


def flatten_tree(tree, prefix: str) -> dict:
    """Nested dicts / tuples of arrays -> {"prefix/key/...": array}."""
    if isinstance(tree, (dict, tuple)):
        items = tree.items() if isinstance(tree, dict) else enumerate(tree)
        out = {}
        for k, v in items:
            out.update(flatten_tree(v, f"{prefix}/{k}"))
        return out
    return {prefix: tree}


def unflatten_tree(z, prefix: str):
    """flatten_tree's inverse for one prefix of an npz (or a dict of its
    arrays): a tree flattened from a tuple (a carry: state, ps_hist,
    qwire carry) comes back as a tuple of nested dicts, one flattened
    from a dict as that dict."""
    root: dict = {}
    for key in z.files if hasattr(z, "files") else z:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            d = root
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = z[key]
    if all(str(i) in root for i in range(len(root))):
        return tuple(root[str(i)] for i in range(len(root)))
    return root


def golden_scan() -> dict:
    """The JAX package's qwire scan (heaac_graph.qwire_scan_decoder) over
    the first FRAMES frames of benchdata streams STREAMS, parsed by its
    QwirePipelinedDecoder, in two halves: frames 0..HALF-1 from the
    initial carry, the rest from the carry the first half leaves (one
    compile serves both).  -> dict(pcm int16 [FRAMES, 2, 2, 2048], the
    parse (heap, recs), the static arguments, and the carries after each
    half as numpy trees)."""
    sys.path.insert(0, REPO)
    from heaac_tpu.codec import heaac_graph as jg
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    streams = [open(os.path.join(REPO, "benchdata",
                                 f"heaac_bench_stream_{i}.aac"), "rb").read()
               for i in STREAMS]
    dec = QwirePipelinedDecoder(streams, group_streams=len(streams),
                                max_frames=FRAMES)
    heap, cur, recs = dec._parse_group(streams, 0, FRAMES)
    heap = heap[:(cur + 3) // 4 * 4 + 4096].copy()
    recs = recs[:FRAMES].copy()
    static = (dec.is34, dec.ds, dec.S, dec.rate_idx, dec.NB, dec.MS,
              dec.NS, dec.SEC, dec.RP)
    run = jg.qwire_scan_decoder(*static)
    carry = jg.init_qwire_carry(dec.L)
    pcm, carries = [], []
    for half in (recs[:HALF], recs[HALF:]):
        # the scan donates its carry: copy each one out before reusing it
        carry, out = run(heap.view(np.float32), half.view(np.float32),
                         carry)
        pcm.append(np.asarray(out))
        carries.append(_numpy_tree(carry))
    return dict(pcm=np.concatenate(pcm).astype(np.int16), heap=heap,
                recs=recs, static=static, carry_mid=carries[0],
                carry_end=carries[1])


def expand_stereo() -> dict:
    """The JAX package's per-frame expansion of the first FRAMES frames of
    stereo stream 0 with coupled raw SBR rows (expand_frame_jax with
    rows_pair=1, then expand_ps), eagerly, from fresh carries ->
    dict(heap, recs, and frame_mid / frame_end: (core_meta, plan, pc,
    ps_plan) of frames HALF and FRAMES, carry_mid / carry_end: (qwire
    carry, PS history) after them, as numpy trees)."""
    sys.path.insert(0, REPO)
    import jax.numpy as jnp
    from heaac_tpu.codec import compact_plan, qwire
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    data = open(os.path.join(REPO, STEREO_FILE.format(0)), "rb").read()
    dec = QwirePipelinedDecoder([data], group_streams=1, max_frames=FRAMES)
    heap, cur, recs = dec._parse_group([data], 0, FRAMES)
    if (dec.nl, dec.RP, dec.is34) != (2, 1, 0):
        raise SystemExit(f"stereo stream 0: lanes {dec.nl}, rows_pair "
                         f"{dec.RP}, is34 {dec.is34}")
    heap = heap[:cur + 4096].copy()
    recs = recs[:FRAMES].copy()
    jheap = jnp.asarray(heap.astype(np.int32))
    qc = qwire.init_qcarry(dec.L)
    ph = compact_plan.init_ps_hist(dec.L)
    out = dict(heap=heap, recs=recs)
    for f in range(FRAMES):
        core_meta, plan, pc, qc = qwire.expand_frame_jax(
            jheap, jnp.asarray(recs[f]), qc, 0, 1)
        ps_plan, ph = compact_plan.expand_ps(pc, ph, 0)
        if f + 1 in (HALF, FRAMES):
            tag = "mid" if f + 1 == HALF else "end"
            out[f"frame_{tag}"] = _numpy_tree((core_meta, plan, pc, ps_plan))
            out[f"carry_{tag}"] = _numpy_tree((qc, ph))
    return out


def prologue_stereo() -> dict:
    """The JAX scan prologue (``_qwire_decode_all_coeffs`` with MS=1,
    eagerly) over the first MS_FRAMES frames of stereo streams
    0..MS_STREAMS-1 as its QwirePipelinedDecoder parses them ->
    dict(ms_heap, ms_recs [T, L, 4], ms_coeffs [T, L, 1024])."""
    sys.path.insert(0, REPO)
    import jax.numpy as jnp
    from heaac_tpu.codec import heaac_graph
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    streams = [open(os.path.join(REPO, STEREO_FILE.format(i)), "rb").read()
               for i in range(MS_STREAMS)]
    dec = QwirePipelinedDecoder(streams, group_streams=MS_STREAMS,
                                max_frames=MS_FRAMES)
    heap, cur, recs = dec._parse_group(streams, 0, MS_FRAMES)
    if dec.MS != 1:
        raise SystemExit(f"stereo streams: MS {dec.MS}")
    heap = heap[:cur + 4096].copy()
    heap = np.concatenate([heap, np.zeros(-len(heap) % 4, np.uint8)])
    recs = recs[:MS_FRAMES].copy()
    _, _, coeffs = heaac_graph._qwire_decode_all_coeffs(
        jnp.asarray(heap.view(np.float32)), jnp.asarray(recs.view(np.float32)),
        dec.S, dec.rate_idx, dec.NB, dec.MS, dec.NS, dec.SEC)
    return dict(ms_heap=heap, ms_recs=recs, ms_coeffs=np.asarray(coeffs))


def write_stereo_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(EXPAND_GOLDEN))
    g = expand_stereo()
    np.savez_compressed(path, heap=g["heap"], recs=g["recs"], **{
        k: v for key in ("frame_mid", "frame_end", "carry_mid", "carry_end")
        for k, v in flatten_tree(g[key], key).items()}, **prologue_stereo())
    print(f"wrote {path}: the expansion of frames {HALF} and {FRAMES} and "
          f"the carries after them; the M/S prologue of {MS_FRAMES} frames")


def expand_streams() -> dict:
    """The JAX package's expand_frame_jax over the first QWIRE_FRAMES
    frames of streams 0..QWIRE_STREAMS-1 of each QWIRE_KINDS kind, as its
    QwirePipelinedDecoder parses them, eagerly, from fresh carries ->
    {kind: dict(heap, recs, frame_{f}: (core_meta, plan, pc, carry))}."""
    sys.path.insert(0, REPO)
    import jax.numpy as jnp
    from heaac_tpu.codec import qwire
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    out = {}
    for kind, pat in QWIRE_KINDS.items():
        streams = [open(os.path.join(REPO, pat.format(i)), "rb").read()
                   for i in range(QWIRE_STREAMS)]
        dec = QwirePipelinedDecoder(streams, group_streams=QWIRE_STREAMS,
                                    max_frames=QWIRE_FRAMES)
        heap, cur, recs = dec._parse_group(streams, 0, QWIRE_FRAMES)
        heap = heap[:cur + 4096].copy()
        recs = recs[:QWIRE_FRAMES].copy()
        jheap = jnp.asarray(heap.astype(np.int32))
        qc = qwire.init_qcarry(dec.L)
        g = dict(heap=heap, recs=recs)
        for f in range(QWIRE_FRAMES):
            res = qwire.expand_frame_jax(jheap, jnp.asarray(recs[f]), qc,
                                         dec.is34, 0)
            g[f"frame_{f}"] = _numpy_tree(res)
            qc = res[3]
        out[kind] = g
    return out


def write_qwire_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(QWIRE_GOLDEN))
    z = {}
    for kind, g in expand_streams().items():
        z.update(flatten_tree(g, kind))
    np.savez_compressed(path, **z)
    print(f"wrote {path}: expand_frame_jax over {QWIRE_FRAMES} frames of "
          f"{QWIRE_STREAMS} streams of {', '.join(QWIRE_KINDS)}")


def flip_streams(repo: str = REPO) -> list:
    """The flip streams as [(name, bytes)]."""
    return [(name, open(os.path.join(repo, rel), "rb").read())
            for name, rel in FLIP_FILES]


def jax_flip_pack(data: bytes, frames: int):
    """The JAX package's planner parse of a flip stream packed as its
    decode_qwire_flip_stream packs it -> (heap uint8, recs [T, nl, 4],
    static args of the flip scan (ds, S, rate_idx, NB, NS, SEC, RP))."""
    from heaac_tpu.bitstream.adts import parse_adts_header
    from heaac_tpu.bitstream.reader import BitReader
    from heaac_tpu.codec import qwire
    from heaac_tpu.codec.batch import parse_stream_qwire
    frames_q, _, nl, _, ds = parse_stream_qwire(data, max_frames=frames,
                                                is34_out=[])
    heap = bytearray()
    recs = np.zeros((len(frames_q), nl, qwire.REC_W), np.int32)
    for t, fr in enumerate(frames_q):
        for ln, (payload, rec) in enumerate(fr):
            recs[t, ln] = rec
            recs[t, ln, qwire.R_TOKOFF] = len(heap)
            heap += payload
    heap += bytes(-len(heap) % 4)
    heap = np.frombuffer(bytes(heap), np.uint8)
    S = -(-max(64, int((recs[..., qwire.R_W1] & 0xFFFF).max())) // 64) * 64
    sa = qwire.spec_static_args(recs)
    rate_idx = parse_adts_header(BitReader(data[:7])).sampling_index
    return heap, recs, (ds, S, rate_idx, sa["NB"], sa["NS"], sa["SEC"],
                        qwire.rows_pair_static(heap, recs))


def flip_golden() -> dict:
    sys.path.insert(0, REPO)
    import jax.numpy as jnp
    from heaac_tpu.codec import heaac_graph as jg
    from heaac_tpu.codec import qwire
    from heaac_tpu.codec.batch import (decode_qwire_flip_stream,
                                       parse_stream_qwire)
    named = dict(flip_streams())
    z = {}
    for name, data in named.items():
        trail = []
        parse_stream_qwire(data, max_frames=FRAMES, is34_out=trail)
        z[f"trail_{name}"] = np.array(trail, np.int32)
        z[f"pcm_{name}"] = np.asarray(
            decode_qwire_flip_stream(data, max_frames=FRAMES), np.int16)
        print(f"flip golden {name}: trail {trail}", flush=True)
    for i, f in FLIP_EXPAND.items():
        heap, recs, _ = jax_flip_pack(named[f"flip_{i}"], f + 2)
        jheap = jnp.asarray(heap.astype(np.int32))
        qc = qwire.init_qcarry(recs.shape[1])
        g = dict(heap=heap, recs=recs)
        for k in range(f + 2):
            if k == f:
                g[f"carry_{k - 1}"] = _numpy_tree(qc)
            res = qwire.expand_frame_jax(jheap, jnp.asarray(recs[k]), qc,
                                         -1, 0)
            qc = res[3]
            if k >= f:
                g[f"frame_{k}"] = _numpy_tree(res[:3])
                g[f"carry_{k}"] = _numpy_tree(qc)
        z.update(flatten_tree(g, f"expand_{i}"))
    heap, recs, static = jax_flip_pack(named[f"flip_{FLIP_CARRY_STREAM}"],
                                       FRAMES)
    run = jg.qwire_scan_decoder_flip(*static)
    carry, _ = run(jnp.asarray(heap.view(np.float32)),
                   jnp.asarray(recs[:FLIP_CARRY_FRAMES].view(np.float32)),
                   jg.init_qwire_flip_carry(recs.shape[1]))
    z.update(flatten_tree(_numpy_tree(carry), "scan_carry"))
    z.update(scan_heap=heap, scan_recs=recs, scan_static=np.array(static))
    return z


def write_flip_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(FLIP_GOLDEN))
    np.savez_compressed(path, **flip_golden())
    print(f"wrote {path}: decode_qwire_flip_stream PCM of {len(FLIP_FILES)} "
          f"flip streams over {FRAMES} frames, expand_frame_jax(is34=-1) "
          "around the first flips of streams 0 and 1, and the flip scan's "
          f"carry after {FLIP_CARRY_FRAMES} frames of stream "
          f"{FLIP_CARRY_STREAM}")


def batch_golden() -> dict:
    sys.path.insert(0, REPO)
    from heaac_tpu.codec.batch import decode_batch
    named = batch_streams()
    outs = decode_batch([data for _, data in named])
    z = {"names": np.array([name for name, _ in named])}
    for k, ((name, _), pcm) in enumerate(zip(named, outs)):
        pcm = np.asarray(pcm).astype(np.int16)
        z[f"pcm_{k}"] = pcm[:FRAMES * frame_samples(name)]
        z[f"n_{k}"] = np.int64(pcm.shape[0])
    return z


def corrupted(name: str, repo: str = REPO) -> bytes:
    """A CORRUPT stream: its file with one byte of one frame inverted."""
    rel, frame, pos = CORRUPT[name]
    with open(os.path.join(repo, rel), "rb") as f:
        data = bytearray(f.read())
    off = 0
    for _ in range(frame):                    # ADTS frame_length field
        off += ((data[off + 3] & 3) << 11) | (data[off + 4] << 3) \
            | (data[off + 5] >> 5)
    data[off + pos] ^= 0xFF
    return bytes(data)


def named_stream(name: str, repo: str = REPO) -> bytes:
    """A stream of LC_LIST: a CORRUPT one, or tests/data/{name}.aac."""
    if name in CORRUPT:
        return corrupted(name, repo)
    with open(os.path.join(repo, "tests", "data", f"{name}.aac"), "rb") as f:
        return f.read()


def lc_streams(repo: str = REPO) -> list:
    """LC_LIST as [(name, bytes)]."""
    return [(name, named_stream(name, repo)) for name in LC_LIST]


def lc_golden() -> dict:
    import logging
    sys.path.insert(0, REPO)
    from heaac_tpu.codec.batch import decode_batch
    named = lc_streams()
    outs = decode_batch([data for _, data in named])
    z = {"names": np.array([name for name, _ in named])}
    for k, ((name, _), pcm) in enumerate(zip(named, outs)):
        pcm = np.asarray(pcm).astype(np.int16)
        z[f"pcm_{k}"] = pcm[:FRAMES * 1024 * (1 + name.startswith("he"))]
        z[f"n_{k}"] = np.int64(pcm.shape[0])

    class Fallbacks(logging.Handler):
        def __init__(self):
            super().__init__(logging.WARNING)
            self.seen = False

        def emit(self, record):
            self.seen |= "fell back to the single-stream decoder" \
                in record.getMessage()

    logger = logging.getLogger("heaac_tpu")
    for name in UNPORTED:
        h = Fallbacks()
        logger.addHandler(h)
        try:
            decode_batch([named_stream(name)])
        finally:
            logger.removeHandler(h)
        z[f"single_{name}"] = np.int64(h.seen)
    return z


def write_lc_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(LC_GOLDEN))
    z = lc_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{name} {z[f'pcm_{k}'].shape} of {int(z[f'n_{k}'])}"
        for k, name in enumerate(z["names"])) + "; single-stream fallback: "
        + ", ".join(f"{n} {int(z[f'single_{n}'])}" for n in UNPORTED))


def probe_streams(repo: str = REPO) -> list:
    """Every committed stream and the CORRUPT ones as [(name, bytes)]:
    names are paths relative to the repo, or CORRUPT keys."""
    import glob
    out = []
    for pat in ("benchdata/*.aac", "tests/data/*.aac"):
        for path in sorted(glob.glob(os.path.join(repo, pat))):
            with open(path, "rb") as f:
                out.append((os.path.relpath(path, repo), f.read()))
    return out + [(name, corrupted(name, repo)) for name in CORRUPT]


def jax_python_probe(data: bytes) -> tuple:
    """The JAX decode_batch's Python probe (batch.py:1791-1801), as
    written there."""
    from heaac_tpu.bitstream.adts import split_adts_stream
    from heaac_tpu.codec.decoder import Decoder
    probe = Decoder(adts_probe=data[:7])
    first = split_adts_stream(data)[0]
    try:
        probe.decode_frame(first)
        sbr_on = probe.m4ac.sbr == 1
        ps34 = any(el.sbr is not None and el.sbr.ps is not None
                   and el.sbr.ps.is34bands
                   for el in probe.elements.values())
    except Exception:
        sbr_on, ps34 = False, False
    return sbr_on, ps34


def write_probe_golden(out: str) -> None:
    sys.path.insert(0, REPO)
    path = os.path.join(out, os.path.basename(PROBE_GOLDEN))
    named = probe_streams()
    got = [jax_python_probe(data) for _, data in named]
    np.savez_compressed(
        path, names=np.array([name for name, _ in named]),
        sbr=np.array([int(a) for a, _ in got]),
        is34=np.array([int(b) for _, b in got]))
    print(f"wrote {path}: {len(named)} streams, " + ", ".join(
        f"{name} {tuple(map(int, g))}" for (name, _), g in zip(named, got)
        if name in CORRUPT))


def ds_streams(repo: str = REPO) -> tuple:
    """(the downsampled streams 0..DS_STREAMS-1 as bytes, their ASC)."""
    with open(os.path.join(repo, DS_ASC), "rb") as f:
        asc = f.read()
    return [open(os.path.join(repo, DS_FILE.format(i)), "rb").read()
            for i in range(DS_STREAMS)], asc


def ds_golden() -> dict:
    sys.path.insert(0, REPO)
    import jax.numpy as jnp
    from heaac_tpu.codec import heaac_graph as jg
    from heaac_tpu.codec import qwire
    from heaac_tpu.codec.batch import StreamBatchDecoder, parse_stream_qwire
    data, asc = ds_streams()
    # packed as the port's pack_planner_frames packs: the silence lane's
    # payload first, then each stream's frames in order
    sil_payload, _ = qwire.silence_lane()
    heap = bytearray(sil_payload)
    recs = np.zeros((FRAMES, len(data), qwire.REC_W), np.int32)
    for k, d in enumerate(data):
        frames_q, rate, nl, is34, ds = parse_stream_qwire(
            d, asc=asc, max_frames=FRAMES)
        if (rate, nl, is34, ds, len(frames_q)) != (24000, 1, 0, 1, FRAMES):
            raise SystemExit(f"downsampled stream {k}: {rate} Hz, {nl} "
                             f"lanes, is34 {is34}, ds {ds}")
        for t, fr in enumerate(frames_q):
            payload, rec = fr[0]
            recs[t, k] = rec
            recs[t, k, qwire.R_TOKOFF] = len(heap)
            heap += payload
    heap += bytes(-len(heap) % 4 + 4096)
    heap = np.frombuffer(bytes(heap), np.uint8)
    S = -(-max(64, int((recs[..., qwire.R_W1] & 0xFFFF).max())) // 64) * 64
    sa = qwire.spec_static_args(recs)
    rate_idx = 6
    static = (0, 1, S, rate_idx, sa["NB"], sa["MS"], sa["NS"], sa["SEC"],
              qwire.rows_pair_static(heap, recs))
    run = jg.qwire_scan_decoder(*static)
    carry = jg.init_qwire_carry(len(data))
    pcm, carries = [], []
    for half in (recs[:HALF], recs[HALF:]):
        carry, out = run(jnp.asarray(heap.view(np.float32)),
                         jnp.asarray(half.view(np.float32)), carry)
        pcm.append(np.asarray(out))
        carries.append(_numpy_tree(carry))
    pcm = np.concatenate(pcm).astype(np.int16)
    dense = np.asarray(StreamBatchDecoder(data, asc=asc,
                                          max_frames=FRAMES).decode())
    lsb = int(np.abs(pcm.astype(np.int32) - dense[:, :len(data)]).max())
    return dict(pcm=pcm, heap=heap, recs=recs, static=np.array(static),
                dense_lsb=np.int64(lsb), carry_mid=carries[0],
                carry_end=carries[1])


def write_ds_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(DS_GOLDEN))
    g = ds_golden()
    np.savez_compressed(
        path, **{k: g[k] for k in ("pcm", "heap", "recs", "static",
                                   "dense_lsb")},
        **flatten_tree(g["carry_mid"], "carry_mid"),
        **flatten_tree(g["carry_end"], "carry_end"))
    print(f"wrote {path}: pcm {g['pcm'].shape}, static {g['static']}, the "
          f"carries after frames {HALF} and {FRAMES}; qwire vs dense "
          f"{int(g['dense_lsb'])} LSB")


def write_scan_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(GOLDEN))
    g = golden_scan()
    np.savez_compressed(path, pcm=g["pcm"],
                        **flatten_tree(g["carry_mid"], "carry_mid"),
                        **flatten_tree(g["carry_end"], "carry_end"))
    print(f"wrote {path}: pcm {g['pcm'].shape} {g['pcm'].dtype} and the "
          "JAX carries after frames 8 and 16")


def write_batch_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(BATCH_GOLDEN))
    z = batch_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{name} {z[f'pcm_{k}'].shape} of {int(z[f'n_{k}'])}"
        for k, name in enumerate(z["names"])))


def single_stream(name: str, repo: str = REPO) -> bytes:
    """A SINGLE_LIST stream's bytes."""
    rel = dict(SINGLE_LIST)[name]
    if rel is None:
        return corrupted(name, repo)
    with open(os.path.join(repo, rel), "rb") as f:
        return f.read()


def single_golden() -> dict:
    sys.path.insert(0, REPO)
    from heaac_tpu.bitstream.adts import split_adts_stream
    from heaac_tpu.codec.decoder import Decoder
    from heaac_tpu.ops import ps_np
    runs = []
    real = ps_np.ps_apply

    def spy(ps, X, top):
        runs.append(int(ps.is34bands))
        return real(ps, X, top)

    ps_np.ps_apply = spy
    z = {"names": np.array([name for name, _ in SINGLE_LIST])}
    try:
        for name, _ in SINGLE_LIST:
            frames = split_adts_stream(single_stream(name))[:FRAMES]
            runs.clear()
            if name == "ds_0":
                with open(os.path.join(REPO, DS_ASC), "rb") as f:
                    dec = Decoder(asc=f.read())
                pcm = np.concatenate([dec.decode_frame(f[7:])
                                      for f in frames])
            else:
                dec = Decoder(adts_probe=frames[0][:7])
                pcm = dec.decode(b"".join(frames))
            z[f"pcm_{name}"] = np.asarray(pcm, np.int16)
            z[f"errors_{name}"] = np.int64(dec.error_count)
            z[f"rate_{name}"] = np.int64(dec.sample_rate)
            z[f"ps_{name}"] = np.array([runs.count(0), runs.count(1)])
    finally:
        ps_np.ps_apply = real
    return z


def write_single_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(SINGLE_GOLDEN))
    z = single_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{n} {z[f'pcm_{n}'].shape} errors {int(z[f'errors_{n}'])} "
        f"rate {int(z[f'rate_{n}'])} ps {z[f'ps_{n}'].tolist()}"
        for n in z["names"]))


def front_m4a(name: str, adts_to_asc, mux_m4a, frames: int = FRAMES,
              repo: str = REPO) -> bytes:
    """A FRONT_LIST input as .m4a bytes, its first ``frames`` frames,
    made with the given ADTS->ASC filter and muxer (the JAX package's,
    or the port's: they write the same bytes)."""
    rel, asc_kind = {n: (r, a) for n, r, a in FRONT_LIST}[name]
    with open(os.path.join(repo, rel), "rb") as f:
        data = f.read()
    asc, raw = adts_to_asc(data)
    raw = raw[:frames]
    if name.endswith("_bad_0"):
        k, pos = FRONT_CORRUPT
        bad = bytearray(raw[k])
        bad[pos] ^= 0xFF
        raw[k] = bytes(bad)
    if asc_kind is None:
        return mux_m4a(raw, asc, 24000, 1)
    if asc_kind == "explicit":
        return mux_m4a(raw, EXPLICIT_SBR_ASC, 48000, 1, frame_samples=2048)
    with open(os.path.join(repo, asc_kind), "rb") as f:
        return mux_m4a(raw, f.read(), 24000, 1)


def front_golden(out: str) -> dict:
    """Writes the FRONT_LIST inputs into ``out`` and returns the golden."""
    import contextlib
    import functools
    import io
    import json
    sys.path.insert(0, REPO)
    import heaac_tpu
    from heaac_tpu import cli
    from heaac_tpu.bitstream.reader import BitstreamError, TracingBitReader
    from heaac_tpu.io.adts import adts_to_asc
    from heaac_tpu.io.mp4 import demux_m4a, mux_m4a

    made = []

    class Recorded(heaac_tpu.Decoder):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            made.append(self)

    def cli_probe(path: str) -> str:
        buf = io.StringIO()
        with contextlib.redirect_stdout(buf):
            assert cli.main(["-i", path, "--probe"]) == 0
        return buf.getvalue()

    z = {"names": np.array([name for name, _, _ in FRONT_LIST])}
    real = heaac_tpu.Decoder
    heaac_tpu.Decoder = Recorded
    try:
        for name, _, _ in FRONT_LIST:
            m4a = front_m4a(name, adts_to_asc, mux_m4a)
            path = os.path.join(out, os.path.basename(FRONT_FILE.format(name)))
            with open(path, "wb") as f:
                f.write(m4a)
            made.clear()
            pcm, rate = heaac_tpu.decode(m4a)
            z[f"pcm_{name}"] = np.asarray(pcm, np.int16)
            z[f"rate_{name}"] = np.int64(rate)
            z[f"errors_{name}"] = np.int64(made[-1].error_count)
            z[f"probe_main_{name}"] = np.array(cli_probe(path))
    finally:
        heaac_tpu.Decoder = real
    # the corrupted frame raises BitstreamError in the ASC-configured
    # Decoder (the port's test checks its own)
    t = demux_m4a(front_m4a("he20_explicit_bad_0", adts_to_asc, mux_m4a))
    dec = real(asc=t.asc)
    k = FRONT_CORRUPT[0]
    for f in t.frames[:k]:
        dec.decode_frame(f)
    try:
        dec.decode_frame(t.frames[k])
        raise AssertionError("the corrupted frame decoded")
    except BitstreamError:
        pass
    for name, rel in FRONT_ADTS:
        with open(os.path.join(REPO, rel), "rb") as f:
            data = f.read()
        z[f"probe_{name}"] = np.array(json.dumps(cli.probe(data)))
        z[f"probe_main_{name}"] = np.array(cli_probe(os.path.join(REPO,
                                                                  rel)))
    reads = []
    with open(os.path.join(REPO, TRACE_FILE), "rb") as f:
        head = f.read()
    from heaac_tpu.bitstream.adts import split_adts_stream
    head = b"".join(split_adts_stream(head)[:TRACE_FRAMES])
    dec = real(adts_probe=head[:7], bitreader_cls=functools.partial(
        TracingBitReader, sink=lambda pos, n, v: reads.append((pos, n, v))))
    dec.decode(head)
    # a skip's value is as wide as the skip: the values as hex strings
    z["trace"] = np.array([(pos, n) for pos, n, _ in reads], np.int64)
    z["trace_values"] = np.array([f"{v:x}" for _, _, v in reads])
    return z


def write_front_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(FRONT_GOLDEN))
    z = front_golden(out)
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{n} {z[f'pcm_{n}'].shape} rate {int(z[f'rate_{n}'])} errors "
        f"{int(z[f'errors_{n}'])}" for n in z["names"])
        + f"; trace {z['trace'].shape}")


def sharded_streams(case: str, repo: str = REPO) -> list:
    """A SHARDED_CASES case's streams as bytes."""
    return [open(os.path.join(repo, pat.format(i)), "rb").read()
            for pat, idxs, _ in [SHARDED_CASES[case]] for i in idxs]


def multihost_streams(repo: str = REPO) -> list:
    """The multihost test's streams: the first MULTIHOST_FRAMES ADTS
    frames of each of MULTIHOST_STREAMS bench streams."""
    from heaac_tpu_torch.host import split_adts_stream
    return [b"".join(split_adts_stream(d)[:MULTIHOST_FRAMES])
            for d in sharded_streams("he20", repo)[:MULTIHOST_STREAMS]]


def sharded_golden() -> dict:
    """Its ShardedQwireDecoder on the 8-device CPU mesh over each
    SHARDED_CASES case, and over SHARDED_ERRORS twice; its
    QwirePipelinedDecoder over each round-robin half of
    ``multihost_streams()``."""
    sys.path.insert(0, REPO)
    import jax
    if jax.device_count() < 8:
        raise RuntimeError("the sharded golden needs 8 XLA devices: run "
                           "its writer alone (main sets XLA_FLAGS)")
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    from heaac_tpu.parallel.sharding import ShardedQwireDecoder, make_mesh
    z = {}
    for case, (_, _, ndev) in SHARDED_CASES.items():
        dec = ShardedQwireDecoder(sharded_streams(case), mesh=make_mesh(ndev),
                                  max_frames=FRAMES)
        outs = dec.decode()
        z[f"pcm_{case}"] = np.asarray(outs[0]).astype(np.int16)
        z[f"frames_{case}"] = np.array(dec.inner.frame_counts)
        z[f"errors_{case}"] = np.int64(dec.inner.error_count)
    files, frames = SHARDED_ERRORS
    streams = [corrupted(f) if f in CORRUPT else
               open(os.path.join(REPO, f), "rb").read() for f in files]
    dec = ShardedQwireDecoder(streams, mesh=make_mesh(2), group_streams=2,
                              max_frames=frames)
    errors = []
    for _ in range(2):
        dec.decode()
        errors.append(dec.inner.error_count)
    z["errors_short_group"] = np.array(errors)
    streams = multihost_streams()
    for rank in range(2):
        half = streams[rank::2]
        dec = QwirePipelinedDecoder(half, group_streams=len(half))
        jax.block_until_ready(dec.decode())
        z[f"multihost_frames_{rank}"] = np.array(dec.frame_counts)
        z[f"multihost_errors_{rank}"] = np.int64(dec.error_count)
        z[f"multihost_audio_{rank}"] = np.float64(dec.audio_seconds())
    return z


def write_sharded_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(SHARDED_GOLDEN))
    z = sharded_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{c} {z[f'pcm_{c}'].shape} on {SHARDED_CASES[c][2]} devices"
        for c in SHARDED_CASES) + "; short last group's error_count over "
        f"two decode() calls {z['errors_short_group'].tolist()}; multihost "
        "frames " + ", ".join(str(z[f"multihost_frames_{r}"].tolist())
                              for r in range(2)))


def encode_frames(name: str) -> int:
    _, ch, _, kw = ENCODE_CASES[name]
    return ENCODE_FRAMES["bitrate" in kw, ch]


def encode_pcm(name: str) -> np.ndarray:
    """ENCODE_CASES case ``name``'s int16 [n, ch] input, made from a seed
    (its index in ENCODE_CASES): encode_frames(name) ADTS frames."""
    rate, ch, signal, _ = ENCODE_CASES[name]
    n = (encode_frames(name) - 1) * 1024
    rng = np.random.default_rng(list(ENCODE_CASES).index(name))
    t = np.arange(n) / rate
    x = np.stack([0.5 * np.sin(2 * np.pi * (440 + 210 * c) * t)
                  + 0.2 * np.sin(2 * np.pi * (1500 + 80 * c) * t)
                  + 0.001 * rng.standard_normal(n) for c in range(ch)], -1)
    if signal == "bursts":
        for p in range(1536, n - 96, 3072):
            x[p:p + 96] += (np.hanning(96)[:, None]
                            * rng.standard_normal((96, ch)) * 0.2)
    return np.clip(x * 14000, -32768, 32767).astype(np.int16)


def encode_case(name: str, encoder_cls, pcm: np.ndarray) -> bytes:
    """``encoder_cls`` (the JAX or the port's AacEncoder) over ``pcm``
    with case ``name``'s rate, channels and options."""
    rate, ch, _, kw = ENCODE_CASES[name]
    return encoder_cls(rate, ch, **kw).encode(pcm)


def bench_cores(repo: str = REPO) -> list:
    return [open(os.path.join(repo, "benchdata", f"lc_core_24k_{i}.aac"),
                 "rb").read() for i in range(8)]


def encode_golden() -> dict:
    """Its AacEncoder over every ENCODE_CASES case and the sha256 of its
    generators' first DISTINCT_GOLDEN_N distinct streams."""
    import hashlib
    import json
    sys.path.insert(0, REPO)
    from heaac_tpu.codec.encoder import AacEncoder
    from heaac_tpu.io import heaac_testgen
    from heaac_tpu_torch.io.heaac_testgen import distinct_stream
    z = {"cases": np.array(json.dumps(ENCODE_CASES, sort_keys=True))}
    for name in ENCODE_CASES:
        z[f"pcm_{name}"] = encode_pcm(name)
        z[f"adts_{name}"] = np.frombuffer(
            encode_case(name, AacEncoder, z[f"pcm_{name}"]), np.uint8)
    cores = bench_cores()
    z["distinct_sha256"] = np.array([
        hashlib.sha256(distinct_stream(cores, i, gen=heaac_testgen))
        .hexdigest()
        for i in range(DISTINCT_GOLDEN_N)])
    return z


def write_encode_golden(out: str) -> None:
    path = os.path.join(out, os.path.basename(ENCODE_GOLDEN))
    z = encode_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{n} {len(z[f'adts_{n}'])} bytes" for n in ENCODE_CASES)
        + f"; {DISTINCT_GOLDEN_N} distinct streams' sha256")


WRITERS = {"scan": write_scan_golden, "batch": write_batch_golden,
           "stereo": write_stereo_golden, "qwire": write_qwire_golden,
           "flip": write_flip_golden, "lc": write_lc_golden,
           "probe": write_probe_golden, "ds": write_ds_golden,
           "single": write_single_golden, "front": write_front_golden,
           "sharded": write_sharded_golden, "encode": write_encode_golden}


def main() -> None:
    args = sys.argv[1:]
    out = DATA if not args or args[0] in WRITERS else args.pop(0)
    os.makedirs(out, exist_ok=True)
    # the sharded golden's 8-device CPU mesh; set before jax is imported
    flags = os.environ.get("XLA_FLAGS", "")
    if "host_platform_device_count" not in flags:
        os.environ["XLA_FLAGS"] = (
            flags + " --xla_force_host_platform_device_count=8").strip()
    for name in args or WRITERS:
        WRITERS[name](out)


if __name__ == "__main__":
    main()
