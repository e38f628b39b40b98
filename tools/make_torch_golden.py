#!/usr/bin/env python
"""Write the JAX reference's PCM for the PyTorch port's checks.

    JAX_PLATFORMS=cpu python tools/make_torch_golden.py [out_dir]

Writes two files into tests/data (or out_dir), both from the JAX package
on the CPU:

  heaac_v2_golden_jax.npz      benchdata/heaac_bench_stream_{0,1}.aac
      parsed by its QwirePipelinedDecoder and decoded by its qwire scan,
      first 16 frames each (``golden_scan``): pcm int16 [16, 2, 2, 2048]
      (frame, stream, channel, sample), and the scan's carry after frames
      8 and 16 (``carry_mid/...``, ``carry_end/...``: ``flatten_tree``).
  decode_batch_golden_jax.npz  its ``decode_batch`` over the mixed list
      of ``batch_streams()`` (20-band and 34-band HE-AAC v2, AAC-LC and a
      buffer with no sync word, interleaved): ``names`` [7], and per
      entry k ``pcm_k``, the first 16 frames' samples of its [n, ch]
      int16 output, and ``n_k``, its whole length n.

The 34-band streams come from tools/make_torch_streams.py.
chip_smoke.py holds the port's GPU output to both files;
tests/test_torch_golden.py regenerates the first and checks it, and
tests/test_torch_decode_batch.py holds the port's CPU decode_batch to
the second.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(REPO, "tests", "data")
GOLDEN = os.path.join(DATA, "heaac_v2_golden_jax.npz")
BATCH_GOLDEN = os.path.join(DATA, "decode_batch_golden_jax.npz")
STREAMS = (0, 1)
FRAMES = 16
HALF = FRAMES // 2
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
)
GARBAGE = bytes(range(0x20, 0x7F)) * 4    # printable bytes: no 0xFF


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
    """flatten_tree's inverse for one prefix of an npz; a carry comes back
    as the (state, ps_hist, qwire carry) tuple."""
    root: dict = {}
    for key in z.files if hasattr(z, "files") else z:
        if key.startswith(prefix + "/"):
            *path, leaf = key[len(prefix) + 1:].split("/")
            d = root
            for p in path:
                d = d.setdefault(p, {})
            d[leaf] = z[key]
    return tuple(root[str(i)] for i in range(len(root)))


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


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else DATA
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, os.path.basename(GOLDEN))
    g = golden_scan()
    np.savez_compressed(path, pcm=g["pcm"],
                        **flatten_tree(g["carry_mid"], "carry_mid"),
                        **flatten_tree(g["carry_end"], "carry_end"))
    print(f"wrote {path}: pcm {g['pcm'].shape} {g['pcm'].dtype} and the "
          "JAX carries after frames 8 and 16")
    path = os.path.join(out, os.path.basename(BATCH_GOLDEN))
    z = batch_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: " + ", ".join(
        f"{name} {z[f'pcm_{k}'].shape} of {int(z[f'n_{k}'])}"
        for k, name in enumerate(z["names"])))


if __name__ == "__main__":
    main()
