#!/usr/bin/env python
"""How far the JAX reference is from itself, and the port from it, on the
34-band HE-AAC v2 test streams (CPU, both packages).

    JAX_PLATFORMS=cpu python tools/torch_ref_noise.py [invf_modes]

invf_modes is the SBR inverse-filtering modes the streams are written
with, e.g. "0,1,2,3" (default: those of the committed streams, see
tools/make_torch_streams.py).  Prints, for the 8 streams' first 16
frames, each stream's max |JAX - port| in int16 LSB per frame (both
``decode_batch`` on the CPU); then, for stream 1, frame 8 of the JAX
frame graph from one carry, run jitted and eagerly (``jax.disable_jit``):
their difference is the reference's own rounding noise.
"""
import importlib.util
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FRAMES = 16
NOISE_STREAM, NOISE_FRAME = 1, 8


def _tool():
    spec = importlib.util.spec_from_file_location(
        "make_torch_streams", os.path.join(REPO, "tools",
                                           "make_torch_streams.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _pcm16(x) -> np.ndarray:
    return np.clip(np.rint(np.asarray(x)), -32768, 32767).astype(np.int32)


def eager_vs_jit(data: bytes, frame: int) -> int:
    """Max LSB between the jitted and the eager JAX frame graph on
    ``frame`` of one stream, from the jitted scan's carry before it."""
    import jax
    from heaac_tpu.codec import heaac_graph as jg
    from heaac_tpu.codec.batch import QwirePipelinedDecoder
    dec = QwirePipelinedDecoder([data], group_streams=1,
                                max_frames=frame + 1)
    heap, cur, recs = dec._parse_group([data], 0, frame + 1)
    heap = heap[:(cur + 3) // 4 * 4 + 4096]
    heap, rec_seq, coeffs = jax.jit(
        lambda h, r: jg._qwire_decode_all_coeffs(
            h, r, dec.S, dec.rate_idx, dec.NB, dec.MS, dec.NS, dec.SEC))(
        heap.view(np.float32), recs[:frame + 1].view(np.float32))

    def step(coef, rec, carry):
        return jg.heaac_frame_qwire(coef, rec, heap, carry, dec.is34,
                                    dec.ds, dec.RP)
    jstep = jax.jit(step)
    carry = jg.init_qwire_carry(dec.L)
    for f in range(frame):
        _, carry = jstep(coeffs[f], rec_seq[f], carry)
    pcm_jit, _ = jstep(coeffs[frame], rec_seq[frame], carry)
    with jax.disable_jit():
        pcm_eager, _ = step(coeffs[frame], rec_seq[frame], carry)
    return int(np.abs(_pcm16(pcm_jit) - _pcm16(pcm_eager)).max())


def main() -> None:
    sys.path.insert(0, REPO)
    from heaac_tpu.codec.batch import decode_batch as jax_decode_batch
    from heaac_tpu_torch import decode_batch
    from heaac_tpu_torch.host import split_adts_stream
    tool = _tool()
    invf = (tuple(int(m) for m in sys.argv[1].split(","))
            if len(sys.argv) > 1 else tool.INVF_MODES)
    streams = [b"".join(split_adts_stream(tool.make_stream(i, invf))[:FRAMES])
               for i in range(tool.N)]
    want = jax_decode_batch(streams)
    got = decode_batch(streams, device="cpu")
    print(f"invf_modes {invf}: max |JAX - port| LSB per frame, first "
          f"{FRAMES} frames")
    for i, (w, g) in enumerate(zip(want, got)):
        d = np.abs(np.asarray(w).astype(np.int32) - g.numpy())
        per_frame = d.reshape(FRAMES, -1).max(axis=1)
        print(f"stream {i}: max {int(per_frame.max())} {per_frame.tolist()}")
    print(f"stream {NOISE_STREAM} frame {NOISE_FRAME}: JAX jitted vs eager "
          f"max {eager_vs_jit(streams[NOISE_STREAM], NOISE_FRAME)} LSB")


if __name__ == "__main__":
    main()
