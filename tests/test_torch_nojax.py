"""The PyTorch port runs without jax: a fresh interpreter in which
importing ``jax`` or ``heaac_tpu`` fails imports heaac_tpu_torch,
decodes a benchdata stream on the CPU, and runs decode_batch on a
34-band HE-AAC v2, an AAC-LC, a stereo HE-AAC v1 and an HE-AAC stream
with a coupling channel applied after the IMDCT (4 frames each), then on
two streams whose PS band mode flips (the Python planner and the flip
scan): flip stream 3 (4 frames, a flip at frame 2) and the flip +
coupling-channel stream (8 frames, a flip at frame 6), against the JAX
golden (tests/data/flip_golden_jax.npz); then decode_batch on an AAC-LC
stream with a coupling channel (the LC planner, 4 frames) and the
downsampled scan on a downsampled-SBR stream parsed with its
AudioSpecificConfig (4 frames), against their JAX goldens; then
``decode_adts`` (the single-stream Decoder) on two frames of a benchdata
stream against the JAX Decoder's golden (tests/data/single_golden_jax.npz);
then ``decode`` on a committed .m4a (explicit SBR signalling: the
ASC-configured Decoder) and the command line's ``--probe`` on it,
against tests/data/front_golden_jax.npz."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
sys.modules["jax"] = None
sys.modules["heaac_tpu"] = None
sys.path.insert(0, REPO)
import numpy as np
from heaac_tpu_torch.codec.batch import QwirePipelinedDecoder
data = open(REPO + "/benchdata/heaac_bench_stream_0.aac", "rb").read()
pcm = QwirePipelinedDecoder([data], group_streams=1, max_frames=4,
                            device="cpu").decode()
pcm = pcm[0].numpy()
gold = np.load(REPO + "/tests/data/heaac_v2_golden_jax.npz")["pcm"]
diff = np.abs(pcm[:, 0].astype(np.int32) - gold[:4, 0]).max()
from heaac_tpu_torch import decode_batch
from heaac_tpu_torch.host import split_adts_stream
heads = [b"".join(split_adts_stream(open(REPO + f, "rb").read())[:4])
         for f in ("/tests/data/heaac_v2_34band_0.aac",
                   "/benchdata/lc_core_24k_0.aac",
                   "/tests/data/heaac_v1_stereo_0.aac",
                   "/tests/data/heaac_cce_after_0.aac")]
outs = decode_batch(heads, device="cpu")
print("BATCH", [tuple(o.shape) for o in outs],
      [int(o.abs().max()) > 0 for o in outs])
flips = [b"".join(split_adts_stream(open(REPO + f, "rb").read())[:k])
         for f, k in (("/tests/data/heaac_v2_flip_3.aac", 4),
                      ("/tests/data/heaac_flip_cce_0.aac", 8))]
fouts = decode_batch(flips, device="cpu")
fgold = np.load(REPO + "/tests/data/flip_golden_jax.npz")
fdiff = [int(np.abs(o.numpy().astype(np.int32)
                    - fgold["pcm_" + name][:len(o)]).max())
         for o, name in zip(fouts, ("flip_3", "flip_cce_0"))]
print("FLIP", [tuple(o.shape) for o in fouts], max(fdiff) <= 2)
lc = b"".join(split_adts_stream(
    open(REPO + "/tests/data/lc_cce_after_0.aac", "rb").read())[:4])
lout = decode_batch([lc], device="cpu")[0]
lgold = np.load(REPO + "/tests/data/lc_batch_golden_jax.npz")
k = list(lgold["names"]).index("lc_cce_after_0")
ldiff = int(np.abs(lout.numpy().astype(np.int32)
                   - lgold[f"pcm_{k}"][:len(lout)]).max())
import torch
from heaac_tpu_torch.codec import heaac_graph
from heaac_tpu_torch.codec.batch import pack_planner_frames
from heaac_tpu_torch.codec.planner import parse_stream_qwire
from heaac_tpu_torch.host import R_W1, spec_static_args
asc = open(REPO + "/tests/data/heaac_ds.asc", "rb").read()
ds = open(REPO + "/tests/data/heaac_ds_0.aac", "rb").read()
frames, _, _, _, dsflag = parse_stream_qwire(ds, asc=asc, max_frames=4)
heap, _, recs = pack_planner_frames([frames], 1, 4)
sa = spec_static_args(recs)
S = -(-max(64, int((recs[..., R_W1] & 0xFFFF).max())) // 64) * 64
_, dpcm = heaac_graph.qwire_scan_decode(
    torch.from_numpy(heap), torch.from_numpy(recs),
    heaac_graph.init_qwire_carry(1, "cpu"), 0, dsflag, S, 6, sa["NB"], 0,
    sa["NS"], sa["SEC"])
dgold = np.load(REPO + "/tests/data/downsampled_golden_jax.npz")["pcm"]
ddiff = int(np.abs(dpcm.numpy()[:, 0].astype(np.int32)
                   - dgold[:4, 0]).max())
print("LCDS", tuple(lout.shape), tuple(dpcm.shape),
      max(ldiff, ddiff) <= 2 and int(dpcm.abs().max()) > 1000)
from heaac_tpu_torch import decode_adts
head = b"".join(split_adts_stream(data)[:2])
spcm, srate = decode_adts(head, device="cpu")
sgold = np.load(REPO + "/tests/data/single_golden_jax.npz")["pcm_he20_0"]
sdiff = int(np.abs(spcm.numpy().astype(np.int32) - sgold[:len(spcm)]).max())
print("SINGLE", tuple(spcm.shape), srate,
      sdiff <= 2 and int(spcm.abs().max()) > 1000)
import contextlib, io, json
from heaac_tpu_torch import cli, decode
m4a = REPO + "/tests/data/front_he20_explicit_0.m4a"
mpcm, mrate = decode(open(m4a, "rb").read(), device="cpu")
fgold = np.load(REPO + "/tests/data/front_golden_jax.npz")
mdiff = int(np.abs(mpcm.numpy().astype(np.int32)
                   - fgold["pcm_he20_explicit_0"]).max())
out = io.StringIO()
with contextlib.redirect_stdout(out):
    rc = cli.main(["-i", m4a, "--probe"])
same = json.loads(out.getvalue()) == json.loads(
    str(fgold["probe_main_he20_explicit_0"]))
print("FRONT", tuple(mpcm.shape), mrate, mdiff <= 2, rc, same)
loaded = sorted(m for m in sys.modules if sys.modules[m] is not None
                and m.split(".")[0] in ("jax", "jaxlib", "heaac_tpu"))
print("RESULT", pcm.shape, int(np.abs(pcm).max()), int(diff), loaded)
"""


def test_port_decodes_without_jax():
    # one torch thread, as in the parity modules (test_torch_common)
    r = subprocess.run([sys.executable, "-c", f"REPO = {REPO!r}\n" + CODE],
                       capture_output=True, text=True, cwd=REPO, timeout=300,
                       env={**os.environ, "OMP_NUM_THREADS": "1"})
    assert r.returncode == 0, r.stderr[-3000:]
    line = [x for x in r.stdout.splitlines() if x.startswith("RESULT")][0]
    assert line.startswith("RESULT (4, 1, 2, 2048)"), line
    _, shape_end = line.split(")", 1)
    peak, diff, loaded = shape_end.split(maxsplit=2)
    assert int(peak) > 1000 and int(diff) <= 2 and loaded == "[]", line
    batch = [x for x in r.stdout.splitlines() if x.startswith("BATCH")][0]
    assert batch == ("BATCH [(8192, 2), (4096, 1), (8192, 2), (8192, 2)] "
                     "[True, True, True, True]"), batch
    flip = [x for x in r.stdout.splitlines() if x.startswith("FLIP")][0]
    assert flip == "FLIP [(8192, 2), (16384, 2)] True", flip
    lcds = [x for x in r.stdout.splitlines() if x.startswith("LCDS")][0]
    assert lcds == "LCDS (4096, 1) (4, 1, 2, 1024) True", lcds
    single = [x for x in r.stdout.splitlines() if x.startswith("SINGLE")][0]
    assert single == "SINGLE (4096, 2) 48000 True", single
    front = [x for x in r.stdout.splitlines() if x.startswith("FRONT")][0]
    assert front == "FRONT (32768, 2) 48000 True 0 True", front
