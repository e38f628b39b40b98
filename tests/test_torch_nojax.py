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
against tests/data/front_golden_jax.npz; then imports both modules of
the parallel layer and decodes two frames of two benchdata streams with
``ShardedQwireDecoder`` over two CPU "devices", against the first
golden; then encodes one case of tests/data/encode_golden_jax.npz with
the port's AacEncoder and makes the first distinct HE-AAC v2 stream
with its generators (``splice_sbr_into_lc`` with an SBR and a PS
writer), equal to the JAX encoder's bytes and the JAX generators'
sha256 in that golden; then decodes two benchdata streams (4 frames)
with the plan-record decoder ``StreamBatchDecoder`` (compact and dense
plans), against tests/data/plan_golden_jax.npz; then imports the benchmark entry
``heaac_tpu_torch.bench`` and its gate ``heaac_tpu_torch.bench_gate``
(importing the repo root's ``bench.py`` fails there too)."""
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CODE = r"""
import sys
sys.modules["jax"] = None
sys.modules["heaac_tpu"] = None
sys.modules["bench"] = None          # the repo root's bench.py
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
from heaac_tpu_torch.parallel import multihost  # noqa: F401
from heaac_tpu_torch.parallel.sharding import ShardedQwireDecoder
shpcm = ShardedQwireDecoder([data, data], devices=["cpu", "cpu"],
                            max_frames=2).decode()[0].numpy()
shdiff = int(np.abs(shpcm.astype(np.int32) - gold[:2, [0, 0]]).max())
print("SHARDED", shpcm.shape, shdiff <= 2)
import hashlib, importlib.util
from heaac_tpu_torch.codec.encoder import AacEncoder
from heaac_tpu_torch.io import heaac_testgen
spec = importlib.util.spec_from_file_location(
    "make_torch_golden", REPO + "/tools/make_torch_golden.py")
tool = importlib.util.module_from_spec(spec)
spec.loader.exec_module(tool)
egold = np.load(tool.ENCODE_GOLDEN)
adts = tool.encode_case("lc_mono_24k", AacEncoder, egold["pcm_lc_mono_24k"])
he = heaac_testgen.distinct_stream(tool.bench_cores(REPO), 0)
print("ENCODE", adts == egold["adts_lc_mono_24k"].tobytes(),
      hashlib.sha256(he).hexdigest() == str(egold["distinct_sha256"][0]))
from heaac_tpu_torch.codec.batch import StreamBatchDecoder
bench2 = [data, open(REPO + "/benchdata/heaac_bench_stream_1.aac",
                     "rb").read()]
pgold = np.load(REPO + "/tests/data/plan_golden_jax.npz")
plans = [StreamBatchDecoder(bench2, max_frames=4, compact=c,
                            device="cpu").decode().numpy()
         for c in (True, False)]
pdiff = max(int(np.abs(p.astype(np.int32) - pgold[k][:4]).max())
            for p, k in zip(plans, ("he20_compact/pcm", "he20_dense/pcm")))
print("PLANS", [p.shape for p in plans], pdiff <= 2)
from heaac_tpu_torch import bench, bench_gate
print("BENCH", bench.METRIC, bench_gate.GATED)
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
    sharded = [x for x in r.stdout.splitlines() if x.startswith("SHARDED")][0]
    assert sharded == "SHARDED (2, 2, 2, 2048) True", sharded
    encode = [x for x in r.stdout.splitlines() if x.startswith("ENCODE")][0]
    assert encode == "ENCODE True True", encode
    plans = [x for x in r.stdout.splitlines() if x.startswith("PLANS")][0]
    assert plans == "PLANS [(4, 2, 2, 2048), (4, 2, 2, 2048)] True", plans
    bline = [x for x in r.stdout.splitlines() if x.startswith("BENCH")][0]
    assert bline == ("BENCH sustained_end_to_end_realtime_factor_heaacv2_48k"
                     "_per_chip ['value', 'parse_only_x', 'device_only_x']"), \
        bline
