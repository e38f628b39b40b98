#!/usr/bin/env python
"""Write the JAX reference of the plan-record decoders for the PyTorch
port's checks.

    JAX_PLATFORMS=cpu python tools/make_torch_plan_golden.py [out_dir]

Writes tests/data/plan_golden_jax.npz (or into out_dir), all from the
JAX package on the CPU (~15 min: each decoder compiles its own scan):

  {kind}_{mode}/pcm        its StreamBatchDecoder (mode compact or dense)
      over streams 0-1 of each KINDS kind, first FRAMES frames: int16
      [FRAMES, lanes, 2, N]; ``/frame_counts``, ``/lanes``, ``/is34``,
      ``/ds``, ``/rate``;
  {kind}/err_frames        its native compact parse's corrupt-frame
      count of each stream (kinds without an ASC);
  pipelined/pcm            its PipelinedStreamBatchDecoder over bench
      streams 0-1 in one group, FRAMES frames (``/frame_counts``); the
      port has no counterpart, so no test reads it;
  batch_decoder_error_{i}  what its BatchDecoder(bench stream i,
      batch=2).warmup() raises: the JAX class tiles a frame's plans to
      [B, lanes, ...], which its frame graph refuses (a reference fault:
      the port's BatchDecoder is held to the dense StreamBatchDecoder);
  graft/pcm                its heaac_frame_compact, one frame, on the
      synthetic compact records of __graft_entry__.entry() at GRAFT_B
      lanes (``graft_compact_inputs``), float32 [GRAFT_B, 2, 2048];
  expand/{field}           its compact_plan.expand_sbr (eager) of the
      native compact records of bench streams 0-1, first EXPAND_FRAMES
      frames: [EXPAND_FRAMES, 2, ...].

tests/test_torch_plans.py, tests/test_torch_nojax.py,
tests/test_torch_sharding.py and chip_smoke.py phase 13 read it.
"""
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PLAN_GOLDEN = os.path.join(REPO, "tests", "data", "plan_golden_jax.npz")
FRAMES = 16
EXPAND_FRAMES = 4
GRAFT_B = 4
DS_ASC = "tests/data/heaac_ds.asc"
# kind -> (file pattern, streams, AudioSpecificConfig file or None)
KINDS = {
    "he20": ("benchdata/heaac_bench_stream_{}.aac", (0, 1), None),
    "he34": ("tests/data/heaac_v2_34band_{}.aac", (0, 1), None),
    "he_v1s": ("tests/data/heaac_v1_stereo_{}.aac", (0, 1), None),
    "ds": ("tests/data/heaac_ds_{}.aac", (0, 1), DS_ASC),
}
MODES = ("compact", "dense")


def kind_streams(kind: str, repo: str = REPO) -> tuple:
    """(streams as bytes, ASC bytes or None) of a KINDS kind."""
    pat, idxs, asc = KINDS[kind]
    streams = [open(os.path.join(repo, pat.format(i)), "rb").read()
               for i in idxs]
    if asc is not None:
        asc = open(os.path.join(repo, asc), "rb").read()
    return streams, asc


def graft_compact_inputs(cp, B: int) -> tuple:
    """The synthetic inputs of __graft_entry__.entry() (core dict, sc
    dict, pc dict with a leading lane axis of B), built with ``cp``:
    either package's ``codec/compact_plan`` module (they share the slot
    names)."""
    rng = np.random.default_rng(0)
    core = dict(
        coeffs=rng.standard_normal((B, 1024)).astype(np.float32),
        ws=np.zeros(B, np.int32), wsp=np.zeros(B, np.int32),
        kbd=np.ones(B, np.int32), kbdp=np.ones(B, np.int32))
    sc = cp.zeros_compact()
    kx, m1 = 13, 25
    ci = sc["sc_i"]
    ci[cp.I_START] = 1
    ci[cp.I_KX0] = ci[cp.I_KX1] = kx
    ci[cp.I_M0] = ci[cp.I_M1] = m1
    ci[cp.I_NE] = 2
    ci[cp.I_TENV:cp.I_TENV + 6] = [0, 16, 32, 32, 32, 32]
    sc["sc_b"][cp.B_SRC:cp.B_SRC + m1] = (np.arange(m1) % kx).astype(np.int8)
    sc["sc_b"][cp.B_PB_LO:cp.B_PB_LO + 96] = np.tile(
        np.arange(48, dtype=np.int8), 2)
    sc["sc_b"][cp.B_LIMB:cp.B_LIMB + m1] = 0
    cf = sc["sc_f"]
    cf[cp.F_EORIG:cp.F_EORIG + 96] = 1e6
    cf[cp.F_QMAP:cp.F_QMAP + 96] = 2.0
    cf[cp.F_BW:cp.F_BW + 5] = 0.75
    cf[cp.F_RECIP:cp.F_RECIP + 2] = 0.5 / 16
    cf[cp.F_IWLO:cp.F_IWLO + 96] = 1.0
    cf[cp.F_LIMG] = 1.0
    pc = cp.zeros_ps_compact()
    pc["pc_i"][cp.PI_ON] = 1
    pc["pc_i"][cp.PI_NENV] = 1
    pc["pc_i"][cp.PI_TOP] = kx + m1
    pc["pc_i"][cp.PI_BORD] = -1
    pc["pc_i"][cp.PI_BORD + 1] = 31
    tile = lambda d: {k: np.broadcast_to(v[None], (B,) + v.shape).copy()
                      for k, v in d.items()}
    return core, tile(sc), tile(pc)


def plan_golden() -> dict:
    sys.path.insert(0, REPO)
    import jax

    from heaac_tpu import native
    from heaac_tpu.codec import compact_plan
    from heaac_tpu.codec.batch import (BatchDecoder,
                                       PipelinedStreamBatchDecoder,
                                       StreamBatchDecoder,
                                       parse_stream_plans)
    from heaac_tpu.codec.heaac_graph import (heaac_frame_compact,
                                             init_compact_state)
    from heaac_tpu_torch.host import parse_adts_header
    z = {}
    for kind in KINDS:
        streams, asc = kind_streams(kind)
        for mode in MODES:
            dec = StreamBatchDecoder(streams, asc=asc, max_frames=FRAMES,
                                     compact=mode == "compact")
            p = f"{kind}_{mode}"
            z[f"{p}/pcm"] = np.asarray(dec.decode()).astype(np.int16)
            z[f"{p}/frame_counts"] = np.array(dec.frame_counts)
            z[f"{p}/lanes"] = np.int64(dec.lanes_per_stream)
            z[f"{p}/is34"] = np.int64(dec.is34)
            z[f"{p}/ds"] = np.int64(dec.ds)
            z[f"{p}/rate"] = np.int64(dec.sample_rate)
            print(f"{p}: {z[f'{p}/pcm'].shape}", flush=True)
        if asc is None:
            errs = []
            for s in streams:
                h = parse_adts_header(s[:7])
                r = native.parse_he_stream_compact(
                    s, h.sampling_index, h.sample_rate, h.chan_config,
                    FRAMES)
                errs.append(r[3]["err_frames"])
            z[f"{kind}/err_frames"] = np.array(errs)
    bench, _ = kind_streams("he20")
    dec = PipelinedStreamBatchDecoder(bench, group_streams=len(bench),
                                      max_frames=FRAMES)
    outs = dec.decode()
    z["pipelined/pcm"] = np.asarray(outs[0]).astype(np.int16)
    z["pipelined/frame_counts"] = np.array(dec.frame_counts)
    for i, s in enumerate(bench):
        try:
            BatchDecoder(s, batch=2).warmup()
            z[f"batch_decoder_error_{i}"] = np.array("")
        except Exception as e:  # noqa: BLE001 - the fault is recorded
            z[f"batch_decoder_error_{i}"] = np.array(
                f"{type(e).__name__}: {str(e).splitlines()[0]}")
        print(f"BatchDecoder(stream {i}): "
              f"{z[f'batch_decoder_error_{i}']}", flush=True)
    core, sc, pc = graft_compact_inputs(compact_plan, GRAFT_B)
    step = jax.jit(heaac_frame_compact, static_argnums=(4, 5))
    pcm, _ = step(core, sc, pc, init_compact_state(GRAFT_B), 0, 0)
    z["graft/pcm"] = np.asarray(pcm)
    core, sbr, ps, *_ = parse_stream_plans(bench[0], max_frames=FRAMES,
                                           compact=True)
    core1, sbr1, *_ = parse_stream_plans(bench[1], max_frames=FRAMES,
                                         compact=True)
    frames = []
    for t in range(EXPAND_FRAMES):
        sc_t = {k: np.concatenate([sbr[k][t], sbr1[k][t]]) for k in sbr}
        frames.append({k: np.asarray(v)
                       for k, v in compact_plan.expand_sbr(sc_t).items()})
    for k in frames[0]:
        z[f"expand/{k}"] = np.stack([f[k] for f in frames])
    return z


def main() -> None:
    out = sys.argv[1] if len(sys.argv) > 1 else os.path.dirname(PLAN_GOLDEN)
    os.makedirs(out, exist_ok=True)
    path = os.path.join(out, os.path.basename(PLAN_GOLDEN))
    z = plan_golden()
    np.savez_compressed(path, **z)
    print(f"wrote {path}: {os.path.getsize(path)} bytes, {len(z)} arrays")


if __name__ == "__main__":
    main()
