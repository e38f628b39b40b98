"""The port's single-stream Decoder on the CPU, stage by stage and whole.

Stages: each torch stage of ``ops/sbr_single.py`` and ``ops/ps_single.py``
against the live numpy function of the JAX package's single-stream path
(``heaac_tpu/ops/sbr_np.py``, ``ps_np.py``; pure numpy, no jit) on the
same inputs: seeded signals, and SBR / PS contexts parsed from real
streams by the port's parser (the numpy functions take the port's
contexts: the attribute names are the same).  Host parameter math
(sbr_dequant, chirp, mapping, the PS remaps and mixing matrices) is held
exact; float stages within a stated share of their peak (the two sides
sum in different orders; the PS mix interpolates each slot with one
division where the reference adds a step per slot).  K1 at B=1 (here its
plain version: the tensors are on the CPU) within 1e-6 relative of
``ps_np.decorrelation``.

Whole streams: every stream of tests/data/single_golden_jax.npz (the JAX
Decoder, tools/make_torch_golden.py ``single``) within 2 int16 LSB, with
the same dropped-frame count and sample rate, and K1 run once per frame
in which PS ran, per band mode.
"""
import copy

import numpy as np
import pytest
import torch

from heaac_tpu.ops import ps_np, sbr_np
from heaac_tpu_torch import decode_adts
from heaac_tpu_torch import tables as TB
from heaac_tpu_torch.bitstream import sbr_syntax
from heaac_tpu_torch.codec import decoder as decoder_mod
from heaac_tpu_torch.codec.decoder import Decoder
from heaac_tpu_torch.host import split_adts_stream
from heaac_tpu_torch.ops import ps as ps_ops
from heaac_tpu_torch.ops import ps_single, sbr_single
from test_torch_common import (  # noqa: F401 (autouse fixture)
    assert_peak_close, golden_tool, n, release_jax_memory, t)

TOL_LSB = 2
SBR_REL = 2e-5      # float SBR stages, share of the stage's peak
PS_MIX_REL = 2e-5   # the interpolated PS mix, share of its peak
K1_REL = 1e-6       # K1 output and state, share of each tensor's peak


class _Parse(Decoder):
    """The port's parser with no device: keeps a copy of every element's
    SBR context as each frame's parse leaves it."""

    def __init__(self, *a, **kw):
        super().__init__(*a, device=None, **kw)
        self.contexts = []

    def _spectral_to_sample(self, present):
        self.contexts.append({key: copy.deepcopy(el.sbr)
                              for key, el in self.elements.items()
                              if el.sbr is not None})


def _parsed(name: str, frames: int) -> tuple:
    """(the per-frame SBR contexts, the m4ac config) of a golden stream."""
    tool = golden_tool()
    data = split_adts_stream(tool.single_stream(name))[:frames]
    if name == "ds_0":
        with open(f"{tool.REPO}/{tool.DS_ASC}", "rb") as f:
            dec = _Parse(asc=f.read())
        for fr in data:
            dec.decode_frame(fr[7:])
    else:
        dec = _Parse(adts_probe=data[0][:7])
        for fr in data:
            dec.decode_frame(fr)
    return dec.contexts, dec.m4ac


def _frame_ctx(name, frame):
    """(key, SBR context) of the frame's first SBR element."""
    contexts, _ = _parsed(name, frame + 1)
    return next(iter(contexts[frame].items()))


def _dev(plan: dict) -> dict:
    return {k: (t(v) if isinstance(v, np.ndarray) else v)
            for k, v in plan.items()}


# (stream, frame): mono 20-band PS with a two-envelope grid, a coupled
# stereo CPE (the coupled dequantization), downsampled SBR from an ASC
CASES = [("he20_0", 3), ("he_v1s_1", 2), ("ds_0", 4)]


@pytest.mark.parametrize("name,frame", CASES)
def test_sbr_host_math_matches_numpy(name, frame):
    """sbr_dequant, chirp and mapping on a parsed context: exact."""
    key, sbr = _frame_ctx(name, frame)
    a, b = copy.deepcopy(sbr), copy.deepcopy(sbr)
    sbr_np.S.sbr_dequant(a, key[0])
    sbr_syntax.sbr_dequant(b, key[0])
    for ch in range(2 if key[0] == TB.TYPE_CPE else 1):
        da, db = a.data[ch], b.data[ch]
        np.testing.assert_array_equal(db.env_facs, da.env_facs)
        np.testing.assert_array_equal(db.noise_facs, da.noise_facs)
        sbr_np.chirp(a, da)
        sbr_single.chirp(b, db)
        np.testing.assert_array_equal(db.bw_array, da.bw_array)
        for x, y in zip(sbr_single.mapping(b, db, db.e_a),
                        sbr_np.mapping(a, da, da.e_a)):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(db.s_indexmapped, da.s_indexmapped)


@pytest.mark.parametrize("name,frame", CASES)
def test_sbr_stages_match_numpy(name, frame):
    """QMF analysis, lf_gen, hf_inverse_filter, hf_gen, env_estimate,
    gain_calc, hf_assemble, x_gen and the synthesis of one channel, on
    seeded signals over a parsed frame's grid, against sbr_np."""
    key, sbr = _frame_ctx(name, frame)
    rng = np.random.default_rng(frame)
    ref, mine = copy.deepcopy(sbr), copy.deepcopy(sbr)
    sbr_np.S.sbr_dequant(ref, key[0])
    d = ref.data[0]
    d.analysis_filterbank_samples[:] = rng.normal(0, 3000, 1312)
    d.W[:] = rng.normal(0, 1, d.W.shape)
    d.Y[:] = rng.normal(0, 50, d.Y.shape)
    d.g_temp[:] = rng.uniform(0, 2, d.g_temp.shape)
    d.q_temp[:] = rng.uniform(0, 2, d.q_temp.shape)
    d.f_indexnoise, d.f_indexsine = 301, 2
    d.bw_array[:] = [0.9, 0.75, 0.6, 0.98, 0.0]
    core = rng.normal(0, 3000, 1024).astype(np.float32)
    st = sbr_single.SbrState.zeros(1, "cpu")
    st.x_hist = t(d.analysis_filterbank_samples[1024:])[None]
    st.W = t(d.W[1])[None]
    st.Y0, st.Y1 = t(d.Y[0])[None], t(d.Y[1])[None]
    st.g_temp, st.q_temp = t(d.g_temp)[None], t(d.q_temp)[None]
    md = mine.data[0]
    md.bw_array[:] = d.bw_array
    for c in (mine.data[0], mine.data[1]):
        c.f_indexnoise, c.f_indexsine = 301, 2

    # numpy, as sbr_apply runs for channel 0
    sbr_np.qmf_analysis(core, d.analysis_filterbank_samples, d.W, 1.0)
    X_low = sbr_np.lf_gen(ref, d.W)
    alpha0, alpha1 = sbr_np.hf_inverse_filter(X_low, ref.k[0])
    sbr_np.chirp(ref, d)
    X_high = sbr_np.hf_gen(ref, X_low, alpha0, alpha1, d.bw_array, d.t_env,
                           d.bs_num_env)
    e_orig, q_mapped, s_mapped = sbr_np.mapping(ref, d, d.e_a)
    e_curr = sbr_np.env_estimate(X_high, ref, d)
    gain, q_m, s_m = sbr_np.gain_calc(ref, d, d.e_a, e_orig, q_mapped,
                                      s_mapped, e_curr)
    sbr_np.hf_assemble(d.Y, X_high, ref, d, d.e_a, gain, q_m, s_m)
    X = sbr_np.x_gen(ref, X_low, d.Y, 0)

    # the port, one channel
    nch = 2 if key[0] == TB.TYPE_CPE else 1
    plan = _dev({k: v[:1] for k, v in
                 sbr_single.prepare(mine, key[0], nch).items()})
    W, st.x_hist = sbr_single.qmf_analysis(t(core)[None], st.x_hist)
    assert_peak_close(W[0], d.W[1], SBR_REL, "W")
    xl = sbr_single.lf_gen(st.W, W, plan)
    assert_peak_close(xl[0], X_low, SBR_REL, "X_low")
    xl = t(X_low)[None]                 # each stage from numpy's input
    a0, a1 = sbr_single.hf_inverse_filter(xl)
    k0 = ref.k[0]
    assert_peak_close(a0[0, :k0], alpha0[:k0], SBR_REL, "alpha0")
    assert_peak_close(a1[0, :k0], alpha1[:k0], SBR_REL, "alpha1")
    np.testing.assert_array_equal(md.bw_array, d.bw_array)
    kx, m1 = ref.kx[1], ref.m[1]
    xh = sbr_single.hf_gen(xl, t(alpha0)[None], t(alpha1)[None], plan)
    assert_peak_close(xh[0, :m1], X_high[kx:kx + m1], SBR_REL, "X_high")
    xh = t(np.pad(X_high[kx:kx + 48], ((0, 48 - len(X_high[kx:kx + 48])),
                                       (0, 0), (0, 0))))[None]
    ec = sbr_single.env_estimate(xh, plan)
    ne = d.bs_num_env
    assert_peak_close(ec[0, :ne], e_curr[:ne], SBR_REL, "e_curr")
    g, qm, sm = sbr_single.gain_calc(t(e_curr[:5])[None], plan)
    for got, want, what in ((g, gain, "gain"), (qm, q_m, "q_m"),
                            (sm, s_m, "s_m")):
        assert_peak_close(got[0, :ne], want[:ne], SBR_REL, what)
    sbr_single.hf_assemble(xh, t(gain[:5])[None], t(q_m[:5])[None],
                           t(s_m[:5])[None], st, plan)
    assert_peak_close(st.Y1[0], d.Y[1], SBR_REL, "Y1")
    assert_peak_close(st.Y0[0], d.Y[0], 0.0, "Y0")
    assert_peak_close(st.g_temp[0], d.g_temp, SBR_REL, "g_temp")
    assert_peak_close(st.q_temp[0], d.q_temp, SBR_REL, "q_temp")
    assert n(st.index)[0].tolist() == [d.f_indexnoise, d.f_indexsine]
    Xp = sbr_single.x_gen(xl, st.Y0, st.Y1, plan)
    assert_peak_close(Xp[0], X, SBR_REL, "X")


@pytest.mark.parametrize("downsampled", [0, 1])
def test_qmf_synthesis_matches_numpy(downsampled):
    """Three frames through the synthesis FIFO from a zero state."""
    rng = np.random.default_rng(7 + downsampled)
    v0 = np.zeros(2304, np.float32)
    v_off = 2304 - (1280 - 128)
    v = torch.zeros((1, 9, 128))
    synth = sbr_single.qmf_synthesis_ds if downsampled \
        else sbr_single.qmf_synthesis
    for _ in range(3):
        X = rng.normal(0, 100, (2, 38, 64)).astype(np.float32)
        want, v_off = sbr_np.qmf_synthesis(X, v0, v_off, bool(downsampled))
        got, v = synth(t(X)[None], v)
        assert_peak_close(got[0], want, SBR_REL, "synthesis")


def _ps_state(ps, rng, is34: int):
    """Seeded numpy PS state, and the same state in K1's layout."""
    nb = TB.NR_BANDS[is34]
    npar = TB.NR_PAR_BANDS[is34]
    ps.in_buf[:] = rng.normal(0, 100, ps.in_buf.shape)
    ps.delay[:nb] = rng.normal(0, 100, (nb,) + ps.delay.shape[1:])
    ps.ap_delay[:] = rng.normal(0, 100, ps.ap_delay.shape)
    for arr in (ps.peak_decay_nrg, ps.power_smooth,
                ps.peak_decay_diff_smooth):
        arr[:npar] = rng.uniform(0, 1e4, npar)
    st = ps_single.PsState(
        in_buf=t(ps.in_buf[:, 0:6])[None],
        delay=t(ps.delay[:, 32:46])[None],
        ap=t(ps.ap_delay[:, :, 32:37])[None],
        trans=t(np.stack([ps.peak_decay_nrg, ps.power_smooth,
                          ps.peak_decay_diff_smooth], -1))[None])
    return st


@pytest.mark.parametrize("is34,reset", [(0, 0), (1, 0), (1, 1)])
def test_decorrelation_k1_at_one_lane_matches_numpy(is34, reset):
    """ps_np.decorrelation against ps_single.decorrelation (K1 through
    decorrelate_seq at B=1): the decorrelated bands and the carried
    delay lines, allpass rings and transient detector, within 1e-6 of
    each tensor's peak; ``reset``: the band mode differs from the last
    parse's, so both start from zero state."""
    rng = np.random.default_rng(11 + is34 + reset)
    ps = ps_np.PSContext()
    st = _ps_state(ps, rng, is34)
    ps.is34bands_old = is34 ^ reset
    s = np.zeros((91, 32, 2), np.float32)
    s[:TB.NR_BANDS[is34]] = rng.normal(0, 100, (TB.NR_BANDS[is34], 32, 2))
    calls = []
    real = ps_ops.decorrelate_seq

    def spy(*a):
        calls.append(tuple(a[0].shape) + (a[1].shape[1],))
        return real(*a)

    ps_ops.decorrelate_seq = spy
    try:
        plan = dict(reset=t(np.array([reset])), is34=is34,
                    top_mask=torch.ones((1, 91)))
        rbuf = ps_single.decorrelation(st, t(s)[None], plan)
    finally:
        ps_ops.decorrelate_seq = real
    want = ps_np.decorrelation(ps, s, is34)
    assert calls == [(1, 34, 32, TB.NR_ALLPASS_BANDS[is34])]
    assert_peak_close(rbuf[0], want, K1_REL, "rbuf")
    napb = TB.NR_ALLPASS_BANDS[is34]
    assert_peak_close(st.ap[0, :napb], ps.ap_delay[:napb, :, 32:37], K1_REL,
                      "ap")
    assert_peak_close(st.delay[0], ps.delay[:, 32:46], K1_REL, "delay")
    npar = TB.NR_PAR_BANDS[is34]
    for j, arr in enumerate((ps.peak_decay_nrg, ps.power_smooth,
                             ps.peak_decay_diff_smooth)):
        assert_peak_close(st.trans[0, :npar, j], arr[:npar], K1_REL,
                          f"trans {j}")


def _ps_contexts(name: str, frames: int) -> list:
    return [ctx.ps for c in _parsed(name, frames)[0] for ctx in c.values()
            if ctx.ps is not None and ctx.ps.start]


@pytest.mark.parametrize("name,frame", [("he20_0", 3), ("he34_0", 2),
                                        ("flip_0", 6)])
def test_ps_apply_matches_numpy(name, frame):
    """ps_np.ps_apply against prepare + ps_single.ps_apply on a parsed
    frame's PS context (flip_0 frame 6: the 20 -> 34 band-mode flip, with
    its state reset and H conversion) and seeded state and input: the
    hybrid bands, decorrelation, the mixing matrices (exact, and the IPD /
    OPD history) and the interpolated mix, and the carried state."""
    ps = _ps_contexts(name, frame + 1)[frame]
    is34 = int(ps.is34bands)
    rng = np.random.default_rng(frame)
    for H in (ps.H11, ps.H12, ps.H21, ps.H22):
        H[:] = rng.uniform(-1, 1, H.shape)
    ref, mine = copy.deepcopy(ps), copy.deepcopy(ps)
    st = _ps_state(ref, rng, is34)
    X = rng.normal(0, 100, (2, 38, 64)).astype(np.float32)
    top = 32 + 15
    L, R = ps_np.ps_apply(ref, X, top)
    plan = ps_single.prepare(mine, top)
    for a, b in ((mine.H11, ref.H11), (mine.H12, ref.H12),
                 (mine.H21, ref.H21), (mine.H22, ref.H22),
                 (mine.ipd_hist, ref.ipd_hist),
                 (mine.opd_hist, ref.opd_hist)):
        np.testing.assert_array_equal(a, b)
    Lp, Rp = ps_single.ps_apply(st, t(X)[None], _dev(plan))
    assert_peak_close(Lp[0], L, PS_MIX_REL, "L")
    assert_peak_close(Rp[0], R, PS_MIX_REL, "R")
    assert_peak_close(st.in_buf[0], ref.in_buf[:, 0:6], 0.0, "in_buf")
    assert_peak_close(st.delay[0], ref.delay[:, 32:46], K1_REL, "delay")


def _single_golden() -> dict:
    tool = golden_tool()
    with np.load(tool.SINGLE_GOLDEN) as z:
        return {k: z[k] for k in z.files}


NAMES = [name for name, _ in golden_tool().SINGLE_LIST]


@pytest.mark.parametrize("name", NAMES)
def test_single_decoder_matches_jax_golden(name, monkeypatch):
    """The whole stream (16 frames) against the JAX Decoder: int16 within
    2 LSB, the dropped-frame count and output rate equal, and K1 run once
    per frame in which PS ran, per band mode (on the two streams whose
    frame 0 is corrupt PS never starts: none)."""
    gold = _single_golden()
    tool = golden_tool()
    calls = []
    real = ps_ops.decorrelate_seq

    def spy(*a):
        calls.append(a[1].shape[1])
        return real(*a)

    monkeypatch.setattr(ps_ops, "decorrelate_seq", spy)
    frames = split_adts_stream(tool.single_stream(name))[:tool.FRAMES]
    if name == "ds_0":
        with open(f"{tool.REPO}/{tool.DS_ASC}", "rb") as f:
            dec = Decoder(asc=f.read(), device="cpu")
        pcm = torch.cat([dec.decode_frame(fr[7:]) for fr in frames])
    else:
        dec = Decoder(adts_probe=frames[0][:7], device="cpu")
        pcm = dec.decode(b"".join(frames))
    want = gold[f"pcm_{name}"].astype(np.int32)
    assert pcm.dtype == torch.int16 and pcm.device.type == "cpu"
    assert tuple(pcm.shape) == want.shape
    assert np.abs(want).max() > 1000
    assert np.abs(pcm.numpy().astype(np.int32) - want).max() <= TOL_LSB
    assert dec.error_count == int(gold[f"errors_{name}"])
    assert dec.sample_rate == int(gold[f"rate_{name}"])
    assert [calls.count(30), calls.count(50)] == \
        gold[f"ps_{name}"].tolist()


def test_decode_adts_and_one_upload_per_frame(monkeypatch):
    """decode_adts is the Decoder over the whole buffer; each frame's host
    arrays reach the device in one copy; a buffer with no ADTS frames
    raises ValueError."""
    tool = golden_tool()
    data = b"".join(split_adts_stream(tool.single_stream("he_v1s_1"))[:3])
    uploads = []
    real = decoder_mod._upload

    def spy(groups, device):
        uploads.append(sorted(groups))
        return real(groups, device)

    monkeypatch.setattr(decoder_mod, "_upload", spy)
    pcm, rate = decode_adts(data, device="cpu")
    want = _single_golden()["pcm_he_v1s_1"][:len(pcm)].astype(np.int32)
    assert rate == 48000 and tuple(pcm.shape) == (3 * 2048, 2)
    assert np.abs(pcm.numpy().astype(np.int32) - want).max() <= TOL_LSB
    assert uploads == [["core", "sbr0"]] * 3
    with pytest.raises(ValueError, match="not an ADTS stream"):
        decode_adts(b"no sync word here", device="cpu")
