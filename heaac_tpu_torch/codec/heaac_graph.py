"""The per-frame HE-AAC v2 device graph and the whole-stream scan.

Counterpart: ``heaac_tpu/codec/heaac_graph.py`` — HeaacState/init_state,
_ps_stage, heaac_frame (is34 0, 1 or 2 = both band modes selected per
lane; downsampled 0, or 1 for the 32-band synthesis of downsampled SBR;
with the ps_on gate and the PS state freeze), init_compact_state,
heaac_frame_compact, the plan-record scan (``heaac_tpu/codec/batch.py``
_make_scan_decoder, dense or compact: ``scan_decode``), init_qwire_carry,
heaac_frame_qwire, _qwire_decode_all_coeffs (with the device M/S pair
butterfly), qwire_scan_decoder, qwire_scan_decoder_couple, and the
band-mode flip scan (_convert_ps_flip, _flip_scan,
qwire_scan_decoder_flip[_couple], init_qwire_flip_carry); and the AAC-LC
scan (``heaac_tpu/codec/batch.py`` _make_lc_scan_decoder, couple False
or True).  One frame for B lanes: core IMDCT / overlap-add -> QMF
analysis -> SBR HF reconstruction -> parametric stereo -> QMF synthesis.
The scans are Python loops over T frames that round to int16 inside the
loop, except with AFTER_IMDCT coupling, which mixes the float output of
all frames first; on a CUDA device the qwire scan replays its frame step
as a CUDA graph (``codec/step_graph.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import ps, sbr, spec_huff
from ..ops.qmf import qmf_analysis, qmf_synthesis, qmf_synthesis_ds
from . import compact_plan, qwire, step_graph
from .core import consts as core_consts
from .core import core_frame
from ..host import R_TOKOFF, R_W1, R_W2, R_W3
from ..utils.trace import span


class HeaacState(NamedTuple):
    saved: torch.Tensor       # [B,512]   core overlap
    x_hist: torch.Tensor      # [B,288]   QMF analysis history
    W_prev: torch.Tensor      # [B,32,32,2]
    Y_prev: torch.Tensor      # [B,38,64,2]
    g_temp: torch.Tensor      # [B,42,48]
    q_temp: torch.Tensor      # [B,42,48]
    v0: torch.Tensor          # [B,9,128] synthesis FIFO L
    v1: torch.Tensor          # [B,9,128] synthesis FIFO R
    ps_in_buf: torch.Tensor   # [B,5,6,2]
    ps_delay: torch.Tensor    # [B,91,14,2]
    ps_ap: torch.Tensor       # [B,50,3,5,2] (20-band uses rows :30)
    ps_trans: torch.Tensor    # [B,34,3]


STATE_SHAPES = dict(
    saved=(512,), x_hist=(288,), W_prev=(32, 32, 2), Y_prev=(38, 64, 2),
    g_temp=(42, 48), q_temp=(42, 48), v0=(9, 128), v1=(9, 128),
    ps_in_buf=(5, 6, 2), ps_delay=(91, 14, 2), ps_ap=(50, 3, 5, 2),
    ps_trans=(34, 3))


def init_state(B: int, device) -> HeaacState:
    return HeaacState(**{
        k: torch.zeros((B,) + s, dtype=torch.float32, device=device)
        for k, s in STATE_SHAPES.items()})


def _select(m, a1, a0):
    """Per lane: a1 where m [B] > 0, else a0 (never a blend, so nothing
    of the branch not taken reaches the result)."""
    return torch.where((m > 0).reshape((-1,) + (1,) * (a1.dim() - 1)), a1,
                       a0)


def _ps_stage(X, state: HeaacState, ps_plan, is34: int):
    """The parametric-stereo block for one band mode: X [B,2,38,64] ->
    (Lp, Rp, new in_buf, new decorrelation state dict)."""
    lbuf, ps_in_buf = ps.hybrid_analysis(X, state.ps_in_buf, is34)
    ps_state = dict(delay=state.ps_delay, ap=state.ps_ap,
                    trans=state.ps_trans)
    lmix, rmix, ps_new = ps.decorrelate_and_mix(lbuf, ps_state, ps_plan,
                                                 is34)
    return (ps.hybrid_synthesis(lmix, is34), ps.hybrid_synthesis(rmix, is34),
            ps_in_buf, ps_new)


def heaac_frame(core, plan, ps_plan, state: HeaacState, is34: int = 0,
                downsampled: int = 0):
    """One frame for B mono HE-AACv2 lanes -> (pcm [B,2,2048] f32, or
    [B,2,1024] with ``downsampled``, new state).  is34 = 2 runs the PS
    stage in both band modes (K1 at napb 30 and at napb 50) on the same
    state and plan and takes each lane's result from the mode
    ``ps_plan["m34"]`` [B] names: the band layouts are fixed per mode,
    so a lane whose mode flips needs both."""
    if is34 not in (0, 1, 2):
        raise ValueError(f"is34 must be 0, 1 or 2, not {is34}")
    m2048, m256, bank = core_consts(state.saved.device)
    time_out, saved = core_frame(core["coeffs"], state.saved, core["ws"],
                                 core["wsp"], core["kbd"], core["kbdp"],
                                 m2048, m256, bank)
    W, x_hist = qmf_analysis(time_out, state.x_hist)
    X_low = sbr.lf_gen(state.W_prev, W, plan["xlow_new"], plan["xlow_old"])
    alpha0, alpha1 = sbr.hf_inverse_filter(X_low)
    X_high = sbr.hf_gen(X_low, alpha0, alpha1, plan["src_of_m"],
                        plan["bw_of_m"], plan["hf_mask"],
                        plan["gen_slot_mask"])
    e_curr = sbr.env_estimate(X_high, plan["env_onehot"], plan["recip"],
                              plan["grp_mean"], plan["freqres_sel"])
    gain, q_m, s_m = sbr.gain_calc(e_curr, plan)
    Y_m, env_on, g_temp, q_temp = sbr.hf_assemble(
        X_high, gain, q_m, s_m, state.g_temp, state.q_temp, plan)
    X, y_cur = sbr.x_gen(X_low, Y_m, state.Y_prev, env_on, plan)

    if is34 == 2:
        m34 = ps_plan["m34"]
        r0 = _ps_stage(X, state, ps_plan, 0)
        r1 = _ps_stage(X, state, ps_plan, 1)
        Lp, Rp, ps_in_buf = (_select(m34, a1, a0)
                             for a1, a0 in zip(r1[:3], r0[:3]))
        ps_new = {k: _select(m34, r1[3][k], r0[3][k]) for k in r0[3]}
    else:
        Lp, Rp, ps_in_buf, ps_new = _ps_stage(X, state, ps_plan, is34)
    on = ps_plan["ps_on"] > 0
    Lx = torch.where(on[:, None, None, None], Lp, X)
    Rx = torch.where(on[:, None, None, None], Rp, X)

    def keep(new, old):
        """PS state freezes when inactive (the reference never calls
        ff_ps_apply)."""
        return torch.where(on.reshape((-1,) + (1,) * (new.dim() - 1)), new,
                           old)

    synth = qmf_synthesis_ds if downsampled else qmf_synthesis
    pcm0, v0 = synth(Lx, state.v0)
    pcm1, v1 = synth(Rx, state.v1)
    new_state = HeaacState(
        saved=saved, x_hist=x_hist, W_prev=W, Y_prev=y_cur, g_temp=g_temp,
        q_temp=q_temp, v0=v0, v1=v1,
        ps_in_buf=keep(ps_in_buf, state.ps_in_buf),
        ps_delay=keep(ps_new["delay"], state.ps_delay),
        ps_ap=keep(ps_new["ap"], state.ps_ap),
        ps_trans=keep(ps_new["trans"], state.ps_trans))
    return torch.stack([pcm0, pcm1], 1), new_state


def init_compact_state(B: int, device):
    """(HeaacState, ps_hist) of B fresh lanes: the carry of the compact
    plan scans."""
    return (init_state(B, device), compact_plan.init_ps_hist(B, device))


def heaac_frame_compact(core, sc, pc, carry, is34: int = 0,
                        downsampled: int = 0):
    """One frame for B lanes from compact plan records (sc, pc dicts of
    ``codec/compact_plan.py``) -> (pcm, new carry); carry as
    ``init_compact_state``."""
    state, ph = carry
    plan = compact_plan.expand_sbr(sc)
    ps_plan, ph_new = compact_plan.expand_ps(pc, ph, is34)
    pcm, new_state = heaac_frame(core, plan, ps_plan, state, is34,
                                 downsampled)
    return pcm, (new_state, ph_new)


def _pcm_buffer(T: int, B: int, downsampled: int, device):
    return torch.empty((T, B, 2, 1024 if downsampled else 2048),
                       dtype=torch.int16, device=device)


def scan_decode(core_seq: dict, sbr_seq: dict, ps_seq: dict, carry,
                is34: int = 0, downsampled: int = 0, compact: bool = True):
    """_make_scan_decoder's run: step the frame graph over T frames of
    plan records resident on the device, each leaf [T, B, ...] (the
    compact records with ``compact``, expanded frame by frame; else the
    dense plans, with carry an ``init_state``).  -> (carry, pcm int16
    [T, B, 2, N]), N = 2048, or 1024 with ``downsampled``."""
    T, B = core_seq["coeffs"].shape[:2]
    step = heaac_frame_compact if compact else heaac_frame
    pcm = _pcm_buffer(T, B, downsampled, core_seq["coeffs"].device)
    for t in range(T):
        at = lambda d: {k: v[t] for k, v in d.items()}  # noqa: E731
        out, carry = step(at(core_seq), at(sbr_seq), at(ps_seq), carry,
                          is34, downsampled)
        pcm[t] = to_int16(out)
    return carry, pcm


def init_qwire_carry(B: int, device):
    """(HeaacState, ps_hist, qwire carry) of B fresh lanes."""
    return (init_state(B, device), compact_plan.init_ps_hist(B, device),
            qwire.init_qcarry(B, device))


def heaac_frame_qwire(coeffs, rec, heap, carry, is34: int = 0,
                      downsampled: int = 0, rows_pair: int = 0,
                      heap_hi=None):
    """One frame from the quantized wire format: rec [B,REC_W] int,
    heap [N] int byte values, coeffs [B,1024] -> (pcm, new carry);
    ``heap_hi`` as ``qwire.expand_frame`` takes it."""
    state, ph, qc = carry
    with span("expand_frame"):
        core_meta, plan, pc, qc2 = qwire.expand_frame(heap, rec, qc, is34,
                                                      rows_pair, heap_hi)
    with span("expand_ps"):
        ps_plan, ph2 = compact_plan.expand_ps(pc, ph, is34)
    core = dict(coeffs=coeffs, **core_meta)
    with span("frame_graph"):
        pcm, state2 = heaac_frame(core, plan, ps_plan, state, is34,
                                  downsampled)
    return pcm, (state2, ph2, qc2)


CHUNK_ROWS = 4096    # frame-lanes per decode pass of the scan prologue


def decode_all_coeffs(heap, rec_seq, S: int, rate_idx: int, NB: int,
                      MS: int = 0, NS: int = 52, SEC: int = 31):
    """Scan prologue (_qwire_decode_all_coeffs): token decode — plus the
    raw-bits spectral decode of mode-1 lanes when NB > 0 — of every
    frame-lane at once, CHUNK_ROWS flattened rows at a time to bound the
    [rows, NB] working set.  heap [N] byte values (any int dtype),
    rec_seq [T, L, REC_W] -> (heap int64, rec_seq int64,
    coeffs [T, L, 1024]).

    With MS != 0, spec-mode CPE pairs flagged W3_MS_LEFT/RIGHT get the
    M/S butterfly (aacdec.c:1390-1411): raw-bits lanes ship PRE-M/S
    spectra, and a pair's lanes sit at flat rows r (left) and r + T
    (right) under the lane-major flattening.  The two rows of a pair can
    fall in different chunks, so the butterfly runs once, on all rows."""
    heap = heap.long()
    rec_seq = rec_seq.long()
    T, L = rec_seq.shape[:2]
    flat = rec_seq.transpose(0, 1).reshape(L * T, rec_seq.shape[2])
    mode1 = ((flat[:, R_W2] >> 24) & 15) == 1
    w3 = flat[:, R_W3] * mode1
    parts, masks = [], []
    for r0 in range(0, L * T, CHUNK_ROWS):
        f = flat[r0:r0 + CHUNK_ROWS]
        c = qwire.decode_coeffs(heap, f[:, R_TOKOFF], f[:, R_W1] & 0xFFFF, S)
        if NB > 0:
            m1 = mode1[r0:r0 + CHUNK_ROWS]
            spec = spec_huff.decode_spec(heap, f[:, R_TOKOFF],
                                         w3[r0:r0 + CHUNK_ROWS], rate_idx,
                                         NB, with_ms=bool(MS), NS=NS, SEC=SEC)
            if MS:
                spec, msk = spec
                masks.append(msk > 0)
            c = torch.where(m1[:, None], spec, c)
        parts.append(c)
    coeffs = torch.cat(parts, 0)
    if MS:
        msk = torch.cat(masks, 0)
        left = ((w3 >> 28) & 1)[:, None] > 0
        right = ((w3 >> 29) & 1)[:, None] > 0
        z = coeffs.new_zeros((T, 1024))
        dn = torch.cat([coeffs[T:], z], 0)             # row + T
        up = torch.cat([z, coeffs[:-T]], 0)            # row - T
        m_r = torch.cat([msk.new_zeros((T, 1024)), msk[:-T]], 0) & right
        coeffs = torch.where(msk & left, coeffs + dn,
                             torch.where(m_r, up - coeffs, coeffs))
    coeffs = coeffs.reshape(L, T, 1024).transpose(0, 1)
    return heap, rec_seq, coeffs


def to_int16(pcm):
    """clip(rint(x)) to int16; torch.round rounds half to even like
    jnp.rint."""
    return torch.clamp(torch.round(pcm), -32768, 32767).to(torch.int16)


def couple_mix(pcm, etgt, etch, esrc, gains):
    """AFTER_IMDCT coupling at the output rate (qwire_scan_decoder_couple's
    mix): pcm [T, L, C, N] f32 (C = 2 sub-channels, 1 for AAC-LC) gains
    gains[t, k] * pcm[t, esrc[k], 0] in pcm[t, etgt[k], etch[k]] for each
    edge k ([K] int edges, gains [T, K]).  Every source is read before
    the first add, and edges with the same target add up.  Returns pcm,
    updated in place."""
    T, L, C, N = pcm.shape
    add = gains[:, :, None] * pcm[:, esrc, 0]                  # [T, K, N]
    pcm.view(T, L * C, N).index_add_(1, etgt * C + etch, add)
    return pcm


def qwire_scan_decode(heap, rec_seq, carry, is34: int, downsampled: int,
                      S: int, rate_idx: int = -1, NB: int = 0, MS: int = 0,
                      NS: int = 52, SEC: int = 31, rows_pair: int = 0,
                      couple=None):
    """qwire_scan_decoder's run: decode every frame's coefficients in one
    parallel pass, then step the frame graph over the T frames.  heap is
    the byte heap, rec_seq [T, L, REC_W] the records -> (carry,
    pcm int16 [T, L, 2, N]), N = 2048, or 1024 with ``downsampled``
    (the 32-band synthesis).  ``couple`` = (etgt, etch, esrc, gains)
    tensors on the device (qwire_scan_decoder_couple): the float output
    of every frame is kept, the AFTER_IMDCT coupling mixed in
    (``couple_mix``), and only then rounded.  On a CUDA device the
    frame step is a CUDA graph, captured once per shape and replayed
    (``step_graph.run_steps``)."""
    if is34 not in (0, 1):
        raise ValueError(f"is34 must be 0 or 1, not {is34}: a stream whose "
                         "band mode flips goes through qwire_scan_decode_flip")
    with span("scan.prologue"):
        heap, rec_seq, coeffs = decode_all_coeffs(heap, rec_seq, S,
                                                  rate_idx, NB, MS, NS, SEC)
        # each step's [L, 1024] rows contiguous, as in the graph's input
        # buffer: cuBLAS can take another kernel for strided rows, and
        # round the IMDCT products otherwise
        coeffs = coeffs.contiguous()
    T, L = rec_seq.shape[:2]
    keep_float = couple is not None
    pcm = torch.empty((T, L, 2, 1024 if downsampled else 2048),
                      dtype=torch.float32 if keep_float else torch.int16,
                      device=heap.device)

    def step(c, rec, heap, carry, heap_hi=None):
        out, carry = heaac_frame_qwire(c, rec, heap, carry, is34,
                                       downsampled, rows_pair, heap_hi)
        return (out if keep_float else to_int16(out)), carry

    carry = step_graph.run_steps(step, coeffs, rec_seq, heap, carry, pcm,
                                 (is34, downsampled, rows_pair, keep_float))
    if keep_float:
        pcm = to_int16(couple_mix(pcm, *couple))
    return carry, pcm


def _convert_ps_flip(state: HeaacState, ph: dict, to34, to20):
    """Per lane, the PS state at a band-mode flip (aacps.c:829-860 and
    660-671): H row 0 through map_val_20_to_34 (to34 [B] bool) or
    map_val_34_to_20 (to20), the IPD/OPD histories and the
    decorrelation state (delay line, allpass rings, transient detector)
    zeroed on both; the hybrid analysis in_buf carries over, like the
    reference's ps->in_buf.  -> (state, ps_hist)."""
    row0 = ph["H"][:, :, 0]                                 # [B,2,34,4]
    row0 = _select(to34, ps.map_val_20_to_34(row0),
                   _select(to20, ps.map_val_34_to_20(row0), row0))
    flip = to34 | to20
    H = ph["H"].clone()
    H[:, :, 0] = row0
    ph2 = dict(H=H,
               ipd_hist=torch.where(flip[:, None], 0, ph["ipd_hist"]),
               opd_hist=torch.where(flip[:, None], 0, ph["opd_hist"]))
    zf = lambda a: _select(flip, torch.zeros_like(a), a)  # noqa: E731
    state2 = state._replace(ps_delay=zf(state.ps_delay),
                            ps_ap=zf(state.ps_ap),
                            ps_trans=zf(state.ps_trans))
    return state2, ph2


def init_qwire_flip_carry(B: int, device):
    """init_qwire_carry plus the band mode of each lane's last PS frame,
    m34_prev [B] (0 at the start, like the reference's zeroed
    ps->is34bands_old)."""
    return init_qwire_carry(B, device) + (
        torch.zeros((B,), dtype=torch.long, device=device),)


def qwire_scan_decode_flip(heap, rec_seq, carry, downsampled: int, S: int,
                           rate_idx: int = -1, NB: int = 0, NS: int = 52,
                           SEC: int = 31, rows_pair: int = 0, couple=None):
    """The band-mode flip scan (_flip_scan, qwire_scan_decoder_flip and,
    with ``couple``, qwire_scan_decoder_flip_couple): like
    qwire_scan_decode, but each lane's PS band mode is read per frame
    from side bit 6 (expand_frame with is34 = -1), the PS state is
    converted on a lane's first PS frame in a new mode
    (``_convert_ps_flip``), the PS plan is expanded in both modes on the
    converted history, and the frame graph runs both PS stages
    (heaac_frame with is34 = 2), so K1 runs at napb 30 and at napb 50 in
    every frame.  carry is init_qwire_flip_carry's (..., m34_prev [B]);
    the M/S butterfly is not part of it (MS = 0).  -> (carry,
    pcm int16 [T, L, 2, N]), N as in qwire_scan_decode."""
    heap, rec_seq, coeffs = decode_all_coeffs(heap, rec_seq, S, rate_idx,
                                              NB, 0, NS, SEC)
    T, L = rec_seq.shape[:2]
    dtype = torch.int16 if couple is None else torch.float32
    pcm = torch.empty((T, L, 2, 1024 if downsampled else 2048),
                      dtype=dtype, device=heap.device)
    for t in range(T):
        with span("scan.step"):
            state, ph, qc, m34_prev = carry
            core_meta, plan, pc, qc2 = qwire.expand_frame(
                heap, rec_seq[t], qc, -1, rows_pair)
            m34 = pc.pop("m34")
            active = pc["pc_i"][:, compact_plan.PI_ON] > 0
            to34 = active & (m34 > 0) & (m34_prev == 0)
            to20 = active & (m34 == 0) & (m34_prev > 0)
            state2, ph2 = _convert_ps_flip(state, ph, to34, to20)
            ps0, ph0 = compact_plan.expand_ps(pc, ph2, 0)
            ps1, ph1 = compact_plan.expand_ps(pc, ph2, 1)
            ps_plan = {k: _select(m34, ps1[k], ps0[k]) for k in ps0}
            ph3 = {k: _select(m34, ph1[k], ph0[k]) for k in ph0}
            ps_plan["m34"] = m34
            core = dict(coeffs=coeffs[t], **core_meta)
            out, state3 = heaac_frame(core, plan, ps_plan, state2, 2,
                                      downsampled)
            pcm[t] = out if couple is not None else to_int16(out)
            carry = (state3, ph3, qc2, torch.where(active, m34, m34_prev))
    if couple is not None:
        pcm = to_int16(couple_mix(pcm, *couple))
    return carry, pcm


def lc_scan_decode(core_seq: dict, saved, couple=None):
    """The AAC-LC whole-stream scan: core_seq coeffs [T, L, 1024] f32 and
    ws / wsp / kbd / kbdp [T, L] int, saved [L, 512] -> (saved,
    pcm int16 [T, L, 1024]).  ``couple`` = (etgt, esrc, gains) tensors
    on the device ([K] target and source lanes, [T, K] gains;
    _make_lc_scan_decoder(couple=True)): the float output of every frame
    is kept, mixed by ``couple_mix`` (gains[t, k] * pcm[t, esrc[k]] into
    pcm[t, etgt[k]]), and only then rounded."""
    m2048, m256, bank = core_consts(saved.device)
    coeffs = core_seq["coeffs"]
    T, L = coeffs.shape[:2]
    dtype = torch.int16 if couple is None else torch.float32
    pcm = torch.empty((T, L, 1024), dtype=dtype, device=saved.device)
    for t in range(T):
        with span("scan.step"):
            out, saved = core_frame(coeffs[t], saved, core_seq["ws"][t],
                                    core_seq["wsp"][t], core_seq["kbd"][t],
                                    core_seq["kbdp"][t], m2048, m256, bank)
            pcm[t] = out if couple is not None else to_int16(out)
    if couple is not None:
        etgt, esrc, gains = couple
        pcm = to_int16(couple_mix(pcm[:, :, None], etgt, 0, esrc, gains)[
            :, :, 0])
    return saved, pcm
