"""Every constant table of the PyTorch port equals the JAX package's array
exactly (the port carries its own copies of the numpy table functions)."""
import numpy as np
import pytest

from heaac_tpu.codec import compact_plan as jcp
from heaac_tpu.codec import qwire as jq
from heaac_tpu.codec.core import _consts as jcore_consts
from heaac_tpu.ops import ps_huff as jph
from heaac_tpu.ops import ps_jax, ps_np, qmf_jax
from heaac_tpu.ops import sbr_huff as jsh
from heaac_tpu.ops import spec_huff as jsp
from heaac_tpu.ops.imdct import imdct_half_matrix
from heaac_tpu.ops.sbr_jax import H_SMOOTH
from heaac_tpu.bitstream import sbr_syntax
from heaac_tpu.tables import aac_tables as jT
from heaac_tpu.tables import ps_tables as jP
from heaac_tpu_torch import host
from heaac_tpu_torch import tables as TB
from heaac_tpu_torch.codec import compact_plan as pcp
from heaac_tpu_torch.ops import sbr as psbr


def same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, (a.shape, b.shape,
                                                       a.dtype, b.dtype)
    np.testing.assert_array_equal(a, b)


def test_aac_tables():
    same(TB.kbd_window(4.0, 1024), jT.kbd_long_1024())
    same(TB.kbd_window(6.0, 128), jT.kbd_short_128())
    same(TB.sine_window(1024), jT.sine_window(1024))
    same(TB.sine_window(128), jT.sine_window(128))
    same(TB.pow2sf_tab(), jT.pow2sf_tab())
    same(TB.cbrt_tab(), jT.cbrt_tab())
    same(TB.SAMPLE_RATES, jT.SAMPLE_RATES)
    assert TB.CODEBOOK_INFO == jT.CODEBOOK_INFO
    assert TB.CHANNEL_LAYOUT_MAP == jT.CHANNEL_LAYOUT_MAP
    assert (TB.TYPE_SCE, TB.TYPE_CPE, TB.TYPE_CCE, TB.TYPE_LFE) == (
        jT.TYPE_SCE, jT.TYPE_CPE, jT.TYPE_CCE, jT.TYPE_LFE)
    for cb in range(1, 12):
        same(TB.codebook_tuples(cb), jT.codebook_tuples(cb))
    for si in range(12):
        same(TB.swb_offset_1024(si), jT.swb_offset_1024(si))
        same(TB.swb_offset_128(si), jT.swb_offset_128(si))


@pytest.mark.parametrize("n2,scale", [(1024, 1.0), (128, 1.0), (64, -2.0),
                                      (64, 1.0 / 64)])
def test_imdct_matrices(n2, scale):
    same(TB.imdct_half_matrix(n2, scale), imdct_half_matrix(n2, scale))


def test_core_and_qmf_consts():
    for a, b in zip(TB.core_consts(), jcore_consts()):
        same(a, b)
    same(TB.qmf_window_us(), sbr_syntax.qmf_window_us())
    same(TB.qmf_window_ds(), sbr_syntax.qmf_window_ds())
    same(TB.noise_table(), sbr_syntax.noise_table())
    for a, b in zip(TB.qmf_analysis_consts(), qmf_jax._analysis_consts()):
        same(a, b)
    A, B2, win = TB.qmf_synthesis_consts()
    jA, jB2, jwin, jtaps = qmf_jax._synthesis_consts()
    same(A, jA)
    same(B2, jB2)
    same(win, jwin)
    assert list(TB.QMF_SYN_TAPS) == list(jtaps)
    *consts, jtaps = qmf_jax._synthesis_consts_ds()
    for a, b in zip(TB.qmf_synthesis_consts_ds(), consts):
        same(a, b)
    assert list(TB.QMF_SYN_TAPS_DS) == list(jtaps)
    same(psbr.H_SMOOTH, H_SMOOTH)
    assert TB.ENVELOPE_ADJUSTMENT_OFFSET == \
        sbr_syntax.ENVELOPE_ADJUSTMENT_OFFSET


@pytest.mark.parametrize("is34", [0, 1])
def test_ps_consts(is34):
    for a, b in zip(TB.pd_smooth(), jP.pd_smooth()):
        same(a, b)
    for a, b in zip(TB.mixing_luts(), jP.mixing_luts()):
        same(a, b)
    for a, b in zip(TB.fractional_delays(), jP.fractional_delays()):
        same(a, b)
    hf, jhf = TB.hybrid_filters(), jP.hybrid_filters()
    assert set(hf) == set(jhf)
    for k in hf:
        same(hf[k], jhf[k])
    same(TB.k_to_i(is34), jP.k_to_i(is34))
    c, jc = TB.ps_consts(is34), ps_jax._consts(is34)
    assert set(c) == set(jc)
    for k in c:
        if isinstance(jc[k], np.ndarray):
            same(c[k], jc[k])
        else:
            assert c[k] == jc[k], k
    for name in ("NR_PAR_BANDS", "NR_BANDS", "DECAY_CUTOFF",
                 "NR_ALLPASS_BANDS", "SHORT_DELAY_BAND", "LINK_DELAY",
                 "AP_A", "PEAK_DECAY_FACTOR", "TRANSIENT_IMPACT",
                 "A_SMOOTH"):
        same(getattr(TB, name), getattr(jP, name))
    same(TB.remap_tables(True), ps_np.REMAP_TABLES_FULL)
    same(TB.remap_tables(False), ps_np.REMAP_TABLES_PART)


def test_huffman_luts():
    same(TB.spec_luts(), jsp.luts())
    same(TB.sf_lut(), jsp.sf_lut())
    same(TB.CB_DIM, jsp.CB_DIM)
    same(TB.CB_UNSIGNED, jsp.CB_UNSIGNED)
    for si in range(12):
        for a, b in zip(TB.sfb_of_bin(si), jsp.sfb_of_bin(si)):
            same(a, b)
        for a, b in zip(TB.sfb_of_bin_short(si), jsp.sfb_of_bin_short(si)):
            same(a, b)
    for a, b in zip(TB.sbr_huff_luts(), jsh.luts()):
        same(a, b)
    same(TB.SBR_LAV, jsh.LAV)
    for a, b in zip(TB.ps_huff_luts(), jph.luts()):
        same(a, b)


def test_qwire_luts_and_layout():
    L, jL = TB.qwire_luts(), jq.luts()
    assert set(L) == set(jL)
    for k in L:
        same(L[k], jL[k])
    for name in ("T_ZRUN0", "ZRUN_MAX", "T_PAIR0", "T_SGL0",
                 "T_ESC1", "T_ESC2", "T_SETSF", "T_RAW0", "RAW_MAX",
                 "T_QUAD0", "T_QUAD_END", "T_SFD_BASE", "REC_W", "R_TOKOFF",
                 "R_W1", "R_W2", "R_W3", "SIDE_HEAD", "SIDE_MAX", "PS_B0",
                 "PS_KND", "PS_NIPD", "PS_TOP", "PS_BORD", "PS_NE", "PS_RB",
                 "PS_HEAD", "PS_WIDTH", "H_N0", "H_N1", "H_NQ", "H_NLIM",
                 "H_NPATCH", "H_KX1", "H_M1", "H_FLAGS", "H_LIMG", "H_TAB",
                 "HDR_MAX", "NB_HI", "NB_LO", "NB_Q", "NB_LIM", "NPATCH",
                 "E", "M"):
        assert getattr(host, name) == getattr(jq, name), name
    for name in ("PI_ON", "PI_IPD", "PI_QUANT", "PI_NENV", "PI_ICCMODE",
                 "PI_NIPD", "PI_TOP", "PI_BORD", "PC_I_N", "PB_IID",
                 "PB_ICC", "PB_IPD", "PB_OPD", "PC_B_N"):
        assert getattr(pcp, name) == getattr(jcp, name), name
    payload, rec = host.silence_lane()
    jpayload, jrec = jq.silence_lane()
    assert payload == jpayload
    same(rec, jrec)


def test_parser_tables():
    """The tables the port's copy of the host parser and the planner's
    writers read (heaac_tpu_torch/bitstream, codec/qwire_host.py)."""
    from heaac_tpu.bitstream import ps_syntax as jps
    from heaac_tpu.ops import sbr_np
    from heaac_tpu_torch.bitstream import ps_syntax, sbr_syntax as psyn
    from heaac_tpu_torch.codec import qwire_host as QH
    same(TB.CHANNEL_COUNTS, jT.CHANNEL_COUNTS)
    for name in ("ONLY_LONG", "LONG_START", "EIGHT_SHORT", "LONG_STOP",
                 "ZERO_BT", "ESC_BT", "NOISE_BT", "INTENSITY_BT2",
                 "INTENSITY_BT", "TYPE_DSE", "TYPE_PCE", "TYPE_FIL",
                 "TYPE_END"):
        assert getattr(TB, name) == getattr(jT, name), name
    for cb in range(1, 12):
        for a, b in zip(TB.spectral_codes(cb), jT.spectral_codes(cb)):
            same(a, b)
    for a, b in zip(TB.scalefactor_codes(), jT.scalefactor_codes()):
        same(a, b)
    for si in range(12):
        assert TB.num_swb_1024(si) == jT.num_swb_1024(si)
        assert TB.num_swb_128(si) == jT.num_swb_128(si)
        assert TB.pred_sfb_max(si) == jT.pred_sfb_max(si)
        for short in (False, True):
            assert TB.tns_max_bands(si, short) == jT.tns_max_bands(si, short)
    for cc in (0, 1):
        for res in (0, 1):
            same(TB.tns_tmp2_map(cc, res), jT.tns_tmp2_map(cc, res))
    for name in ("PS_MAX_NUM_ENV", "PS_MAX_NR_IIDICC", "PS_QMF_TIME_SLOTS"):
        assert getattr(TB, name) == getattr(jP, name), name
    assert (ps_syntax.NUM_ENV_TAB, ps_syntax.NR_IIDICC_PAR_TAB,
            ps_syntax.NR_IIDOPD_PAR_TAB) == (
        jps.NUM_ENV_TAB, jps.NR_IIDICC_PAR_TAB, jps.NR_IIDOPD_PAR_TAB)
    assert psyn._SBR_VLC_NAMES == sbr_syntax._SBR_VLC_NAMES
    same(QH.BW_TAB, sbr_np.BW_TAB)
    assert QH.PS_KIND_OF == jq.PS_KIND_OF and QH.SEC_MAX == jsp.SEC_MAX
    for name in ("W3_MS_MASK", "W3_MS_LEFT", "W3_MS_RIGHT", "W3_SHORT"):
        assert getattr(QH, name) == getattr(jsp, name), name
