"""HE-AAC v2 streams: a 24 kHz mono AAC-LC core with SBR to 48 kHz and
20-band parametric stereo, ADTS.

The recipe of the repository's distinct bench streams
(``heaac_tpu_torch.io.heaac_testgen.distinct_stream``): core
``cores[i % len(cores)]``, SBR writer seed ``sbr_seed + sbr_seed_step
* i``, PS writer seed ``ps_seed + ps_seed_step * i``, the SBR seed moved
by 1000003 for each re-draw while a payload cannot be coded; every seed
moved by the run seed's base (``hebench.gen.seed_base``).
"""
from __future__ import annotations

import functools

from . import seed_base
from .writers import PsStreamWriter, SbrStreamWriter, splice_sbr_into_lc

REDRAWS = 8
REDRAW_STEP = 1000003


def make(cores: list, i: int, seed: int, invf_modes: tuple,
         p: dict) -> bytes:
    base = seed_base(seed)
    for tries in range(REDRAWS):
        try:
            ps = PsStreamWriter(seed=p["ps_seed"] + p["ps_seed_step"] * i
                                + base)
            ps.ps_payload = functools.partial(
                PsStreamWriter.ps_payload, ps, max_bytes=p["ps_max_bytes"])
            w = SbrStreamWriter(
                core_rate=p["core_rate"], is_cpe=False,
                env_hi_shift=p["env_hi_shift"],
                seed=(p["sbr_seed"] + p["sbr_seed_step"] * i
                      + REDRAW_STEP * tries + base),
                invf_modes=invf_modes, ps_writer=ps)
            return splice_sbr_into_lc(cores[i % len(cores)], w)
        except ValueError:
            continue
    raise RuntimeError(f"stream {i}: could not fit the FIL payload")
