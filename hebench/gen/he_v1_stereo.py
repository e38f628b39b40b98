"""Stereo HE-AAC v1 streams: a 24 kHz stereo CPE AAC-LC core (M/S) with
coupled SBR to 48 kHz, ADTS.

The recipe of the repository's stereo test streams
(``tools/make_torch_streams.py`` ``make_stereo_stream``): core
``cores[i % len(cores)]``, a coupled SBR writer with seed ``sbr_seed +
sbr_seed_step * i``, moved by 1000003 for each re-draw while a payload
cannot be coded, and by the run seed's base (``hebench.gen.seed_base``).
"""
from __future__ import annotations

from . import seed_base
from .writers import SbrStreamWriter, splice_sbr_into_lc

REDRAWS = 8
REDRAW_STEP = 1000003


def make(cores: list, i: int, seed: int, invf_modes: tuple,
         p: dict) -> bytes:
    base = seed_base(seed)
    for tries in range(REDRAWS):
        try:
            w = SbrStreamWriter(
                core_rate=p["core_rate"], is_cpe=True, coupling=True,
                env_hi_shift=p["env_hi_shift"],
                seed=(p["sbr_seed"] + p["sbr_seed_step"] * i
                      + REDRAW_STEP * tries + base),
                invf_modes=invf_modes)
            return splice_sbr_into_lc(cores[i % len(cores)], w)
        except ValueError:
            continue
    raise RuntimeError(f"stream {i}: could not fit the FIL payload")
