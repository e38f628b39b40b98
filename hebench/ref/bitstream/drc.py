"""Dynamic Range Control extension parsing (reference aacdec.c:1575-1641).

Decoded but not applied to the signal, matching the reference decoder's
behavior (DRC info is surfaced to the caller only).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from .reader import BitReader


@dataclass
class DynamicRangeControl:
    pce_instance_tag: int = 0
    dyn_rng_sgn: list = field(default_factory=list)
    dyn_rng_ctl: list = field(default_factory=list)
    exclude_mask: list = field(default_factory=list)
    band_incr: int = 0
    interpolation_scheme: int = 0
    band_top: list = field(default_factory=list)
    prog_ref_level: int = -1


def decode_drc_channel_exclusions(drc: DynamicRangeControl,
                                  br: BitReader) -> int:
    n = 0
    drc.exclude_mask = []
    while True:
        for _ in range(7):
            drc.exclude_mask.append(br.get1())
        n += 1
        if len(drc.exclude_mask) >= 57 or not br.get1():
            break
    return n


def decode_dynamic_range(drc: DynamicRangeControl, br: BitReader) -> int:
    """Returns bytes consumed (aacdec.c:1596-1641)."""
    n = 1
    drc_num_bands = 1
    if br.get1():  # pce_tag_present
        drc.pce_instance_tag = br.get(4)
        br.skip(4)
        n += 1
    if br.get1():  # excluded_chns_present
        n += decode_drc_channel_exclusions(drc, br)
    if br.get1():  # drc_bands_present
        drc.band_incr = br.get(4)
        drc.interpolation_scheme = br.get(4)
        n += 1
        drc_num_bands += drc.band_incr
        drc.band_top = []
        for _ in range(drc_num_bands):
            drc.band_top.append(br.get(8))
            n += 1
    if br.get1():  # prog_ref_level_present
        drc.prog_ref_level = br.get(7)
        br.skip(1)
        n += 1
    drc.dyn_rng_sgn = []
    drc.dyn_rng_ctl = []
    for _ in range(drc_num_bands):
        drc.dyn_rng_sgn.append(br.get1())
        drc.dyn_rng_ctl.append(br.get(7))
        n += 1
    return n
