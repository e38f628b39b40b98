"""Port copy of ``heaac_tpu/models/profiles.py``: the port imports
nothing of the JAX package, so it keeps its own copy.  Names as there;
each ``device_graph`` names the port's module that decodes the profile.

Decoder profile registry — the framework's analogue of the reference's
codec registry (libavcodec/allcodecs.c + the AVCodec table entry
aacdec.c:2128-2143).

Each profile describes one decode pipeline configuration: which device
graph decodes it, its output geometry, and the toolset it supports.
Streams with different profiles cannot share one batched decode
(``codec/batch.decode_batch`` buckets them apart).
"""
from __future__ import annotations

from dataclasses import dataclass, field


@dataclass(frozen=True)
class DecoderProfile:
    name: str
    long_name: str
    object_types: tuple      # MPEG-4 audio object types accepted
    sbr: bool
    ps: bool
    frame_samples_out: int   # PCM samples per frame per channel
    device_graph: str        # implementing module
    tools: tuple = field(default_factory=tuple)


AAC_LC = DecoderProfile(
    name="aac_lc",
    long_name="AAC Low Complexity",
    object_types=(2,),
    sbr=False, ps=False,
    frame_samples_out=1024,
    device_graph="heaac_tpu_torch.codec.core",
    tools=("block-switching", "kbd+sine windows", "tns", "ms", "intensity",
           "pns", "pulses", "drc-parse"),
)

AAC_MAIN = DecoderProfile(
    name="aac_main",
    long_name="AAC Main (frequency-domain prediction)",
    object_types=(1,),
    sbr=False, ps=False,
    frame_samples_out=1024,
    device_graph="heaac_tpu_torch.codec.core",
    tools=AAC_LC.tools + ("prediction",),
)

HEAAC_V1 = DecoderProfile(
    name="heaac_v1",
    long_name="HE-AAC v1 (AAC-LC + SBR)",
    object_types=(2, 5),
    sbr=True, ps=False,
    frame_samples_out=2048,
    device_graph="heaac_tpu_torch.ops.sbr",
    tools=AAC_LC.tools + ("sbr", "sbr-inverse-filtering",
                          "sbr-pure-upsampling"),
)

HEAAC_V2 = DecoderProfile(
    name="heaac_v2",
    long_name="HE-AAC v2 (AAC-LC + SBR + Parametric Stereo)",
    object_types=(2, 5, 29),
    sbr=True, ps=True,
    frame_samples_out=2048,
    device_graph="heaac_tpu_torch.codec.heaac_graph",
    tools=HEAAC_V1.tools + ("ps-baseline", "ps-ipd-opd", "ps-34band"),
)

REGISTRY = {p.name: p for p in (AAC_LC, AAC_MAIN, HEAAC_V1, HEAAC_V2)}


def profile_for_stream(m4ac) -> DecoderProfile:
    """Select the decode profile from a parsed stream config."""
    if m4ac.ps == 1:
        return HEAAC_V2
    if m4ac.sbr == 1:
        return HEAAC_V1
    if m4ac.object_type == 1:
        return AAC_MAIN
    return AAC_LC
