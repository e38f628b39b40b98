"""The multi-process ingest deployment's semantics, computed plainly:
which rank holds each stream, how long each stream's PCM is, and the
global counts every rank must hold after the call's one all-reduce.

Independent of the program: the frame counts come from the ADTS
headers (``bitstream.adts``), and every sum is a plain Python one.
"""
from __future__ import annotations

from .bitstream.adts import split_adts_stream

SPF = 2048                     # output samples a frame (SBR doubles 1024)


def rank_of(i: int, ranks: int) -> int:
    """The rank that decodes stream ``i``: round robin."""
    return i % ranks


def shard(n: int, ranks: int, rank: int) -> list:
    """The indices of ``rank``'s streams among ``n``, in input order."""
    return [i for i in range(n) if rank_of(i, ranks) == rank]


def frame_counts(streams: list) -> list:
    """Each stream's whole ADTS frames."""
    return [len(split_adts_stream(s)) for s in streams]


def pcm_rows(frames: int) -> int:
    """A stream's PCM length in samples (per channel) for its frames."""
    return frames * SPF


def global_counts(frames: list, ranks: int, rate: int) -> dict:
    """What every rank's all-reduce must give for streams of ``frames``
    frames each, none errored, over ``ranks`` ranks (one device each):
    frames, errors, audio seconds at ``rate`` and devices."""
    total = sum(frames)
    return dict(frames=total, errors=0,
                audio_seconds=total * SPF / rate, devices=ranks)


# the audio seconds are summed stream by stream on every rank and then
# across ranks in float64, in another order than here: they agree to
# rounding, far below one sample (1 / 48000 s in 10**4 s is 2e-9)
AUDIO_REL = 1e-9


def counts_agree(got: dict, want: dict) -> bool:
    """A rank's reduced counts against ``global_counts``: integers
    exactly, audio seconds to summation rounding."""
    return (got["frames"] == want["frames"]
            and got["errors"] == want["errors"]
            and got["num_devices"] == want["devices"]
            and abs(got["audio_seconds"] - want["audio_seconds"])
            <= AUDIO_REL * want["audio_seconds"])
