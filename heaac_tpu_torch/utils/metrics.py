"""Port copy of ``heaac_tpu/utils/metrics.py``: the port imports nothing
of the JAX package, so it keeps its own copy.  Names as there; ``log`` is
the logger ``"heaac_tpu_torch"``, which every module of the port logs to.

Structured decode metrics + logging (the analogue of the reference's
av_log + `-benchmark` affordances; SURVEY.md §5).
"""
from __future__ import annotations

import logging
import time
from dataclasses import dataclass, field

log = logging.getLogger("heaac_tpu_torch")


@dataclass
class DecodeMetrics:
    frames_decoded: int = 0
    frames_errored: int = 0
    streams: int = 0
    audio_seconds: float = 0.0
    wall_seconds: float = 0.0
    _t0: float = field(default=0.0, repr=False)

    def start(self):
        self._t0 = time.perf_counter()
        return self

    def stop(self):
        self.wall_seconds += time.perf_counter() - self._t0
        return self

    @property
    def realtime_factor(self) -> float:
        return self.audio_seconds / self.wall_seconds if self.wall_seconds else 0.0

    def as_dict(self) -> dict:
        return {
            "frames_decoded": self.frames_decoded,
            "frames_errored": self.frames_errored,
            "streams": self.streams,
            "audio_seconds": round(self.audio_seconds, 3),
            "wall_seconds": round(self.wall_seconds, 4),
            "realtime_factor": round(self.realtime_factor, 1),
        }
