"""Device resolution: every entry point takes an explicit ``device``."""
from __future__ import annotations

import torch

from . import set_f32_flags


def resolve(device) -> torch.device:
    """torch.device for ``device`` ("cpu", "cuda", "cuda:1", a
    torch.device).  A CUDA device raises when no card is present: the
    port never carries on on the CPU in its place."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device!r} requested but torch.cuda.is_available() "
                "is False")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {device!r}")
    set_f32_flags()
    return dev
