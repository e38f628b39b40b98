"""Stream generators of the benchmark, one module per kind.

A configuration file names its generator kind (``generator.kind``); the
module ``hebench.gen.<kind>`` makes stream ``i`` of a run with seed
``seed`` by ``make(cores, i, seed, invf_modes, params)``, where
``cores`` are the configuration's AAC-LC cores as
``writers.core_frames`` gives them.  Everything
here is a frozen copy over the reference's own bitstream code
(``hebench.ref``): it imports nothing of the program.
"""
from __future__ import annotations

import importlib
import os

# Run seed s moves every writer seed by s * SEED_STRIDE: at s = 0 the
# writers get the recipe's own seeds, and the recipe's seeds for any
# stream index below ~10**7 (and its re-draws) stay below the stride.
SEED_STRIDE = 10 ** 8
SEED_MOD = 1 << 62


def seed_base(seed: int) -> int:
    return (seed % SEED_MOD) * SEED_STRIDE


def read_cores(root: str, pattern: str, n: int) -> list:
    """The n core files ``pattern.format(i=i)`` under ``root``."""
    cores = []
    for i in range(n):
        with open(os.path.join(root, pattern.format(i=i)), "rb") as f:
            cores.append(f.read())
    return cores


_job: dict = {}


def _init(generator: dict, cores: list, seed: int, invf_modes) -> None:
    _job.update(mod=importlib.import_module(f"{__name__}.{generator['kind']}"),
                generator=generator, cores=cores, seed=seed,
                invf_modes=tuple(invf_modes))


def _make(i: int) -> bytes:
    return _job["mod"].make(_job["cores"], i, _job["seed"],
                            _job["invf_modes"], _job["generator"])


def make_streams(root: str, generator: dict, n: int, seed: int,
                 invf_modes, workers: int | None = 1) -> list:
    """Streams 0..n-1 of the configuration's generator for ``seed``, made
    in ``workers`` spawned processes (None: one a CPU core).  The cores
    are parsed once (``writers.core_frames``) and handed to every
    worker."""
    from ..pool import pool_map
    from .writers import core_frames
    raw = read_cores(root, generator["cores"], generator["n_cores"])
    cores = pool_map(core_frames, raw, workers)
    return pool_map(_make, range(n), workers, _init,
                    (generator, cores, seed, list(invf_modes)))
