"""Decode carry <-> numpy, in the JAX package's layout.

The decoder has no weights: its "parameters" are the constant tables and
the carry that ``init_qwire_carry`` builds, ``(HeaacState, ps_hist,
qwire carry)``.  These two functions move that carry between the port
and the JAX package's numpy form (float32 / int32 leaves, ``ps_pcb``
int8), so tests can start both sides from the same mid-stream state and
compare the carries after T frames.
"""
from __future__ import annotations

import numpy as np
import torch

from .heaac_graph import HeaacState


def _to_tensor(a, device):
    a = np.asarray(a)
    dt = np.float32 if np.issubdtype(a.dtype, np.floating) else np.int64
    return torch.from_numpy(np.array(a, dt)).to(device)


def _tree(x, fn):
    if isinstance(x, dict):
        return {k: _tree(v, fn) for k, v in x.items()}
    return fn(x)


def carry_from_numpy(tree, device):
    """(state, ps_hist, qcarry) with numpy leaves — state a HeaacState-like
    NamedTuple or a dict of its fields — -> the port's carry."""
    state, ph, qc = tree
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    conv = lambda a: _to_tensor(a, device)  # noqa: E731
    return (HeaacState(**{k: conv(v) for k, v in fields.items()}),
            _tree(ph, conv), _tree(qc, conv))


def _to_numpy(t):
    a = t.detach().cpu().numpy()
    return a.astype(np.float32 if a.dtype.kind == "f" else np.int32)


def carry_to_numpy(carry):
    """The port's carry -> (state dict, ps_hist dict, qcarry dict) of
    numpy arrays with the JAX package's dtypes."""
    state, ph, qc = carry
    qn = _tree(qc, _to_numpy)
    qn["ps_pcb"] = qn["ps_pcb"].astype(np.int8)
    return ({k: _to_numpy(v) for k, v in state._asdict().items()},
            _tree(ph, _to_numpy), qn)
