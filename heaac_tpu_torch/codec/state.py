"""Decode carry <-> numpy, in the JAX package's layout.

The decoder has no weights: its "parameters" are the constant tables and
the carries.  The HE carry is what ``init_qwire_carry`` builds,
``(HeaacState, ps_hist, qwire carry)``, and the band-mode flip scan's
adds a trailing ``m34_prev`` [B] (``init_qwire_flip_carry``); its PS
allpass state keeps 50 rows in both band modes (the 20-band mode uses
rows :30).  The AAC-LC
carry is the overlap buffer ``saved`` [L, 512] of ``lc_scan_decode``.
These two functions move either carry between the port and the JAX
package's numpy form (float32 / int32 leaves, ``ps_pcb`` int8), so tests
can start both sides from the same mid-stream state and compare the
carries after T frames.
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
    """(state, ps_hist, qcarry[, m34_prev]) with numpy leaves — state a
    HeaacState-like NamedTuple or a dict of its fields — -> the port's HE
    carry (the flip scan's with m34_prev); an array (the LC ``saved``) ->
    a tensor."""
    if not isinstance(tree, tuple):
        return _to_tensor(tree, device)
    state, ph, qc, *m34_prev = tree
    fields = state._asdict() if hasattr(state, "_asdict") else dict(state)
    conv = lambda a: _to_tensor(a, device)  # noqa: E731
    return (HeaacState(**{k: conv(v) for k, v in fields.items()}),
            _tree(ph, conv), _tree(qc, conv)) + tuple(
                conv(a) for a in m34_prev)


def _to_numpy(t):
    a = t.detach().cpu().numpy()
    return a.astype(np.float32 if a.dtype.kind == "f" else np.int32)


def carry_to_numpy(carry):
    """The port's HE carry -> (state dict, ps_hist dict, qcarry dict[,
    m34_prev]) of numpy arrays with the JAX package's dtypes; the LC
    ``saved`` tensor -> a float32 array."""
    if isinstance(carry, torch.Tensor):
        return _to_numpy(carry)
    state, ph, qc, *m34_prev = carry
    qn = _tree(qc, _to_numpy)
    qn["ps_pcb"] = qn["ps_pcb"].astype(np.int8)
    return ({k: _to_numpy(v) for k, v in state._asdict().items()},
            _tree(ph, _to_numpy), qn) + tuple(_to_numpy(a) for a in m34_prev)
