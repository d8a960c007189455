"""Checkpoint / resume: serialize the warm-start state (SURVEY.md §6.4), PyTorch port.

Port of `minilp_tpu.utils.checkpoint`.  The solver state is one flat
`SimplexState`, so a checkpoint is its arrays in a `numpy.savez` file with
one entry per field, the JAX package's layout: a file that either package
writes, the other reads.  `load_state` returns host numpy arrays, the form of
an `EngineHandle`'s state, ready for the incremental API.

Unlike the JAX package's `save_state`, this one refuses a state whose B⁻¹ is
not (M, M) with M = len(basis): a handle's raw `_state` may hold the lazy
(0, 0) placeholder, and a checkpoint of it could not seed a warm restart.
Save `handle.state`, which materializes the inverse.
"""

from __future__ import annotations

import numpy as np

from ..engine.state import SimplexState, state_to_numpy

_FIELDS = SimplexState._fields


def save_state(path: str, state: SimplexState) -> None:
    """Write the solver state (torch tensors or numpy arrays) to `path` (.npz)."""
    state = state_to_numpy(state)
    M = len(state.basis)
    if state.Binv.shape != (M, M):
        raise ValueError(
            f"save_state: B⁻¹ has shape {state.Binv.shape}, expected {(M, M)}; "
            "save `handle.state`, which materializes the lazy inverse"
        )
    np.savez(path, **{f: getattr(state, f) for f in _FIELDS})


def load_state(path: str) -> SimplexState:
    """Read a solver state written by either package's `save_state`."""
    with np.load(path) as z:
        return SimplexState(**{f: z[f] for f in _FIELDS})
