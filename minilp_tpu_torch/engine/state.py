"""Solver state, PyTorch port.

The reference's `Solver` struct holds the basis, variable states, current values,
reduced costs and the factorized basis (`src/solver.rs (struct Solver)` [CODE]).
Here, as in the JAX package, that state is one flat NamedTuple (SURVEY.md
§6.4): the warm-start handle and the carry of the f64 engine's loop.  Its
leaves are torch tensors on one device, or host numpy arrays for a state
rebuilt on the host after a solve (`driver._state_from_certified_basis`).

`state_from_numpy` / `state_to_numpy` carry a state across packages as
numpy arrays: the tests hand the JAX package's state to the port (and back)
through them, so both solve from the same `(basis, vstat, Binv)`.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch


class SimplexState(NamedTuple):
    """Carry of the simplex loop; every field is a tensor or a numpy array.

    Invariants between iterations (up to roundoff, restored at refactorization):
      * ``basis`` holds the column index of the basic variable of each row;
        ``vstat[basis] == BASIC`` and exactly M entries of ``vstat`` are BASIC.
      * ``Binv @ A[:, basis] == I``.
      * ``xB == Binv @ (b - A @ x_nonbasic)``.
      * ``d == c - (c[basis] @ Binv) @ A`` with ``d[basis] == 0`` (phase 2 only).
    """

    basis: torch.Tensor   # (M,) int64 — basic variable per row
    vstat: torch.Tensor   # (N,) int8  — VarStat per variable
    xB: torch.Tensor      # (M,) f     — values of basic variables
    d: torch.Tensor       # (N,) f     — reduced costs (valid during phase 2)
    Binv: torch.Tensor    # (M, M) f   — maintained basis inverse
    obj: torch.Tensor     # ()  f      — canonical (minimize-form) objective value
    niter: torch.Tensor   # ()  int32  — total simplex iterations so far
    status: torch.Tensor  # ()  int32  — Status code
    noimprove: torch.Tensor  # () int32 — iterations since last progress (anti-cycling)
    best: torch.Tensor    # ()  f      — best progress metric seen (phase-dependent)
    weights: torch.Tensor  # (N,) f    — Devex reference weights γ (pricing)
    phase: torch.Tensor   # () int32  — 1 (feasibility) or 2 (optimality)


#: dtype of each integer field (float fields take the caller's dtype)
_INT_FIELDS = {
    "basis": torch.int64, "vstat": torch.int8, "niter": torch.int32,
    "status": torch.int32, "noimprove": torch.int32, "phase": torch.int32,
}


def state_from_numpy(fields, device, dtype=torch.float64) -> SimplexState:
    """Build a tensor `SimplexState` on `device` from numpy-convertible fields
    (a `SimplexState` of either package, or a mapping of field name → array).
    Integer fields keep their integer meaning; float fields take `dtype`."""
    if not isinstance(fields, dict):
        fields = fields._asdict()
    device = torch.device(device)
    out = {}
    for name in SimplexState._fields:
        arr = np.asarray(fields[name])
        out[name] = torch.tensor(
            arr, dtype=_INT_FIELDS.get(name, dtype), device=device
        )
    return SimplexState(**out)


def state_to_numpy(state: SimplexState) -> SimplexState:
    """Copy every field of `state` to host numpy (tensors or numpy alike)."""
    return SimplexState(*(
        v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)
        for v in state
    ))
