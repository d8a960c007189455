"""Pricing: choose the entering variable (PyTorch port of `minilp_tpu.ops.pricing`).

Reference analog: `choose_entering_col` (`src/solver.rs` [CODE]; SURVEY.md §3.2
"Pricing": full pricing over all non-basic columns, Dantzig + steepest-edge),
written as masked argmax reductions over tensors.

Determinism: every argmax/argmin breaks ties toward the *lowest index*
(`torch.argmax`/`torch.argmin` return the first extremum, as `jnp.argmax`
does), so the port takes the JAX package's pivot sequence.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..status import VarStat


class EnteringChoice(NamedTuple):
    q: int              # entering column (undefined if not found)
    direction: float    # +1 if entering increases, -1 if it decreases
    found: bool         # any eligible column exists


def eligibility(d: torch.Tensor, vstat: torch.Tensor, opt_tol: float):
    """Masks of columns eligible to enter moving up / down.

    A non-basic variable may increase from its lower bound (or from 0 if free)
    when its reduced cost is < -tol, and decrease from its upper bound (or free)
    when > +tol.  BASIC and FIXED variables are never eligible — this is what
    keeps padding columns inert.
    """
    can_incr = (vstat == VarStat.AT_LOWER) | (vstat == VarStat.FREE)
    can_decr = (vstat == VarStat.AT_UPPER) | (vstat == VarStat.FREE)
    elig_up = can_incr & (d < -opt_tol)
    elig_dn = can_decr & (d > opt_tol)
    return elig_up, elig_dn


def entering_scores(d: torch.Tensor, vstat: torch.Tensor, opt_tol: float,
                    weights: Optional[torch.Tensor] = None):
    """(score, elig): each column's pricing score, −inf where it may not
    enter, and the eligibility mask.  The score is d_j² (Dantzig), or
    d_j²/γ_j with steepest-edge/Devex `weights` γ."""
    elig_up, elig_dn = eligibility(d, vstat, opt_tol)
    elig = elig_up | elig_dn
    score = d * d
    if weights is not None:
        score = score / torch.clamp(weights, min=1e-12)
    return torch.where(elig, score, -torch.inf), elig


def choose_entering(
    d: torch.Tensor,
    vstat: torch.Tensor,
    opt_tol: float,
    bland: bool,
    weights: Optional[torch.Tensor] = None,
) -> EnteringChoice:
    """Pick the entering column from reduced costs `d`.

    * Default rule: largest |d_j| (Dantzig) or largest d_j²/γ_j when steepest-edge
      /Devex `weights` γ are provided (SURVEY.md §3.2 "Pricing").
    * `bland`: lowest eligible index — anti-cycling fallback.
    """
    n = d.shape[0]
    score, elig = entering_scores(d, vstat, opt_tol, weights)
    found = bool(elig.any())
    if bland:
        idx = torch.arange(n, device=d.device)
        q = int(torch.argmin(torch.where(elig, idx, n)))
    else:
        q = int(torch.argmax(score))
    direction = 1.0 if float(d[q]) < 0 else -1.0
    return EnteringChoice(q=q, direction=direction, found=found)


def phase1_sigma(
    xB: torch.Tensor, loB: torch.Tensor, hiB: torch.Tensor, feas_tol: float
):
    """Phase-1 infeasibility costs σ per basic row and the total infeasibility.

    σ_i = −1 if x_i < l_i (infeasibility falls as x_i rises), +1 if x_i > u_i,
    else 0 (SURVEY.md §3.2 "Canonicalization"/Phase 1; `find_initial_bfs` [CODE]).
    """
    below = xB < loB - feas_tol
    above = xB > hiB + feas_tol
    one = torch.ones_like(xB)
    sigma = torch.where(below, -one, torch.where(above, one, 0.0 * one))
    # lo=-inf / hi=+inf give -inf in the difference; clamp(·, 0) absorbs them
    viol = torch.clamp(loB - xB, min=0.0) + torch.clamp(xB - hiB, min=0.0)
    return sigma, viol.sum()


def phase1_reduced_costs(
    A: torch.Tensor, Binv: torch.Tensor, sigma: torch.Tensor, vstat: torch.Tensor
) -> torch.Tensor:
    """Phase-1 reduced costs d¹ = −(σᵀB⁻¹)A, zeroed on basic columns.

    The phase-1 objective (total infeasibility) has per-iteration costs σ on the
    *basic* variables only, so d¹ is recomputed each iteration.
    """
    y = sigma @ Binv
    d1 = -(y @ A)
    return torch.where(vstat == VarStat.BASIC, 0.0, d1)
