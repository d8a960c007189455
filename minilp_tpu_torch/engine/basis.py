"""Basis maintenance: inverse representation, product-form update, refactorization.

PyTorch port of `minilp_tpu.engine.basis` (reference counterpart: `BasisSolver`
+ `src/lu.rs`, C3/C4 in SURVEY.md §3.1).  As in the JAX package the basis
inverse is dense: FTRAN is one mat-vec, BTRAN of a unit vector is a row read,
a pivot is a rank-1 product-form update, and refactorization refines the
maintained inverse by Newton–Schulz sweeps (X ← X + X(I − BX)) instead of an
LU, so that the port takes the reference's pivot sequence.
"""

from __future__ import annotations

import torch

from ..status import VarStat


def nonbasic_values(vstat: torch.Tensor, lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    """Per-variable value implied by non-basic status; BASIC/FREE entries → 0.

    Non-basic variables rest at a bound (SURVEY.md §3.2); FIXED uses the
    (equal) lower bound.
    """
    x = torch.where(vstat == VarStat.AT_LOWER, lo, 0.0)
    x = torch.where(vstat == VarStat.AT_UPPER, hi, x)
    x = torch.where(vstat == VarStat.FIXED, lo, x)
    return x


def stable_inverse(B: torch.Tensor) -> torch.Tensor:
    """Inverse of the basis matrix: a straight LU inverse.

    This is the JAX package's non-TPU branch; its TPU branch (f32 seed plus
    f64 Newton refinement, for a backend without f64 LU) has no counterpart
    here.
    """
    return torch.linalg.inv(B)


def basis_matrix(A: torch.Tensor, basis: torch.Tensor) -> torch.Tensor:
    """Gather the basic columns: B = A[:, basis] (shape (M, M))."""
    return A[:, basis]


def newton_refresh(B: torch.Tensor, X: torch.Tensor, iters: int):
    """Newton–Schulz refinement X ← X + X(I − BX) of an approximate inverse.

    Quadratically convergent while ‖I − BX‖ < 1; the product-form maintained
    inverse accumulates only roundoff between refactorizations, so it is deep
    inside the basin.  Returns (X_refined, resid) with resid = max|I − BX|
    *before* the last correction — a divergence telltale for the caller.
    """
    eye = torch.eye(B.shape[0], dtype=B.dtype, device=B.device)
    R = eye - B @ X
    resid = R.abs().max()
    for _ in range(max(iters, 1)):
        X = X + X @ R
        R = eye - B @ X
    return X, torch.minimum(resid, R.abs().max())


def refactorize(A, b, c, lo, hi, basis, vstat, seed_Binv, newton_iters: int = 3):
    """Rebuild (Binv, xB, d, obj, ok) from (basis, vstat) and an inverse seed.

    Equivalent of `BasisSolver::reset` (SURVEY.md §4.4) minus the ordering
    stage.  `ok=False` signals the seed was outside Newton's basin
    (‖I − B·seed‖ ≥ 1); the engine then exits with Status.NUMERICAL and the
    driver rebuilds the inverse exactly and resumes.
    """
    B = basis_matrix(A, basis)
    Binv, resid = newton_refresh(B, seed_Binv, newton_iters)
    ok = bool(resid < 0.5)
    xN = nonbasic_values(vstat, lo, hi)
    rhs_eff = b - A @ xN
    xB = Binv @ rhs_eff
    cB = c[basis]
    y = cB @ Binv
    d = c - y @ A
    d = torch.where(vstat == VarStat.BASIC, 0.0, d)
    obj = cB @ xB + c @ xN
    return Binv, xB, d, obj, ok


def ftran(Binv: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """FTRAN: solve B·w = col (`calc_col_coeffs` [CODE]) — one mat-vec."""
    return Binv @ col


def pfi_update(Binv: torch.Tensor, w: torch.Tensor, r: int) -> torch.Tensor:
    """Product-form pivot update of the inverse (returns a new tensor).

    Row r is scaled by 1/w_r and every other row i subtracts w_i times it —
    a rank-1 outer product (reference: eta-file append, `push_eta_matrix`
    [CODE]; SURVEY.md §3.2).
    """
    pr = Binv[r] / w[r]
    Binv = Binv - torch.outer(w, pr)
    Binv[r] = pr
    return Binv
