"""Canonicalization: user Problem → padded computational standard form.

The reference canonicalizes in `Solver::try_new` (`src/solver.rs` [CODE], SURVEY.md
§3.2): each `≤`/`≥` row gets a slack whose sign/bounds encode the direction, `=`
rows get a zero-width (fixed) slack, the initial basis is the slack set, and
maximization is handled by negating the objective internally.  We reproduce those
semantics, but the output is designed for XLA rather than for sparse CPU loops:

* **Dense padded arrays, static shapes.** Rows are padded to a multiple of
  `row_align` (TPU sublane), total columns to a multiple of `col_align` (TPU lane).
  Padding rows are all-zero with a fixed `[0,0]` slack that starts (and provably
  stays) basic at value 0; padding columns are fixed `[0,0]` variables that can
  never enter.  Padding is therefore *inert* under simplex dynamics — no masking
  needed in the hot loop.
* **Padding doubles as row capacity.** The incremental API (`Solution.add_constraint`,
  SURVEY.md §4.2) activates a padding row in place: write the coefficients, set the
  slack bounds for the op, set b — no reshapes, no recompilation until capacity is
  exhausted (grow-by-recompile, SURVEY.md §8 Phase 3).

Column layout: ``[0, nv)`` structural variables, ``[nv, nv + M)`` one slack per
padded row (slack of row i at column nv + i), remainder inert padding.
"""

from __future__ import annotations

import dataclasses
import math
from typing import List, Tuple

import numpy as np

from .api import ComparisonOp, OptimizationDirection, Problem
from .status import VarStat


def _align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a if a > 1 else x


@dataclasses.dataclass
class CanonicalLP:
    """Padded computational standard form: minimize c·x s.t. A x = b, lo ≤ x ≤ hi.

    All arrays are numpy (host); the engine moves them to device.  Shapes:
    A: (M, N), b: (M,), c/lo/hi: (N,), vstat0: (N,) int8, basis0: (M,) int32.
    """

    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    lo: np.ndarray
    hi: np.ndarray
    vstat0: np.ndarray
    basis0: np.ndarray
    #: active rows / structural vars (unpadded counts)
    m: int
    nv: int
    #: padded dims
    M: int
    N: int
    #: +1 for Minimize, -1 for Maximize (user objective = obj_sign * canonical obj)
    obj_sign: float
    #: per-active-row ComparisonOp (host-side metadata for incremental ops)
    row_ops: List[ComparisonOp] = dataclasses.field(default_factory=list)
    #: what the exact f64 check of a basis (`engine/certificate.py`) keeps of
    #: this form: its f64 A on a card ("A") and its last certificate
    #: ("cert"), each under the key it was made for; a copy starts empty
    checks: dict = dataclasses.field(default_factory=dict, init=False, repr=False,
                                     compare=False)

    def slack_col(self, row: int) -> int:
        return self.nv + row

    def with_activated_row(self) -> "CanonicalLP":
        """Host-side copy with one more active row (used by incremental API)."""
        return dataclasses.replace(self, m=self.m + 1)

    def csc(self):
        """Cached CSC view of A (f64) for the host sparse-LA seams.

        At Netlib scale the dense→CSC conversion streams the whole padded
        matrix (~1 s at maros shape), and one cold solve crossing the
        crossover + polish + state-rebuild + certify seams used to pay it
        FOUR times (measured round 5).  The cache is invalidated by the one
        code path that mutates A after canonicalization
        (`incremental._append_row` sets `_csc_cache = None`); bound edits
        (`fix_var`/`unfix_var`) do not touch A and need no invalidation.
        """
        cache = getattr(self, "_csc_cache", None)
        if cache is None:
            import scipy.sparse as sp

            cache = sp.csc_matrix(self.A.astype(np.float64, copy=False))
            self._csc_cache = cache
        return cache


#: Bounds assigned to the slack variable of each row type.  Row is stored as
#: a·x + s = b, so  `a·x ≤ b  ⇔  s ∈ [0, ∞)`,  `a·x ≥ b ⇔ s ∈ (−∞, 0]`,
#: `a·x = b ⇔ s ∈ [0, 0]`  (reference slack/artificial scheme, SURVEY.md §3.2).
_SLACK_BOUNDS = {
    ComparisonOp.Le: (0.0, math.inf),
    ComparisonOp.Ge: (-math.inf, 0.0),
    ComparisonOp.Eq: (0.0, 0.0),
}


def initial_vstat(lo: float, hi: float) -> int:
    """Initial non-basic status for a variable with the given bounds."""
    if lo == hi:
        return int(VarStat.FIXED)
    if math.isfinite(lo):
        return int(VarStat.AT_LOWER)
    if math.isfinite(hi):
        return int(VarStat.AT_UPPER)
    return int(VarStat.FREE)


def slack_bounds(op: ComparisonOp) -> Tuple[float, float]:
    return _SLACK_BOUNDS[op]


def canonicalize(
    problem: Problem,
    extra_row_capacity: int = 0,
    dtype: np.dtype = np.float64,
) -> CanonicalLP:
    """Build the padded standard form for `problem`.

    `extra_row_capacity` reserves additional inert rows (beyond alignment padding)
    so the incremental API can activate them without recompiling.
    """
    opts = problem.options
    nv = problem.num_vars
    m = problem.num_constraints

    M = _align_up(max(m + extra_row_capacity, 1), max(opts.row_align, 1))
    n_active = nv + M  # structural + one slack per padded row
    N = _align_up(n_active, max(opts.col_align, 1))

    A = np.zeros((M, N), dtype=dtype)
    b = np.zeros((M,), dtype=dtype)
    c = np.zeros((N,), dtype=dtype)
    lo = np.zeros((N,), dtype=dtype)
    hi = np.zeros((N,), dtype=dtype)
    vstat0 = np.full((N,), int(VarStat.FIXED), dtype=np.int8)
    basis0 = np.arange(nv, nv + M, dtype=np.int32)

    obj_sign = 1.0 if problem.direction == OptimizationDirection.Minimize else -1.0

    # Structural variables.
    c[:nv] = obj_sign * np.asarray(problem._obj, dtype=dtype) if nv else 0.0
    lo[:nv] = np.asarray(problem._lo, dtype=dtype) if nv else 0.0
    hi[:nv] = np.asarray(problem._hi, dtype=dtype) if nv else 0.0
    for j in range(nv):
        vstat0[j] = initial_vstat(problem._lo[j], problem._hi[j])

    # Slack columns: identity block; all slacks start basic.
    sl = np.arange(M)
    A[sl, nv + sl] = 1.0
    vstat0[nv : nv + M] = int(VarStat.BASIC)
    # Inert rows' slacks are fixed at 0 (bounds already [0, 0]); active rows below.

    row_ops: List[ComparisonOp] = []
    for i, (terms, op, rhs) in enumerate(problem._constraints):
        for j, coeff in terms:
            A[i, j] += coeff
        b[i] = rhs
        slo, shi = slack_bounds(op)
        lo[nv + i] = slo
        hi[nv + i] = shi
        row_ops.append(op)

    # Inert padding columns beyond nv + M stay FIXED at [0, 0] with zero A column:
    # they can never be chosen entering (FIXED is never eligible).

    return CanonicalLP(
        A=A, b=b, c=c, lo=lo, hi=hi, vstat0=vstat0, basis0=basis0,
        m=m, nv=nv, M=M, N=N, obj_sign=obj_sign, row_ops=row_ops,
    )


def nonbasic_values(
    vstat: np.ndarray, lo: np.ndarray, hi: np.ndarray
) -> np.ndarray:
    """Values of non-basic variables implied by status (basic entries → 0).

    numpy version of the engine-side helper, for host-side checks.
    """
    x = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
    x = np.where(vstat == int(VarStat.AT_UPPER), hi, x)
    x = np.where(vstat == int(VarStat.FIXED), lo, x)
    return x
