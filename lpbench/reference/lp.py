"""The LPs the harness hands both sides, and the plain reading of an answer.

An LP is given by rows: minimize c·x subject to, for each row i,
A[i]·x (<=, =, >=) rhs[i] as `sense[i]` is -1, 0 or +1, and lo <= x <= hi
(±inf where a side is open).  The harness builds the program's inputs from
these arrays, and the reference solves the same arrays.  Nothing here
imports the program.
"""

from __future__ import annotations

import dataclasses

import numpy as np

LE, EQ, GE = -1, 0, 1


@dataclasses.dataclass
class RowLP:
    c: np.ndarray       # (n,)
    A: np.ndarray       # (m, n), dense f64
    sense: np.ndarray   # (m,), LE / EQ / GE
    rhs: np.ndarray     # (m,)
    lo: np.ndarray      # (n,)
    hi: np.ndarray      # (n,)

    def with_row(self, row: np.ndarray, sense: int, rhs: float) -> "RowLP":
        return dataclasses.replace(
            self, A=np.vstack([self.A, row[None, :]]),
            sense=np.append(self.sense, sense), rhs=np.append(self.rhs, rhs))

    def with_bounds(self, j: int, lo: float, hi: float) -> "RowLP":
        new_lo, new_hi = self.lo.copy(), self.hi.copy()
        new_lo[j], new_hi[j] = lo, hi
        return dataclasses.replace(self, lo=new_lo, hi=new_hi)


def scale(lp: RowLP) -> float:
    """1 + the largest finite magnitude among rhs and bounds."""
    vals = [np.abs(lp.rhs)]
    for v in (lp.lo, lp.hi):
        vals.append(np.abs(v[np.isfinite(v)]))
    return 1.0 + max(float(v.max()) if v.size else 0.0 for v in vals)


def violation(lp: RowLP, x: np.ndarray) -> float:
    """The largest violation of a row or a bound by `x`, over `scale(lp)`."""
    x = np.asarray(x, dtype=np.float64)
    ax = lp.A @ x
    row = np.where(lp.sense == LE, ax - lp.rhs,
                   np.where(lp.sense == GE, lp.rhs - ax, np.abs(ax - lp.rhs)))
    bound = np.maximum(lp.lo - x, x - lp.hi)
    worst = max(float(np.max(row, initial=0.0)), float(np.max(bound, initial=0.0)), 0.0)
    return worst / scale(lp)


@dataclasses.dataclass
class StandardLP:
    """min c·x + const  s.t.  A x = b,  0 <= x <= u  (u may be inf), with the
    map back to the row LP's variables: x_row = lo_shift + sign · x[col]
    (col -1: fixed at lo_shift)."""
    A: np.ndarray
    b: np.ndarray
    c: np.ndarray
    u: np.ndarray
    const: float


def standard_form(lp: RowLP) -> StandardLP:
    """A slack column per inequality row; fixed variables moved to the right
    side; a variable open below and bounded above flipped; a free variable
    split in two; every lower bound shifted to 0."""
    m, n = lp.A.shape
    cols, costs, uppers = [], [], []
    b = lp.rhs.astype(np.float64).copy()
    const = 0.0
    for j in range(n):
        lo, hi, a, cj = lp.lo[j], lp.hi[j], lp.A[:, j], lp.c[j]
        if np.isfinite(lo) and lo == hi:
            b -= a * lo
            const += cj * lo
        elif np.isfinite(lo):
            b -= a * lo
            const += cj * lo
            cols.append(a); costs.append(cj); uppers.append(hi - lo)
        elif np.isfinite(hi):
            b -= a * hi
            const += cj * hi
            cols.append(-a); costs.append(-cj); uppers.append(np.inf)
        else:
            cols.extend([a, -a]); costs.extend([cj, -cj]); uppers.extend([np.inf, np.inf])
    for i in np.flatnonzero(lp.sense != EQ):
        e = np.zeros(m)
        e[i] = 1.0 if lp.sense[i] == LE else -1.0
        cols.append(e); costs.append(0.0); uppers.append(np.inf)
    A = np.stack(cols, axis=1) if cols else np.zeros((m, 0))
    return StandardLP(A=A, b=b, c=np.asarray(costs, np.float64),
                      u=np.asarray(uppers, np.float64), const=const)
