"""The columns of A as the simplex loops see them.

`engine/primal.py::run_simplex` and `engine/dual.py::run_dual` touch the
column space of the LP (A, c, lo, hi and the column-sized state: vstat, d,
the Devex weights) only through a `Columns` object.  This one holds every
column on one device, and each of its primitives is a plain index or
reduction.  `parallel/sharded_engine.py::_Shard` holds one rank's block of
columns and implements the same primitives with collectives, so the
column-sharded engines run these same loops.
"""

from __future__ import annotations

import torch

from ..status import Status
from .basis import refactorize


class Columns:
    """All N columns of one canonical LP on one device."""

    def __init__(self, A, b, c, lo, hi):
        self.A, self.b, self.c, self.lo, self.hi = A, b, c, lo, hi
        self.offset = 0  # global index of this block's first column
        self.dtype, self.device = A.dtype, A.device

    def place(self, basis, vstat):
        """(basis, vstat) as this block's int64 basis and int8 vstat."""
        return (torch.as_tensor(basis, device=self.device).to(torch.int64),
                torch.as_tensor(vstat, device=self.device).to(torch.int8))

    def set(self, vec: torch.Tensor, j: int, value) -> None:
        """vec[j] = value for global column j, where this block holds it."""
        if self.offset <= j < self.offset + vec.shape[0]:
            vec[j - self.offset] = value

    def gather_column(self, q: int, *vecs):
        """Column q of A and the values of the column-sized `vecs` at q."""
        return self.A[:, q], tuple(v[q] for v in vecs)

    def basic_bounds(self, basis):
        """(lo[basis], hi[basis])."""
        return self.lo[basis], self.hi[basis]

    def refactorize(self, basis, vstat, seed, newton_iters: int):
        """(Binv, xB, d, loB, hiB, obj, ok), as `basis.refactorize` gives
        them plus the basic variables' bounds."""
        Binv, xB, d, obj, ok = refactorize(
            self.A, self.b, self.c, self.lo, self.hi, basis, vstat, seed,
            newton_iters=newton_iters,
        )
        return (Binv, xB, d) + self.basic_bounds(basis) + (obj, ok)

    def choose(self, score, elig, bland: bool):
        """(found, q): the eligible column of the largest `score` (−inf
        where not eligible), the first of ties; under Bland the lowest
        eligible index."""
        if bland:
            n = elig.shape[0]
            q = torch.argmin(torch.where(elig, torch.arange(n, device=elig.device), n))
        else:
            q = torch.argmax(score)
        return bool(elig.any()), int(q)

    def min(self, x: torch.Tensor) -> torch.Tensor:
        """The elementwise minimum of `x` over every block."""
        return x

    def running(self, status: int, niter: int, max_iter: int) -> bool:
        """The loop's condition."""
        return status == Status.RUNNING and niter < max_iter
