"""Column-sharded (tensor-parallel) revised simplex, PyTorch port of
`minilp_tpu/parallel/sharded_engine.py`: the primal solve loop and the dual
warm re-solve with the columns of A partitioned over the mesh's 'model'
axis.

Each rank of the model group owns a contiguous block of the columns of A
(and of c, lo, hi, d, vstat and the Devex weights); row-sized state (the
basis, the maintained inverse, the basic values and their bounds) is
replicated.  The loops are the single-device ones, `engine/primal.py::
run_simplex` and `engine/dual.py::run_dual`: they touch the column space
only through a `Columns` object (`engine/columns.py`), and `_Shard` is the
one that holds this rank's block.  Per iteration:

  * pricing: each rank scores its own columns, and one (score, global index)
    pair per rank is exchanged (`collectives.argmax_with_index`): the lowest
    global index wins ties, as the single-device argmax does;
  * the entering column and its scalars (d_q, lo_q, hi_q, its status and
    Devex weight) come from their owner in one exact gather
    (`collectives.exact_sum`); FTRAN and the ratio test then run replicated
    on row-sized data;
  * the pivot's O(M·N/P) work (the pivot row α = B⁻¹[r]·A, the reduced-cost
    and Devex updates) is local to each rank; the dual's step bounds come
    from one `pmin` (exact);
  * a refactorization gathers B = A[:, basis] and lo_B/hi_B/c_B exactly from
    their owners, refines the inverse replicated, and sums the partial
    products A·x_N and c·x_N.

Each branch of the loops is an `if` on a value that every rank holds alike:
the result of a collective, or of the same operations on replicated tensors
on the same kind of device.  Once a pivot the ranks compare (status, niter)
in one collective and raise if they differ, so no rank can leave the loop
alone.

Determinism: the choices replicate exactly.  Every gather has one owner
per element and is summed as integer bits, and min/max have no order.  The
one place where values can differ from the single-device engine in the last
ulp is the sum over all columns of A·x_N and c·x_N in a refactorization
(the grouping of the partial sums differs), after which a near-tie could
break otherwise; on an instance whose non-basic values are all zero that
sum is exact (`tests/test_torch_parallel.py`, the all-ties instance).

Deviations from the JAX package's sharded loops, which follow from running
the single-device loops: the primal's ratio test is `ops.ratio.ratio_test`
itself, Harris's first pass included (the JAX package's sharded primal
keeps only the tie window); the primal refactorizes where the single-device
loop does (the phase change at the top of an iteration, the periodic
refresh right after its pivot, where the JAX package's sharded loop merges
both at the top); a cold start whose inverse misses Newton's basin starts
NUMERICAL; the dual counts the iteration that finds the LP infeasible, as
`engine/dual.py` does.
"""

from __future__ import annotations

import torch

from ..engine.basis import newton_refresh, nonbasic_values
from ..engine.columns import Columns
from ..engine.dual import run_dual
from ..engine.primal import run_simplex, start_state
from ..options import SolverOptions
from ..status import VarStat
from .collectives import exact_sum, pmin, psum
from .mesh import COL_AXIS, assemble, column_block, replicated
from .pricing import global_choice


class _Shard(Columns):
    """This rank's column block of one canonical LP: the `Columns`
    primitives with the collectives of the mesh's 'model' group."""

    def __init__(self, mesh, A, b, c, lo, hi, opts: SolverOptions):
        M, N = torch.as_tensor(A).shape
        if N % mesh.shape[COL_AXIS]:
            raise ValueError(f"N={N} not divisible by model axis {mesh.shape[COL_AXIS]}")
        super().__init__(column_block(mesh, A), replicated(mesh, b),
                         *(column_block(mesh, v) for v in (c, lo, hi)))
        self.mesh, self.group = mesh, mesh.groups[COL_AXIS]
        self.M = M
        self.n_loc = self.A.shape[1]
        self.offset = mesh.coords[COL_AXIS] * self.n_loc
        self.max_iter = opts.effective_max_iter(M, N)

    def place(self, basis, vstat):
        return (replicated(self.mesh, basis).to(torch.int64),
                column_block(self.mesh, torch.as_tensor(vstat)).to(torch.int8))

    def _owned(self, basis):
        """(mask of the rows whose basic column is this rank's, their local
        indices, clamped into the block)."""
        own = (basis >= self.offset) & (basis < self.offset + self.n_loc)
        return own, (basis - self.offset).clamp(0, self.n_loc - 1)

    def gather_column(self, q: int, *vecs):
        """Column q of A and the values of the column-sharded `vecs` at q,
        from their owner, exactly: one collective."""
        if self.offset <= q < self.offset + self.n_loc:
            j = q - self.offset
            buf = torch.cat([self.A[:, j], torch.stack([v[j].to(self.dtype) for v in vecs])])
        else:
            buf = torch.zeros(self.M + len(vecs), dtype=self.dtype, device=self.device)
        got = exact_sum(buf, self.group)
        return got[:self.M], tuple(got[self.M:])

    def basic_bounds(self, basis):
        own, loc = self._owned(basis)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        got = exact_sum(torch.cat([torch.where(own, v[loc], zero) for v in (self.lo, self.hi)]),
                        self.group)
        return got[:self.M], got[self.M:]

    def refactorize(self, basis, vstat, seed, newton_iters: int):
        """(Binv, xB, d, loB, hiB, obj, ok) from (basis, vstat) and an
        inverse seed, as `engine.basis.refactorize` computes them."""
        M = self.M
        own, loc = self._owned(basis)
        zero = torch.zeros((), dtype=self.dtype, device=self.device)
        part = torch.cat([torch.where(own[None, :], self.A[:, loc], zero).reshape(-1)]
                         + [torch.where(own, v[loc], zero) for v in (self.lo, self.hi, self.c)])
        got = exact_sum(part, self.group)
        B = got[:M * M].reshape(M, M)
        loB, hiB, cB = got[M * M:].reshape(3, M).clone()
        Binv, resid = newton_refresh(B, seed, newton_iters)
        ok = bool(resid < 0.5)
        xN = nonbasic_values(vstat, self.lo, self.hi)
        # the one inexact reduction: partial sums over each rank's columns
        sums = psum(torch.cat([self.A @ xN, (self.c @ xN).reshape(1)]), self.group)
        xB = Binv @ (self.b - sums[:M])
        y = cB @ Binv
        d = torch.where(vstat == VarStat.BASIC, 0.0, self.c - y @ self.A)
        obj = cB @ xB + sums[M]
        return Binv, xB, d, loB, hiB, obj, ok

    def choose(self, score, elig, bland: bool):
        best, q = global_choice(score, elig if bland else None, self.offset, self.group)
        return bool(best > -torch.inf), int(q)

    def min(self, x):
        return pmin(x, self.group)

    def running(self, status: int, niter: int, max_iter: int) -> bool:
        """The loop's condition, after checking that every rank of the model
        group holds the same (status, niter): one collective."""
        v = torch.tensor([status, niter, -status, -niter], dtype=torch.int64,
                         device=self.device)
        lo_st, lo_it, neg_hi_st, neg_hi_it = pmin(v, self.group).tolist()
        if lo_st != -neg_hi_st or lo_it != -neg_hi_it:
            raise RuntimeError(
                f"the ranks of the model axis diverged: status {lo_st}..{-neg_hi_st}, "
                f"niter {lo_it}..{-neg_hi_it}")
        return super().running(status, niter, max_iter)

    def result(self, st) -> dict:
        whole = lambda v: assemble(self.mesh, v, COL_AXIS, 0)
        return {
            "basis": st.basis, "vstat": whole(st.vstat), "obj": st.obj,
            "niter": st.niter, "status": st.status,
            # warm-start handoff: the maintained inverse and basic values
            # (replicated), reduced costs and Devex weights (reassembled)
            # seed `resolve_dual_sharded` after a problem edit
            "Binv": st.Binv, "xB": st.xB, "d": whole(st.d), "weights": whole(st.weights),
        }


def solve_canonical_sharded(mesh, A, b, c, lo, hi, vstat0, basis0, opts: SolverOptions):
    """Cold solve with the columns of A sharded over the mesh's 'model' axis.

    Same contract as `engine.primal.solve_canonical` (global inputs; every
    rank returns a dict of the final basis, vstat, obj, niter and status,
    plus the warm state: Binv, xB, d, weights).  N must divide evenly by the
    axis size.  Every rank of the mesh calls it.
    """
    S = _Shard(mesh, A, b, c, lo, hi, opts)
    eye = torch.eye(S.M, dtype=S.dtype, device=S.device)
    state = start_state(S, basis0, vstat0, eye, opts, phase=1)
    return S.result(run_simplex(S, opts, state, S.max_iter))


def resolve_dual_sharded(mesh, A, b, c, lo, hi, basis0, vstat0, Binv0, opts: SolverOptions):
    """Column-sharded dual simplex warm restart (`engine.dual.resolve_dual`,
    distributed): the leaving row from the replicated inverse's row norms,
    the pivot row α = B⁻¹[r]·A on each rank's own columns, the global step
    bounds of the Harris two-pass ratio test by one `pmin`, the entering
    column by the lowest-index `argmax_with_index`.

    `vstat0` is the full (N,) vector and `Binv0` the maintained (M, M)
    inverse of a previous sharded (or single-device) solve.  Returns the
    same dict as `solve_canonical_sharded`, warm state included.
    """
    S = _Shard(mesh, A, b, c, lo, hi, opts)
    seed = torch.as_tensor(Binv0, dtype=S.dtype, device=S.device)
    state = start_state(S, basis0, vstat0, seed, opts, phase=2)
    return S.result(run_dual(S, opts, state, S.max_iter))
