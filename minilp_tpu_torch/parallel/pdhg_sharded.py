"""Row-sharded (distributed) PDHG, PyTorch port of
`minilp_tpu/parallel/pdhg_sharded.py`: when one instance's constraint
dimension outgrows one device, the rows of A are partitioned over a mesh
axis and the PDHG loop is otherwise unchanged.

Layout, on each rank of the axis's group:

* A            → its (M/P, N) row block
* b, y, dr     → its (M/P,) row blocks (beside their rows of A)
* x, c, lo, hi, dc → replicated (N,)

The loop (`engine/pdhg.py::_run_pdhg`) touches A only through `@`:

* ``A @ x``: each rank multiplies its block by the replicated x, giving its
  own rows of the result; no communication.
* ``Aᵀ @ y``: each rank computes its partial ``A_blkᵀ y_blk`` and one
  all-reduce sum over the group gives the replicated (N,) result, the only
  per-iteration collective.

Row-space norms and dots (the KKT error, the certificates, the ω fit)
reduce through the same sums by the `RowReduce` seam, so every scalar the
loop branches on (restart, termination, status) is the same on every rank:
all ranks take the same decisions.  Repeated runs are bit-identical (the
group's reduction order is fixed); against the single-device engine only
the order of the sums differs.

Padding rows (to make M divisible by the axis size) are zero rows with
b = 0: Ruiz leaves their scale at 1, their dual iterate stays 0, and they
add 0 to every reduction.
"""

from __future__ import annotations

import torch

from ..engine.pdhg import PdhgState, RowReduce, _omega0, _ruiz_dense, _run_pdhg
from ..options import SolverOptions
from .collectives import pmax, psum
from .mesh import COL_AXIS, assemble, replicated, row_block


class _RowBlockOp:
    """The local row block of a row-sharded A: `op @ x` → this rank's rows."""

    def __init__(self, blk):
        self.blk = blk

    def __matmul__(self, x):
        return self.blk @ x


class _RowBlockOpT:
    """Aᵀ against a row-sharded y: a local partial product plus one sum."""

    def __init__(self, blk, group):
        self.blk = blk
        self.group = group

    def __matmul__(self, y_blk):
        return psum(self.blk.T @ y_blk, self.group)


def solve_pdhg_sharded(mesh, A, b, c, lo, hi, opts: SolverOptions,
                       axis_name: str = COL_AXIS) -> PdhgState:
    """Solve one canonical LP with the rows of A sharded over `axis_name`.

    Same contract as `engine.pdhg.solve_pdhg` (x/y in the ORIGINAL space,
    exact Status claims), with global inputs and the whole state on every
    rank: rows are zero-padded to a multiple of the axis size, and the
    padding is stripped from the returned state.  Every rank of the mesh
    calls it.  The mesh comes first, as in the other sharded entry points
    (the JAX package's function takes it after `opts`).
    """
    group = mesh.groups[axis_name]
    A = replicated(mesh, A)
    b = replicated(mesh, b)
    M = A.shape[0]
    parts = mesh.shape[axis_name]
    Mp = -(-M // parts) * parts
    if Mp != M:
        A = torch.cat([A, A.new_zeros((Mp - M, A.shape[1]))])
        b = torch.cat([b, b.new_zeros(Mp - M)])
    A_blk, b_blk = row_block(mesh, A, axis_name), row_block(mesh, b, axis_name)
    c, lo, hi = (replicated(mesh, v) for v in (c, lo, hi))

    rr = RowReduce(sum=lambda s: psum(s, group), max=lambda v: pmax(v, group))
    dr_blk, dc = _ruiz_dense(A_blk, opts.pdhg_ruiz_iters, rr)
    As = A_blk * dr_blk[:, None] * dc[None, :]
    bs = b_blk * dr_blk
    om0 = _omega0(bs, c * dc, dr_blk, dc, opts, rr)
    st = _run_pdhg(_RowBlockOp(As), _RowBlockOpT(As, group), bs, c * dc,
                   lo / dc, hi / dc, dr_blk, dc, opts, om0, rr)
    whole = lambda v: assemble(mesh, v, axis_name, 0)[:M]
    return st._replace(y=whole(st.y), y_sum=whole(st.y_sum), y_rst=whole(st.y_rst))
