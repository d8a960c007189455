"""Incremental re-solve API: add_constraint / fix_var / unfix_var / add_gomory_cut.

PyTorch port of `minilp_tpu.engine.incremental` (reference analogs:
`Solver::add_constraint`, `fix_var`, `unfix_var`, `add_gomory_cut`,
`src/solver.rs` [CODE][API]; SURVEY.md §4.2/§4.3 call stacks).

The canonical form pre-allocates inert padding rows whose fixed slacks are
already basic, so adding a constraint is an in-place write: fill the row's
coefficients, set the slack bounds for the op, set b.  When the padding is
used up the canonical form is rebuilt with more rows and the warm state
(basis, vstat, B⁻¹) carries over index for index (slack columns keep the
layout `nv + row`; B⁻¹ gains an identity block).

Every edit keeps the basis dual feasible (a new row's slack enters basic at
zero cost; a bound edit leaves the reduced costs alone), so re-optimization
is a dual simplex.  `unfix_var` is the exception: re-widened bounds can leave
the variable's reduced cost on the wrong side, so it re-optimizes with the
primal engine (phase 1 is a no-op while the warm basis stays feasible).

Routes of one re-solve, in order (as in the JAX package):
  1. host first (`_try_host_resolve`): the exact f64 sparse simplex of
     `engine/hostlp.py`, its dual first for the dual edits; skipped when the
     options force a kernel;
  2. K1 warm (`_try_megakernel_resolve`), then K2 warm
     (`_try_streaming_resolve`), each where the driver's routing takes it;
  3. the f64 torch engines, `engine/dual.py::resolve_dual` or
     `engine/primal.py::solve_canonical` warm, on the solve's device, with an
     exact-inverse retry after a Newton divergence.
Each route emits its solve record (`*_host`, `*_megakernel`, `*_streaming`,
or `dual_resolve` / `primal_resolve` for the engines).  Unlike the JAX
package no `except` wraps a kernel: a failed build or launch fails the
re-solve.  K2 runs on the canonical form as it stands (no 128-row
re-layout, a Mosaic workaround).  The handle's state stays host numpy.
"""

from __future__ import annotations

import math
import types
from typing import List, Tuple

import numpy as np
import torch

from .. import api
from ..canonical import canonicalize, slack_bounds
from ..status import Status, VarStat
from ..utils import records
from . import driver as _driver
from . import hostlp
from .dual import resolve_dual
from .primal import solve_canonical
from .state import state_to_numpy


def _ensure_row_capacity(handle) -> None:
    """Grow the canonical form (and carry the warm state over) when all
    padding rows are consumed — SURVEY.md §8 'grow-by-recompile'."""
    can = handle.can
    if can.m < can.M:
        return
    grown = canonicalize(
        handle.problem,
        extra_row_capacity=max(8, can.M // 2) + (can.M - handle.problem.num_constraints),
        dtype=can.A.dtype,
    )
    # `grown` reflects the original problem; replay the edits held in the
    # current canonical arrays (rows beyond the problem's own, and the bound
    # overrides of fix_var)
    M_old, nv = can.M, can.nv
    assert grown.nv == nv and grown.M > M_old
    grown.A[: can.m, :nv] = can.A[: can.m, :nv]
    grown.b[: can.m] = can.b[: can.m]
    grown.c[:nv] = can.c[:nv]
    grown.lo[:nv] = can.lo[:nv]
    grown.hi[:nv] = can.hi[:nv]
    # slack bounds of the active rows (they encode each row's op)
    for i in range(can.m):
        grown.lo[grown.slack_col(i)] = can.lo[can.slack_col(i)]
        grown.hi[grown.slack_col(i)] = can.hi[can.slack_col(i)]
    grown.m = can.m
    grown.row_ops = list(can.row_ops)

    # Carry the warm state: structural columns keep their indices; the slack
    # of row i stays at nv + i (a larger M only appends rows)
    vstat_old = np.asarray(handle._state.vstat)
    basis_old = np.asarray(handle._state.basis)
    vstat_new = grown.vstat0.copy()
    vstat_new[:nv] = vstat_old[:nv]
    vstat_new[nv : nv + M_old] = vstat_old[nv : nv + M_old]
    basis_new = grown.basis0.copy()
    basis_new[:M_old] = basis_old
    grown.vstat0 = vstat_new
    grown.basis0 = basis_new
    if handle.binv_stale:
        # a lazy placeholder stays lazy: ensure_binv rebuilds it from the
        # grown canonical form when a device route first needs it
        Binv_new = np.asarray(handle._state.Binv)
    else:
        # the new padded rows and columns are an exact identity block (their
        # fixed slacks are basic in all-zero rows)
        Binv_old = np.asarray(handle._state.Binv)
        Binv_new = np.eye(grown.M, dtype=Binv_old.dtype)
        Binv_new[:M_old, :M_old] = Binv_old
    handle.can = grown
    handle.state = handle._state._replace(
        basis=basis_new.astype(np.int32),
        vstat=vstat_new.astype(np.int8),
        Binv=Binv_new,
    )


def _exact_host_inverse(can, basis) -> np.ndarray:
    """Exact inverse of the basis matrix on the host (numpy f64 LU): the
    seed after the engine's Newton refresh reports divergence."""
    return np.linalg.inv(can.A[:, np.asarray(basis)])


def _adopt(handle, state) -> None:
    """Install a re-solved host state and certify it."""
    handle.state = state
    handle._x_cache = None
    handle._exact_obj = None
    handle.certified = None
    handle.certify()


def _try_host_resolve(handle, event: str, prefer_dual: bool = False) -> bool:
    """Warm re-solve on the host's exact f64 sparse simplex
    (`engine/hostlp.py`) — the default incremental route.

    After an edit the warm basis is a handful of pivots from optimal, so the
    re-solve is latency-bound: exact sparse pivots on the host (splu plus an
    eta file) beat a device round trip.  Exact terminal claims (INFEASIBLE
    and UNBOUNDED included) are trusted; None or a non-terminal outcome falls
    through to the kernels and the engines.  With `prefer_dual` (the
    add_constraint / fix_var / Gomory edits) the host dual simplex runs
    first, the reference's `restore_feasibility` semantics; a None or
    non-terminal outcome of it falls back to the primal two-phase loop.
    Skipped for f32 options, and when the options force a kernel.
    """
    can = handle.can
    opts = handle.opts
    if opts.dtype != "float64":
        return False
    if opts.use_megakernel == "always" or opts.use_streaming == "always":
        return False
    terminal = (int(Status.OPTIMAL), int(Status.INFEASIBLE), int(Status.UNBOUNDED))
    basis0 = np.asarray(handle._state.basis)
    vstat0 = np.asarray(handle._state.vstat)
    with records.timed() as t:
        csc = can.csc() if can.M >= _driver._SPARSE_HOST_M else None
        res = None
        if prefer_dual:
            res = hostlp.solve_host_dual(
                can.A, can.b, can.c, can.lo, can.hi, basis0, vstat0,
                opts=opts, A_csc=csc,
                # a warm repair is a handful of pivots; a run past this cap
                # is the degenerate-cycling regime, which the primal loop
                # below handles in single digits
                max_iter=max(256, can.M // 4),
            )
            if res is not None and int(res.status) not in terminal:
                res = None
        if res is None:
            res = hostlp.solve_host_sparse(
                can.A, can.b, can.c, can.lo, can.hi, basis0, vstat0,
                opts=opts, A_csc=csc,
            )
        if res is None or int(res.status) not in terminal:
            return False
        state = None
        if int(res.status) == int(Status.OPTIMAL):
            state = _driver._state_from_certified_basis(
                can, res.basis, res.vstat, res.niter, opts, lu=res.lu,
            )
            if state is None:
                return False
    shim = types.SimpleNamespace(niter=res.niter, obj=res.obj)
    _driver._emit_record(event + "_host", can, shim, int(res.status), t.wall_s, opts)
    _driver._raise_for_status(int(res.status))
    _adopt(handle, state)
    return True


def _warm_state(handle) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(basis, vstat, B⁻¹) of the handle, the inverse materialized."""
    state = handle.state
    return np.asarray(state.basis), np.asarray(state.vstat), np.asarray(state.Binv)


def _try_megakernel_resolve(handle, event: str) -> bool:
    """Warm re-solve through K1 on the solve's device.

    The f32 kernel restarts from (basis, vstat, the maintained inverse) and
    the result is certified in exact f64 before it is adopted.  Returns
    False (the caller goes on down the routes) where K1 is not eligible, or
    when its claim is uncertified and not OPTIMAL, or its polish failed:
    INFEASIBLE from an f32 iterate is no certificate, so an exact engine
    must confirm it.
    """
    can = handle.can
    if not _driver._megakernel_eligible(can, handle.opts):
        return False
    warm = _warm_state(handle)
    with records.timed() as t:
        state = _driver._try_megakernel_solve(can, handle.opts, warm_state=warm)
    if state is None:
        return False
    _driver._emit_record(event + "_megakernel", can, state,
                         int(Status.OPTIMAL), t.wall_s, handle.opts)
    _adopt(handle, state)
    return True


def _try_streaming_resolve(handle, event: str) -> bool:
    """Warm re-solve through K2 on the solve's device.

    As `_try_megakernel_resolve`, for the LPs the driver sends to K2: K2
    restarts from (basis, vstat, the maintained inverse) on `can.A` with
    `slack0=can.nv`, its claim is certified in exact f64, and an
    uncertified OPTIMAL, NUMERICAL or MAX_ITER claim is polished on the
    host from its basis.
    """
    can = handle.can
    if not _driver._streaming_eligible(can, handle.opts):
        return False
    warm = _warm_state(handle)
    with records.timed() as t:
        state = _driver._try_streaming_solve(can, handle.opts, warm_state=warm)
    if state is None:
        return False
    _driver._emit_record(event + "_streaming", can, state,
                         int(Status.OPTIMAL), t.wall_s, handle.opts)
    _adopt(handle, state)
    return True


def _run_engine_resolve(handle, event: str, run) -> None:
    """The f64 (or `opts.dtype`) torch engine warm on the solve's device:
    `run(args, basis, vstat, Binv0)` from the handle's state, again from the
    exact host inverse after a Newton divergence."""
    can, opts = handle.can, handle.opts
    dev = _driver._device(opts)
    dt = torch.float64 if opts.dtype == "float64" else torch.float32
    put = lambda v: torch.as_tensor(np.asarray(v), dtype=dt, device=dev)
    args = (put(can.A), put(can.b), put(can.c), put(can.lo), put(can.hi))
    basis, vstat, Binv = _warm_state(handle)
    with records.timed() as t:
        state = run(args, basis, vstat, put(Binv))
        if int(state.status) == int(Status.NUMERICAL):
            state = run(args, basis, vstat, put(_exact_host_inverse(can, basis)))
        state = state_to_numpy(state)
        status = int(state.status)
    _driver._emit_record(event, can, state, status, t.wall_s, opts)
    _driver._raise_for_status(status)
    _adopt(handle, state)


def _run_dual_resolve(handle) -> None:
    if _try_host_resolve(handle, "dual_resolve", prefer_dual=True):
        return
    if _try_megakernel_resolve(handle, "dual_resolve"):
        return
    if _try_streaming_resolve(handle, "dual_resolve"):
        return
    opts = handle.opts
    _run_engine_resolve(
        handle, "dual_resolve",
        lambda args, basis, vstat, Binv0: resolve_dual(*args, basis, vstat, Binv0, opts),
    )


def _run_primal_resolve(handle) -> None:
    if _try_host_resolve(handle, "primal_resolve"):
        return
    if _try_megakernel_resolve(handle, "primal_resolve"):
        return
    if _try_streaming_resolve(handle, "primal_resolve"):
        return
    opts = handle.opts
    _run_engine_resolve(
        handle, "primal_resolve",
        lambda args, basis, vstat, Binv0: solve_canonical(
            *args, vstat, basis, opts=opts, Binv0=Binv0),
    )


def _append_row(handle, coeffs_structural: np.ndarray, op, rhs: float) -> None:
    """Activate one padding row in place (no reshape)."""
    _ensure_row_capacity(handle)
    can = handle.can
    i = can.m
    sc = can.slack_col(i)
    can.A[i, : can.nv] = coeffs_structural
    can._csc_cache = None  # A mutated: invalidate the cached CSC view
    can.b[i] = rhs
    slo, shi = slack_bounds(op)
    can.lo[sc] = slo
    can.hi[sc] = shi
    can.row_ops.append(op)
    can.m = i + 1
    # The row's slack is already basic (basis[i] == sc) from the padding.
    # The basis matrix gains the new row's coefficients on the basic
    # columns, and its inverse extends analytically:
    #   [[B, 0], [vᵀ, 1]]⁻¹ = [[B⁻¹, 0], [−vᵀB⁻¹, 1]]
    # so row i of the maintained inverse becomes e_i − vᵀ·B⁻¹, with v the new
    # row's coefficients on the basic variables (its own slack excluded).
    # A lazy (stale) inverse stays lazy: ensure_binv rebuilds it from the
    # edited canonical form when a device route first needs it.
    if handle.binv_stale:
        return
    basis = np.asarray(handle._state.basis)
    v = can.A[i][basis].copy()
    v[i] = 0.0  # basis[i] is the row's own slack (its 1 is e_i)
    Binv = np.asarray(handle._state.Binv).copy()
    row = -(v @ Binv)
    row[i] += 1.0
    Binv[i, :] = row
    handle.state = handle._state._replace(Binv=Binv)


def add_constraint(handle, terms: List[Tuple[int, float]], op, rhs: float):
    """`Solution::add_constraint` (SURVEY.md §4.2): append a row, dual re-solve."""
    coeffs = np.zeros((handle.can.nv,), dtype=handle.can.A.dtype)
    for j, coeff in terms:
        if not (0 <= j < handle.can.nv):
            raise ValueError(f"constraint references unknown variable index {j}")
        coeffs[j] += coeff
    _append_row(handle, coeffs, op, float(rhs))
    _run_dual_resolve(handle)
    return api.Solution(handle, handle.problem)


def fix_var(handle, idx: int, val: float):
    """`Solution::fix_var` [API]: clamp the bounds to [val, val], dual re-solve."""
    can = handle.can
    if not (0 <= idx < can.nv):
        raise IndexError(f"variable index {idx} out of range")
    if math.isnan(val):
        raise ValueError("fix_var value must not be NaN")
    if idx not in handle.fixed_bounds:
        handle.fixed_bounds[idx] = (float(can.lo[idx]), float(can.hi[idx]))
    can.lo[idx] = val
    can.hi[idx] = val
    # A non-basic variable becomes FIXED (its value moves to `val` at the
    # next exact refactorization); a basic one keeps its row, and the dual
    # simplex pivots it out if `val` disagrees with its value.
    vstat = np.asarray(handle._state.vstat).copy()
    if vstat[idx] != int(VarStat.BASIC):
        vstat[idx] = int(VarStat.FIXED)
        handle.state = handle._state._replace(vstat=vstat)
    _run_dual_resolve(handle)
    return api.Solution(handle, handle.problem)


def unfix_var(handle, idx: int):
    """`Solution::unfix_var` [API]: restore the original bounds; returns
    (objective_changed, Solution)."""
    can = handle.can
    if idx not in handle.fixed_bounds:
        raise ValueError(f"variable {idx} was not fixed")
    obj_before = handle.user_objective()
    lo0, hi0 = handle.fixed_bounds.pop(idx)
    fixed_val = float(can.lo[idx])
    can.lo[idx] = lo0
    can.hi[idx] = hi0
    vstat = np.asarray(handle._state.vstat).copy()
    if vstat[idx] != int(VarStat.BASIC):
        # re-home the variable at a bound (non-basic variables rest at a
        # bound, or at zero if free — SURVEY.md §3.2)
        if fixed_val == lo0:
            vstat[idx] = int(VarStat.AT_LOWER)
        elif fixed_val == hi0:
            vstat[idx] = int(VarStat.AT_UPPER)
        elif math.isfinite(lo0):
            vstat[idx] = int(VarStat.AT_LOWER)
        elif math.isfinite(hi0):
            vstat[idx] = int(VarStat.AT_UPPER)
        else:
            vstat[idx] = int(VarStat.FREE)
        handle.state = handle._state._replace(vstat=vstat)
    # widened bounds can flip the variable's reduced-cost eligibility, so
    # this takes the primal engine; the warm basis makes phase 1 a no-op
    _run_primal_resolve(handle)
    sol = api.Solution(handle, handle.problem)
    changed = abs(handle.user_objective() - obj_before) > 1e-9 * (1.0 + abs(obj_before))
    return changed, sol


def add_gomory_cut(handle, idx: int):
    """`Solution::add_gomory_cut` [API]: derive a Gomory mixed-integer cut
    from the basic row of variable `idx` and append it (SURVEY.md §3.2).

    Structural variables count as integer, slack variables as continuous
    (the reference's branch-and-cut use, SURVEY.md §4.3).  The cut is written
    over the structural variables by substituting each slack's row.
    """
    can = handle.can
    state = handle._state
    if not (0 <= idx < can.nv):
        raise IndexError(f"variable index {idx} out of range")
    basis = np.asarray(state.basis)
    pos = np.nonzero(basis == idx)[0]
    if pos.size == 0:
        raise ValueError("add_gomory_cut requires a basic variable")
    pos = int(pos[0])
    beta = float(np.asarray(state.xB)[pos])
    f0 = beta - math.floor(beta)
    if f0 < 1e-6 or f0 > 1.0 - 1e-6:
        raise ValueError("add_gomory_cut requires a fractional basic variable")

    # tableau row of the basic variable: α = (B⁻¹)_pos · A (a BTRAN row read)
    if handle.binv_stale:
        # a lazy inverse: one sparse BTRAN (B⁻ᵀ e_pos), not the dense B⁻¹
        lu = hostlp.factorize_basis(can.A.astype(np.float64), basis, A_csc=can.csc())
        if lu is None:
            handle.ensure_binv()  # the identity fallback
            Binv_row = np.asarray(handle._state.Binv[pos])
        else:
            e = np.zeros(can.M)
            e[pos] = 1.0
            Binv_row = lu.lu.solve(e, trans="T")
    else:
        Binv_row = np.asarray(state.Binv[pos])
    alpha = Binv_row @ can.A
    vstat = np.asarray(state.vstat)

    # Gomory mixed-integer cut over the shifted non-basic variables
    # x'_j = x_j − lo_j (at lower) or hi_j − x_j (at upper):  Σ γ_j x'_j ≥ 1
    n_active = can.nv + can.M
    vs = vstat[:n_active]
    at_upper = vs == int(VarStat.AT_UPPER)
    inactive = (vs == int(VarStat.BASIC)) | (vs == int(VarStat.FIXED))
    a = np.where(at_upper, -alpha[:n_active], alpha[:n_active]).astype(np.float64)
    support = ~inactive & (np.abs(a) >= 1e-12)
    if bool(np.any(support & (vs == int(VarStat.FREE)))):
        # the derivation needs non-negative shifted variables
        raise ValueError("add_gomory_cut: row involves a free non-basic variable")
    is_int = np.arange(n_active) < can.nv
    fj = a - np.floor(a)
    with np.errstate(divide="ignore", invalid="ignore"):
        g_int = np.minimum(fj / f0, (1.0 - fj) / (1.0 - f0))
        g_cont = np.where(a > 0, a / f0, -a / (1.0 - f0))
    gamma = np.where(support, np.where(is_int, g_int, g_cont), 0.0)

    # un-shift into the original variables: Σ c_j x_j ≥ rhs (the infinite
    # bounds masked, so that the discarded branch makes no 0·inf NaN)
    coeffs = np.where(at_upper, -gamma, gamma)
    lo_fin = np.where(np.isfinite(can.lo[:n_active]), can.lo[:n_active], 0.0)
    hi_fin = np.where(np.isfinite(can.hi[:n_active]), can.hi[:n_active], 0.0)
    rhs = 1.0 + float(np.sum(np.where(at_upper, -gamma * hi_fin, gamma * lo_fin)))

    # substitute the slacks: s_i = b_i − Σ_k A[i, k] x_k
    gs = coeffs[can.nv : can.nv + can.m]
    cut = coeffs[: can.nv] - gs @ can.A[: can.m, : can.nv]
    cut_rhs = rhs - float(gs @ can.b[: can.m])

    _append_row(handle, cut, api.ComparisonOp.Ge, cut_rhs)
    _run_dual_resolve(handle)
    return api.Solution(handle, handle.problem)
