"""Dual simplex: warm-restart reoptimization after problem edits (PyTorch port).

Port of `minilp_tpu.engine.dual` (reference analog: `Solver::restore_feasibility`,
`src/solver.rs` [CODE]; SURVEY.md §4.2): after `Solution::add_constraint` /
`fix_var` / `add_gomory_cut` the basis is dual feasible but primal infeasible;
the dual simplex pivots the violated basic variables out until primal
feasibility is restored, and the state is optimal again.  The JAX package
runs it as one jitted `lax.while_loop`; here, as in `engine/primal.py`, it is
a Python loop over tensor ops on one device, and each `lax.cond` or
`jnp.where(flip, …)` is an `if` on a value read back from that device.

Per iteration (the JAX package's rules, so the port takes its pivot sequence):
  1. leaving row r: exact dual steepest edge, viol² / max(‖B⁻¹[r]‖², 1e-12);
  2. pivot row α = B⁻¹[r]·A (BTRAN is a row read of the explicit inverse);
  3. dual ratio test over the non-basic columns whose movement shrinks the
     violation, two-pass Harris with the legacy tie window (pass 1 relaxes
     every |d_j| by `opt_tol`, pass 2 takes the largest |α_j| under the
     relaxed step); Bland's lowest index after `bland_after` iterations
     without progress;
  4. bound flip: when the entering variable's step would pass its own
     opposite bound it flips there, and the basis, inverse and reduced costs
     stay put;
  5. otherwise FTRAN of the entering column, the product-form inverse
     update, and the incremental d/x updates.

No eligible entering column means the dual is unbounded, so the primal is
INFEASIBLE (how the reference reports an infeasible cut or fix [CODE]).
"""

from __future__ import annotations

import torch

from ..options import SolverOptions
from ..status import Status, VarStat
from .basis import ftran, pfi_update
from .columns import Columns
from .primal import _entering_value, start_state
from .state import SimplexState


def _dual_loop(cols: Columns, opts: SolverOptions, state: SimplexState,
               max_iter: int) -> SimplexState:
    """Dual simplex iterations from `state` while RUNNING and below
    `max_iter`; `cols` holds the LP's columns (`engine/columns.py`)."""
    period = opts.effective_refactor_period()
    basis, vstat, xB, d, Binv, obj = state[:6]
    niter, status = int(state.niter), int(state.status)
    noimprove, best = int(state.noimprove), state.best
    inf = torch.full_like(best, torch.inf)
    loB, hiB = cols.basic_bounds(basis)

    while cols.running(status, niter, max_iter):
        bland = noimprove >= opts.bland_after
        # -- leaving row: exact dual steepest edge (the true reference weights
        # are the squared row norms of the explicit inverse)
        viol_lo = torch.clamp(loB - xB, min=0.0)
        viol_hi = torch.clamp(xB - hiB, min=0.0)
        viol = viol_lo + viol_hi
        row_norm2 = torch.clamp((Binv * Binv).sum(dim=1), min=1e-12)
        r = int(torch.argmax((viol * viol) / row_norm2))
        max_viol = viol.max()
        took_step = bool(max_viol > opts.feas_tol)

        if not took_step:
            status = int(Status.OPTIMAL)
        else:
            # e = +1: x_{B_r} must rise to its lower bound; e = -1: fall
            up = bool(viol_lo[r] > 0)
            e = 1.0 if up else -1.0
            target = loB[r] if up else hiB[r]
            alpha = Binv[r] @ cols.A
            at = e * alpha
            elig = (
                ((vstat == VarStat.AT_LOWER) & (at < -opts.pivot_tol))
                | ((vstat == VarStat.AT_UPPER) & (at > opts.pivot_tol))
                | ((vstat == VarStat.FREE) & (at.abs() > opts.pivot_tol))
            )
            abs_alpha = alpha.abs()
            theta = torch.where(elig, d.abs() / abs_alpha, inf)
            relaxed = torch.where(elig, (d.abs() + opts.opt_tol) / abs_alpha, inf)
            theta_min, t_relaxed, none_elig = cols.min(torch.stack([
                theta.min(), relaxed.min(), (~elig.any()).to(theta.dtype)]))
            if bool(none_elig):
                status = int(Status.INFEASIBLE)  # dual unbounded
            else:
                # Harris two-pass: the relaxed step, then the largest |α|
                # among the candidates under it, widened by the tie window
                tie = elig & ((theta <= t_relaxed) | (
                    theta <= theta_min * (1.0 + opts.ratio_tie_rel) + opts.ratio_tie_abs))
                _, q = cols.choose(torch.where(tie, abs_alpha, -torch.inf), tie, bland)
                Acol, (dq, alpha_q, lo_q, hi_q, vq) = cols.gather_column(
                    q, d, alpha, cols.lo, cols.hi, vstat)
                dq_step = (xB[r] - target) / alpha_q
                w = ftran(Binv, Acol)
                rng_q = hi_q - lo_q
                vq = int(vq)
                if bool(rng_q <= dq_step.abs()):
                    # bound flip: the entering variable crosses its own range;
                    # AT_LOWER always steps up and AT_UPPER down (eligibility
                    # signs), FREE variables never flip
                    step_f = torch.sign(dq_step) * rng_q
                    xB = xB - step_f * w
                    vstat = vstat.clone()
                    cols.set(vstat, q, int(VarStat.AT_UPPER if vq == VarStat.AT_LOWER
                                           else VarStat.AT_LOWER))
                    obj = obj + dq * step_f
                else:
                    # basis exchange
                    enter_val = _entering_value(vq, lo_q, hi_q) + dq_step
                    xB = xB - dq_step * w
                    xB[r] = enter_val
                    lv = int(basis[r])
                    if bool(loB[r] == hiB[r]):
                        lstat = VarStat.FIXED
                    else:
                        lstat = VarStat.AT_LOWER if up else VarStat.AT_UPPER
                    vstat = vstat.clone()
                    cols.set(vstat, lv, int(lstat))
                    cols.set(vstat, q, int(VarStat.BASIC))
                    basis = basis.clone()
                    basis[r] = q
                    loB, hiB = loB.clone(), hiB.clone()
                    loB[r], hiB[r] = lo_q, hi_q
                    Binv = pfi_update(Binv, w, r)
                    delta_dual = dq / alpha_q
                    obj = obj + dq * dq_step
                    d = d - delta_dual * alpha
                    cols.set(d, q, 0.0)
                    cols.set(d, lv, -delta_dual)
                    d = torch.where(vstat == VarStat.BASIC, 0.0, d)

        # -- progress and periodic refactorization
        eps = 1e-10 * (1.0 + torch.where(torch.isfinite(best), best.abs(), 0.0))
        noimprove = 0 if bool(max_viol < best - eps) else noimprove + 1
        best = torch.minimum(best, max_viol)
        if took_step:
            niter += 1
            if niter % period == 0 and status == Status.RUNNING:
                Binv, xB, d, loB, hiB, obj, ok = cols.refactorize(
                    basis, vstat, Binv, opts.newton_refine_iters)
                if not ok:
                    status = int(Status.NUMERICAL)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=cols.device)
    return state._replace(
        basis=basis, vstat=vstat, xB=xB, d=d, Binv=Binv, obj=obj,
        niter=i32(niter), status=i32(status), noimprove=i32(noimprove), best=best,
    )


def make_dual_step(A, b, c, lo, hi, opts: SolverOptions):
    """One dual simplex iteration; returns SimplexState -> SimplexState."""
    cols = Columns(A, b, c, lo, hi)
    return lambda state: _dual_loop(cols, opts, state, int(state.niter) + 1)


def run_dual(cols: Columns, opts: SolverOptions, state: SimplexState,
             max_iter: int) -> SimplexState:
    """Dual simplex until primal feasible (OPTIMAL), INFEASIBLE, or MAX_ITER."""
    state = _dual_loop(cols, opts, state, max_iter)
    if int(state.status) == Status.RUNNING:
        state = state._replace(status=torch.tensor(
            int(Status.MAX_ITER), dtype=torch.int32, device=cols.device))
    return state


def resolve_dual(A, b, c, lo, hi, basis, vstat, Binv0,
                 opts: SolverOptions) -> SimplexState:
    """Warm restart on the device of `A`: refresh from (basis, vstat, the
    maintained inverse), then the dual simplex.

    The entry point for `add_constraint` / `fix_var` / `add_gomory_cut`
    (SURVEY.md §4.2): those edits keep the basis dual feasible (a new row's
    slack enters basic at zero cost; bound changes leave the reduced costs
    alone), so the dual simplex restores optimality in a few pivots.
    `Binv0` is the inverse carried in the warm state (`engine/incremental.py`
    extends it analytically when a row is added).
    """
    M, N = A.shape
    cols = Columns(A, b, c, lo, hi)
    Binv0 = torch.as_tensor(Binv0, dtype=A.dtype, device=A.device)
    state = start_state(cols, basis, vstat, Binv0, opts, phase=2)
    return run_dual(cols, opts, state, opts.effective_max_iter(M, N))
