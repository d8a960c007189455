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
from .basis import ftran, pfi_update, refactorize
from .primal import _entering_value
from .state import SimplexState


def make_dual_step(A, b, c, lo, hi, opts: SolverOptions):
    """One dual simplex iteration; returns SimplexState -> SimplexState."""
    period = opts.effective_refactor_period()

    def step(state: SimplexState) -> SimplexState:
        basis, vstat, xB, d, Binv, obj = state[:6]
        niter, status = int(state.niter), int(state.status)
        noimprove, best = int(state.noimprove), state.best
        loB, hiB = lo[basis], hi[basis]
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
            alpha = Binv[r] @ A
            at = e * alpha
            elig = (
                ((vstat == VarStat.AT_LOWER) & (at < -opts.pivot_tol))
                | ((vstat == VarStat.AT_UPPER) & (at > opts.pivot_tol))
                | ((vstat == VarStat.FREE) & (at.abs() > opts.pivot_tol))
            )
            if not bool(elig.any()):
                status = int(Status.INFEASIBLE)  # dual unbounded
            else:
                inf = torch.full_like(d, torch.inf)
                abs_alpha = alpha.abs()
                theta = torch.where(elig, d.abs() / abs_alpha, inf)
                theta_min = theta.min()
                # Harris two-pass: the relaxed step, then the largest |α|
                # among the candidates under it, widened by the tie window
                t_relaxed = torch.where(elig, (d.abs() + opts.opt_tol) / abs_alpha, inf).min()
                tie = elig & ((theta <= t_relaxed) | (
                    theta <= theta_min * (1.0 + opts.ratio_tie_rel) + opts.ratio_tie_abs))
                if bland:
                    n = d.shape[0]
                    idx = torch.arange(n, device=d.device)
                    q = int(torch.argmin(torch.where(tie, idx, n)))
                else:
                    q = int(torch.argmax(torch.where(tie, abs_alpha, -inf)))

                dq_step = (xB[r] - target) / alpha[q]
                w = ftran(Binv, A[:, q])
                rng_q = hi[q] - lo[q]
                vq = int(vstat[q])
                if bool(rng_q <= dq_step.abs()):
                    # bound flip: the entering variable crosses its own range;
                    # AT_LOWER always steps up and AT_UPPER down (eligibility
                    # signs), FREE variables never flip
                    step_f = torch.sign(dq_step) * rng_q
                    xB = xB - step_f * w
                    vstat = vstat.clone()
                    vstat[q] = int(VarStat.AT_UPPER if vq == VarStat.AT_LOWER
                                   else VarStat.AT_LOWER)
                    obj = obj + d[q] * step_f
                else:
                    # basis exchange
                    enter_val = _entering_value(vq, lo[q], hi[q]) + dq_step
                    xB = xB - dq_step * w
                    xB[r] = enter_val
                    lv = int(basis[r])
                    if bool(loB[r] == hiB[r]):
                        lstat = VarStat.FIXED
                    else:
                        lstat = VarStat.AT_LOWER if up else VarStat.AT_UPPER
                    vstat = vstat.clone()
                    vstat[lv] = int(lstat)
                    vstat[q] = int(VarStat.BASIC)
                    basis = basis.clone()
                    basis[r] = q
                    Binv = pfi_update(Binv, w, r)
                    delta_dual = d[q] / alpha[q]
                    obj = obj + d[q] * dq_step
                    d = d - delta_dual * alpha
                    d[q] = 0.0
                    d[lv] = -delta_dual
                    d = torch.where(vstat == VarStat.BASIC, 0.0, d)

        # -- progress and periodic refactorization
        eps = 1e-10 * (1.0 + torch.where(torch.isfinite(best), best.abs(), 0.0))
        noimprove = 0 if bool(max_viol < best - eps) else noimprove + 1
        best = torch.minimum(best, max_viol)
        if took_step:
            niter += 1
            if niter % period == 0 and status == Status.RUNNING:
                Binv, xB, d, obj, ok = refactorize(
                    A, b, c, lo, hi, basis, vstat, Binv,
                    newton_iters=opts.newton_refine_iters,
                )
                if not ok:
                    status = int(Status.NUMERICAL)
        i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=A.device)
        return state._replace(
            basis=basis, vstat=vstat, xB=xB, d=d, Binv=Binv, obj=obj,
            niter=i32(niter), status=i32(status), noimprove=i32(noimprove), best=best,
        )

    return step


def run_dual(A, b, c, lo, hi, opts: SolverOptions, state: SimplexState,
             max_iter: int) -> SimplexState:
    """Dual simplex until primal feasible (OPTIMAL), INFEASIBLE, or MAX_ITER."""
    step = make_dual_step(A, b, c, lo, hi, opts)
    while int(state.status) == Status.RUNNING and int(state.niter) < max_iter:
        state = step(state)
    if int(state.status) == Status.RUNNING:
        state = state._replace(status=torch.tensor(
            int(Status.MAX_ITER), dtype=torch.int32, device=A.device))
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
    dtype, dev = A.dtype, A.device
    basis = torch.as_tensor(basis, device=dev).to(torch.int64)
    vstat = torch.as_tensor(vstat, device=dev).to(torch.int8)
    Binv0 = torch.as_tensor(Binv0, dtype=dtype, device=dev)
    Binv, xB, d, obj, ok = refactorize(
        A, b, c, lo, hi, basis, vstat, Binv0,
        newton_iters=opts.newton_refine_iters,
    )
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32, device=dev)
    state = SimplexState(
        basis=basis,
        vstat=vstat,
        xB=xB,
        d=d,
        Binv=Binv,
        obj=obj,
        niter=i32(0),
        status=i32(Status.RUNNING if ok else Status.NUMERICAL),
        noimprove=i32(0),
        best=torch.tensor(torch.inf, dtype=dtype, device=dev),
        weights=torch.ones_like(d),
        phase=i32(2),
    )
    return run_dual(A, b, c, lo, hi, opts, state, opts.effective_max_iter(M, N))
