"""Two-phase bounded-variable primal revised simplex in torch.

PyTorch port of `minilp_tpu.engine.primal` (reference analog: `Solver::optimize`
/ `find_initial_bfs` and the pivot machinery, `src/solver.rs` [CODE]; SURVEY.md
§4.1).  The JAX package runs it as one jitted `lax.while_loop`; here it is a
Python loop over tensor ops on one device, and each `lax.cond` is an `if` on
a value read back from that device.  The semantics are the JAX package's:

* **One loop, phase in the carry.**  Phase 1 (minimize total bound
  infeasibility with composite costs σ) and phase 2 (optimize c·x with
  maintained reduced costs + Devex weights) share one body; the transition
  is a flag flip plus an exact refactorization.
* **One ratio test**, the phase-1 bounded rule, which reduces to the
  textbook phase-2 rule when all basics are feasible.
* Terminal conditions are status codes; lowest-index tie-breaks everywhere,
  so the port takes the JAX package's pivot sequence in f64.

Each iteration reads a few scalars back to the host, so on a CUDA device the
loop pays one synchronisation per branch; the port runs it there only as the
ladder's last resort, and on the CPU as the exact polish.
"""

from __future__ import annotations

import torch

from ..ops.pricing import entering_scores, phase1_reduced_costs, phase1_sigma
from ..ops.ratio import ratio_test
from ..options import SolverOptions
from ..status import Status, VarStat
from .basis import ftran, pfi_update
from .columns import Columns
from .state import SimplexState


def _entering_value(vstat_q: int, lo_q, hi_q):
    """Current value of the (non-basic) entering variable."""
    if vstat_q in (VarStat.AT_LOWER, VarStat.FIXED):
        return lo_q
    if vstat_q == VarStat.AT_UPPER:
        return hi_q
    return torch.zeros_like(lo_q)


def run_simplex(cols: Columns, opts: SolverOptions, state: SimplexState,
                max_iter: int) -> SimplexState:
    """Drive the unified loop until a terminal status (or MAX_ITER).

    `cols` holds the LP's columns (`engine/columns.py`): all of them here,
    one rank's block in `parallel/sharded_engine.py`; the row-sized state
    (basis, B⁻¹, x_B) is whole either way."""
    use_devex = opts.pricing == "devex"
    period = opts.effective_refactor_period()
    basis, vstat, xB, d, Binv, obj = state[:6]
    niter, status, noimprove = int(state.niter), int(state.status), int(state.noimprove)
    best, weights, phase = state.best, state.weights, int(state.phase)
    inf = torch.full_like(best, torch.inf)
    loB, hiB = cols.basic_bounds(basis)

    def refresh(basis, vstat, Binv, status):
        Binv2, xB2, d2, loB2, hiB2, obj2, ok = cols.refactorize(
            basis, vstat, Binv, opts.newton_refine_iters)
        # Newton seed outside its basin → the driver rebuilds and resumes
        return Binv2, xB2, d2, loB2, hiB2, obj2, (status if ok else int(Status.NUMERICAL))

    while cols.running(status, niter, max_iter):
        sigma0, _ = phase1_sigma(xB, loB, hiB, opts.feas_tol)
        feasible = not bool((sigma0 != 0).any())

        # -- phase transition: feasibility reached → exact refresh, phase = 2
        if phase == 1 and feasible:
            Binv, xB, d, loB, hiB, obj, status = refresh(basis, vstat, Binv, status)
            phase, noimprove, best = 2, 0, inf

        p1 = phase == 1
        bland = noimprove >= opts.bland_after
        sigma, infeas = phase1_sigma(xB, loB, hiB, opts.feas_tol)
        dcur = phase1_reduced_costs(cols.A, Binv, sigma, vstat) if p1 else d
        metric = infeas if p1 else obj
        # -- pricing: Dantzig, or Devex in phase 2
        score, elig = entering_scores(dcur, vstat, opts.opt_tol,
                                      weights if use_devex and not p1 else None)
        found, q = cols.choose(score, elig, bland)

        if not found:
            # phase 1 ⇒ minimal positive infeasibility ⇒ INFEASIBLE; phase 2
            # ⇒ OPTIMAL
            status = int(Status.INFEASIBLE if p1 else Status.OPTIMAL)
        else:
            Acol, (dq, lo_q, hi_q, vq, w_q) = cols.gather_column(
                q, dcur, cols.lo, cols.hi, vstat, weights)
            s = 1.0 if float(dq) < 0 else -1.0
            w = ftran(Binv, Acol)  # FTRAN: entering column in basis coords
            rt = ratio_test(
                w, s, xB, loB, hiB, hi_q - lo_q, basis, bland,
                phase1=True,  # the unified rule; reduces to phase-2 when feasible
                pivot_tol=opts.pivot_tol,
                feas_tol=opts.feas_tol,
                tie_rel=opts.ratio_tie_rel,
                tie_abs=opts.ratio_tie_abs,
            )
            vq = int(vq)
            if rt.unbounded:
                # an unblocked ray is UNBOUNDED in phase 2; in phase 1 it
                # cannot happen in exact arithmetic ⇒ NUMERICAL
                status = int(Status.NUMERICAL if p1 else Status.UNBOUNDED)
            elif rt.flip:
                # bound flip: entering variable traverses to its opposite
                # bound, basis unchanged
                xB = xB + rt.t * (-s * w)
                vstat = vstat.clone()
                cols.set(vstat, q, int(VarStat.AT_UPPER if vq == VarStat.AT_LOWER
                                       else VarStat.AT_LOWER))
                if not p1:
                    obj = obj + dq * s * rt.t
            else:
                r, t = rt.r, rt.t
                lv = int(basis[r])
                enter_val = _entering_value(vq, lo_q, hi_q) + s * t
                xB = xB + t * (-s * w)
                xB[r] = enter_val
                if bool(loB[r] == hiB[r]):
                    lstat = VarStat.FIXED
                elif bool(rt.tgt_r == hiB[r]):
                    lstat = VarStat.AT_UPPER
                else:
                    lstat = VarStat.AT_LOWER
                vstat = vstat.clone()
                cols.set(vstat, lv, int(lstat))
                cols.set(vstat, q, int(VarStat.BASIC))
                basis = basis.clone()
                basis[r] = q
                loB, hiB = loB.clone(), hiB.clone()
                loB[r], hiB[r] = lo_q, hi_q
                Binv_old = Binv
                Binv = pfi_update(Binv, w, r)
                if not p1:
                    # pivot row α = (old B⁻¹)_r · A — feeds both the
                    # reduced-cost update and the Devex weights
                    alpha = Binv_old[r] @ cols.A
                    rd = dq / w[r]
                    d = dcur - rd * alpha
                    cols.set(d, q, 0.0)
                    cols.set(d, lv, -rd)
                    d = torch.where(vstat == VarStat.BASIC, 0.0, d)
                    obj = obj + dq * s * t
                    if use_devex:
                        gq = torch.clamp(w_q, min=1.0)
                        tcol = alpha / w[r]
                        w_new = torch.maximum(weights, (tcol * tcol) * gq)
                        cols.set(w_new, lv, torch.clamp(gq / (w[r] * w[r]), min=1.0))
                        cols.set(w_new, q, 1.0)
                        weights = (torch.ones_like(w_new)
                                   if bool(gq > opts.devex_reset) else w_new)

        # -- progress accounting (anti-cycling trigger)
        eps = 1e-10 * (1.0 + torch.where(torch.isfinite(best), best.abs(), 0.0))
        noimprove = 0 if bool(metric < best - eps) else noimprove + 1
        best = torch.minimum(best, metric)
        if found:
            niter += 1
            # periodic refactorization (drift cleanup)
            if niter % period == 0 and status == Status.RUNNING:
                Binv, xB, d, loB, hiB, obj, status = refresh(basis, vstat, Binv, status)

    if status == Status.RUNNING:
        status = int(Status.MAX_ITER)
    i32 = lambda v: torch.tensor(v, dtype=torch.int32, device=cols.device)
    return SimplexState(
        basis=basis, vstat=vstat, xB=xB, d=d, Binv=Binv, obj=obj,
        niter=i32(niter), status=i32(status), noimprove=i32(noimprove),
        best=best, weights=weights, phase=i32(phase),
    )


def start_state(cols: Columns, basis, vstat, Binv0, opts: SolverOptions,
                phase: int) -> SimplexState:
    """The loops' first state: refresh from (basis, vstat) and the inverse
    seed `Binv0`; NUMERICAL when the seed is outside Newton's basin."""
    basis, vstat = cols.place(basis, vstat)
    Binv, xB, d, _loB, _hiB, obj, ok = cols.refactorize(
        basis, vstat, Binv0, opts.newton_refine_iters)
    i32 = lambda v: torch.tensor(int(v), dtype=torch.int32, device=cols.device)
    return SimplexState(
        basis=basis,
        vstat=vstat,
        xB=xB,
        d=d,
        Binv=Binv,
        obj=obj,
        niter=i32(0),
        status=i32(Status.RUNNING if ok else Status.NUMERICAL),
        noimprove=i32(0),
        best=torch.tensor(torch.inf, dtype=cols.dtype, device=cols.device),
        weights=torch.ones_like(d),
        phase=i32(phase),
    )


def solve_canonical(A, b, c, lo, hi, vstat0, basis0, opts: SolverOptions,
                    Binv0=None) -> SimplexState:
    """Cold solve of a canonical LP (`Problem::solve`, SURVEY.md §4.1) on the
    device of `A`.  Also the warm primal re-solver: pass a previous solve's
    (vstat, basis) plus its maintained inverse as `Binv0` (cold solves start
    from the slack basis, whose inverse is exactly the identity)."""
    M, N = A.shape
    cols = Columns(A, b, c, lo, hi)
    if Binv0 is None:
        Binv0 = torch.eye(M, dtype=A.dtype, device=A.device)
    state = start_state(cols, basis0, vstat0, Binv0, opts, phase=1)
    return run_simplex(cols, opts, state, opts.effective_max_iter(M, N))
