"""Host-side sparse revised simplex: the exact-f64 certify/polish engine.

The reference's entire solver IS a host sparse simplex — `src/solver.rs`
pivot machinery over `src/lu.rs`'s Gilbert–Peierls LU with eta updates
[CODE; SURVEY.md §2 C2–C4].  In this framework the TPU kernels do the bulk
iteration in f32, and THIS module supplies the reference-grade exact linear
algebra at the seams:

* **polish**: finish a near-optimal f32 basis (streaming kernel / megakernel
  handoff) with exact f64 pivots — the round-2 dense host polish (XLA CPU
  engine, O(m·n) dense passes per pivot) took ~1 h at maros-r7 scale; sparse
  FTRAN/BTRAN at ~0.5 % density makes each pivot ~a millisecond;
* **certify**: one sparse LU instead of dense `np.linalg.solve` (O(m³));
* **warm incremental re-solves**: a handful of exact pivots after an edit is
  latency-bound work that belongs on the host, not across the TPU link.

`scipy.sparse.linalg.splu` (SuperLU, COLAMD ordering) plays the role of the
reference's LU factorization; the product-form eta file plays its eta
updates.  Semantics mirror `engine/primal.py` one-for-one: the same unified
two-phase loop, phase-1-extended Harris two-pass ratio test, Devex pricing,
lowest-index deterministic tie-breaks, and refresh-before-terminal-claim —
so a basis handed over from the device engines continues consistently.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla

from ..options import SolverOptions
from ..status import Status, VarStat

_BASIC = int(VarStat.BASIC)
_AT_LOWER = int(VarStat.AT_LOWER)
_AT_UPPER = int(VarStat.AT_UPPER)
_FREE = int(VarStat.FREE)
_FIXED = int(VarStat.FIXED)


class HostResult(NamedTuple):
    status: int
    basis: np.ndarray   # (M,) int32
    vstat: np.ndarray   # (N,) int8
    niter: int
    obj: float          # exact canonical objective at the final state
    bland_iters: int = 0  # pivots taken under the Bland anti-cycling rule
    #: the final BasisLU (eta-free: terminal claims always follow a fresh
    #: refactorization) — downstream seams (state rebuild) reuse it instead
    #: of paying another SuperLU factorization (~1 s at maros shape)
    lu: Optional["BasisLU"] = None


class BasisLU:
    """Sparse LU of the basis + product-form eta file.

    FTRAN solves B x = rhs, BTRAN solves Bᵀ x = rhs, where
    B = (eta_k ∘ … ∘ eta_1)(B₀) and B₀ carries the SuperLU factors.
    After a pivot replacing row r's basic column with FTRAN'd column w,
    B_new⁻¹ = E·B_old⁻¹ with E = I except column r (the eta transform).
    """

    def __init__(self, A_csc: sp.csc_matrix, basis: np.ndarray):
        B = A_csc[:, basis]
        # SuperLU raises on exact singularity; callers treat that as
        # "hand the basis back" (driver falls back to the dense engines).
        self.lu = spla.splu(B.tocsc())
        self.etas: list[tuple[int, np.ndarray, float]] = []

    def ftran(self, rhs: np.ndarray) -> np.ndarray:
        x = self.lu.solve(rhs)
        for r, w, wr in self.etas:
            xr = x[r] / wr
            x -= xr * w
            x[r] = xr
        return x

    def btran(self, rhs: np.ndarray) -> np.ndarray:
        x = np.array(rhs, dtype=np.float64, copy=True)
        for r, w, wr in reversed(self.etas):
            # (Eᵀx)_r = η·x with η = E[:, r]: η_r = 1/wr, η_i = −w_i/wr
            x[r] = (x[r] - w @ x) / wr
        return self.lu.solve(x, trans="T")

    def update(self, w: np.ndarray, r: int) -> None:
        """Record the pivot eta: w = B_old⁻¹ a_q, leaving row r."""
        wv = np.array(w, dtype=np.float64, copy=True)
        wr = float(wv[r])
        wv[r] = 0.0  # the r-term is handled exactly by the xr assignment
        self.etas.append((int(r), wv, wr))

    @property
    def n_etas(self) -> int:
        return len(self.etas)


def factorize_basis(A: np.ndarray, basis: np.ndarray,
                    A_csc: Optional[sp.csc_matrix] = None) -> Optional[BasisLU]:
    """One sparse LU of A[:, basis] for certify-style solves; None if
    singular.  Pass `A_csc` to skip the dense→CSC conversion (the canonical
    form caches one — CanonicalLP.csc())."""
    try:
        if A_csc is None:
            A_csc = sp.csc_matrix(np.asarray(A, dtype=np.float64))
        return BasisLU(A_csc, np.asarray(basis))
    except (RuntimeError, ValueError):
        return None


def _nonbasic_x(vstat: np.ndarray, lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    x = np.where(vstat == _AT_LOWER, lo, 0.0)
    x = np.where(vstat == _AT_UPPER, hi, x)
    x = np.where(vstat == _FIXED, lo, x)
    return np.where(vstat == _BASIC, 0.0, x)


def solve_host_sparse(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    basis0: np.ndarray,
    vstat0: np.ndarray,
    *,
    opts: SolverOptions,
    max_iter: Optional[int] = None,
    progress_every: int = 0,
    A_csc: Optional[sp.csc_matrix] = None,
) -> Optional[HostResult]:
    """Exact-f64 sparse revised simplex from (basis0, vstat0).

    Same canonical form and loop semantics as `engine/primal.py` (unified
    two-phase, composite phase-1 costs, bound flips, Devex, Harris, Bland
    fallback); scalar host loop over sparse FTRAN/BTRAN instead of a jitted
    dense graph.  Returns None when the starting basis is singular (the
    caller falls back to the dense engines).
    """
    M, N = A.shape
    if max_iter is None:
        max_iter = opts.effective_max_iter(M, N)
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    if A_csc is None:
        A_csc = sp.csc_matrix(A)
    AT_csr = A_csc.T.tocsr()

    basis = np.array(basis0, dtype=np.int64, copy=True)
    vstat = np.array(vstat0, dtype=np.int64, copy=True)
    feas_tol = float(opts.feas_tol)
    opt_tol = float(opts.opt_tol)
    pivot_tol = float(opts.pivot_tol)
    tie_rel = float(opts.ratio_tie_rel)
    tie_abs = float(opts.ratio_tie_abs)
    use_devex = opts.pricing == "devex"
    # explicit settings respected verbatim; None → size-scaled auto (ADVICE
    # r3/r4 — the Optional default makes an explicit 64 distinguishable)
    refactor_period = opts.effective_refactor_period(M)
    idx_n = np.arange(N, dtype=np.int64)

    try:
        lu = BasisLU(A_csc, basis)
    except (RuntimeError, ValueError):
        return None

    weights = np.ones(N)
    d = np.zeros(N)
    xB = np.zeros(M)
    obj = 0.0

    def col(q: int) -> np.ndarray:
        s0, s1 = A_csc.indptr[q], A_csc.indptr[q + 1]
        out = np.zeros(M)
        out[A_csc.indices[s0:s1]] = A_csc.data[s0:s1]
        return out

    def refresh() -> bool:
        """Exact refactorization + recompute of xB, d, obj.  False ⇒ singular."""
        nonlocal lu, xB, d, obj
        try:
            lu = BasisLU(A_csc, basis)
        except (RuntimeError, ValueError):
            return False
        xN = _nonbasic_x(vstat, lo, hi)
        xB = lu.ftran(b - A_csc @ xN)
        y = lu.btran(c[basis])
        d = c - AT_csr @ y
        d[vstat == _BASIC] = 0.0
        obj = float(c[basis] @ xB + c @ xN)
        return True

    if not refresh():
        return None

    status = int(Status.RUNNING)
    niter = 0
    bland_iters = 0
    phase = 1
    noimprove = 0
    best = np.inf
    fresh = True  # exact state just recomputed; terminal claims require this
    since_refresh = 0  # pivots AND flips since the last exact recompute

    while status == int(Status.RUNNING) and niter < max_iter:
        loB = lo[basis]
        hiB = hi[basis]
        below = xB < loB - feas_tol
        above = xB > hiB + feas_tol
        feasible = not (below.any() or above.any())

        # ---- phase transitions (confirmed on the exact state only) ----------
        # The maintained xB drifts between refactorizations (eta-file error +
        # Harris's <=feas_tol per-pivot overshoot).  Mirroring the streaming
        # kernel's confirm/regress guards: a 1->2 transition is only taken
        # when the *refreshed exact* xB is feasible, and a phase-2 state whose
        # exact xB violates bounds beyond feas_tol regresses to phase 1 —
        # otherwise phase-2 pricing on infeasible basics can manufacture a
        # believed-false UNBOUNDED (ADVICE r3, medium).
        if phase == 1 and feasible:
            if not fresh:
                if not refresh():
                    status = int(Status.NUMERICAL)
                    break
                fresh = True
                since_refresh = 0
                continue  # re-check feasibility on the exact state
            phase = 2
            noimprove = 0
            best = np.inf
            continue
        if phase == 2 and not feasible:
            if not fresh:
                if not refresh():
                    status = int(Status.NUMERICAL)
                    break
                fresh = True
                since_refresh = 0
                continue  # drift may vanish on the exact state
            phase = 1
            noimprove = 0
            best = np.inf
            # fall through: price phase-1 costs this iteration

        # lo=-inf / hi=+inf give -inf in the difference; max(·, 0) absorbs them
        infeas = (np.maximum(loB - xB, 0.0).sum()
                  + np.maximum(xB - hiB, 0.0).sum())
        p1 = phase == 1
        bland = noimprove >= opts.bland_after
        metric = infeas if p1 else obj

        # ---- pricing (ops/pricing.py semantics) -----------------------------
        if p1:
            sigma = np.where(below, -1.0, np.where(above, 1.0, 0.0))
            y1 = lu.btran(sigma)
            dcur = -(AT_csr @ y1)
            dcur[vstat == _BASIC] = 0.0
        else:
            dcur = d
        can_up = (vstat == _AT_LOWER) | (vstat == _FREE)
        can_dn = (vstat == _AT_UPPER) | (vstat == _FREE)
        elig = (can_up & (dcur < -opt_tol)) | (can_dn & (dcur > opt_tol))

        if not elig.any():
            if not fresh:
                # drift guard: recompute exactly and re-price before claiming
                if not refresh():
                    status = int(Status.NUMERICAL)
                    break
                fresh = True
                since_refresh = 0
                continue
            status = int(Status.INFEASIBLE) if p1 else int(Status.OPTIMAL)
            break

        if bland:
            q = int(idx_n[elig][0])
        else:
            score = dcur * dcur
            if use_devex and not p1:
                score = score / np.maximum(weights, 1e-12)
            score = np.where(elig, score, -np.inf)
            q = int(np.argmax(score))
        s = 1.0 if dcur[q] < 0 else -1.0

        # ---- FTRAN + ratio test -------------------------------------------
        w = lu.ftran(col(q))
        delta = -s * w
        up = delta > pivot_tol
        dn = delta < -pivot_tol
        rng_q = hi[q] - lo[q]

        long_step = p1 and not bland
        if long_step:
            # Long-step (piecewise-linear) phase-1 ratio test.  The phase-1
            # objective f(t) = Σ viol_i(t) along the entering ray is convex
            # piecewise linear; instead of stopping at the FIRST breakpoint
            # (one violation fixed per pivot — ops/ratio.py's rule, which at
            # Netlib scale costs tens of thousands of phase-1 pivots), walk
            # the sorted breakpoints accumulating slope and stop where the
            # slope turns non-negative — one pivot can cross (and repair)
            # many violated rows.  Reference-class codes do the same
            # (Maros-style piecewise-linear phase 1).
            sigma_r = np.where(below, -1.0, np.where(above, 1.0, 0.0))
            slope0 = float(sigma_r @ delta)
            # rising rows: a below-row's slope contribution rises by δ at lo
            # (violation repaired) and by δ again at hi (new violation);
            # feasible rows break only at hi; above-rows have no breakpoint.
            r1 = up & below
            r2 = up & ~above & np.isfinite(hiB)
            f1 = dn & above
            f2 = dn & ~below & np.isfinite(loB)
            with np.errstate(invalid="ignore"):
                parts = [
                    ((loB[r1] - xB[r1]) / delta[r1], delta[r1],
                     np.nonzero(r1)[0], loB[r1]),
                    ((hiB[r2] - xB[r2]) / delta[r2], delta[r2],
                     np.nonzero(r2)[0], hiB[r2]),
                    ((hiB[f1] - xB[f1]) / delta[f1], -delta[f1],
                     np.nonzero(f1)[0], hiB[f1]),
                    ((loB[f2] - xB[f2]) / delta[f2], -delta[f2],
                     np.nonzero(f2)[0], loB[f2]),
                ]
            ratios = np.concatenate([p[0] for p in parts])
            incr = np.concatenate([p[1] for p in parts])
            rows_bp = np.concatenate([p[2] for p in parts])
            tgts = np.concatenate([p[3] for p in parts])
            ratios = np.maximum(ratios, 0.0)  # drift guard
            order = np.argsort(ratios, kind="stable")
            csl = slope0 + np.cumsum(incr[order])
            cross = np.nonzero(csl >= 0.0)[0]
            if cross.size:
                k = int(cross[0])
                t_rows = float(ratios[order[k]])
                r_long = int(rows_bp[order[k]])
                tgt_long = float(tgts[order[k]])
            else:
                t_rows = np.inf
            flip = rng_q <= t_rows
            unbounded = not np.isfinite(min(t_rows, rng_q))
        else:
            # textbook bounded-variable test with Harris two-pass
            # (ops/ratio.py semantics; in phase 1 under Bland, the
            # short-step first-breakpoint rule keeps anti-cycling exact)
            up_tgt = np.where(below, loB, hiB)
            dn_tgt = np.where(above, hiB, loB)
            up_ok = ~above
            dn_ok = ~below
            tgt = np.where(up, up_tgt, np.where(dn, dn_tgt, 0.0))
            blockable = ((up & up_ok) | (dn & dn_ok)) & np.isfinite(tgt)
            safe_delta = np.where(up | dn, delta, 1.0)
            with np.errstate(invalid="ignore"):
                ratio = np.where(blockable, (tgt - xB) / safe_delta, np.inf)
            ratio = np.maximum(ratio, 0.0)
            t_rows = ratio.min() if M else np.inf
            with np.errstate(invalid="ignore"):
                relaxed = np.where(
                    blockable,
                    (tgt - xB + np.sign(delta) * feas_tol) / safe_delta,
                    np.inf,
                )
            t_relaxed = max(relaxed.min() if M else np.inf, 0.0)
            tie = (ratio <= t_relaxed) | (
                ratio <= t_rows * (1.0 + tie_rel) + tie_abs
            )
            flip = rng_q <= t_rows
            unbounded = not np.isfinite(min(t_rows, rng_q))

        if unbounded:
            if not fresh:
                if not refresh():
                    status = int(Status.NUMERICAL)
                    break
                fresh = True
                since_refresh = 0
                continue
            status = int(Status.NUMERICAL) if p1 else int(Status.UNBOUNDED)
            break

        niter += 1
        if bland:
            bland_iters += 1
        fresh = False
        if flip:
            t = rng_q
            xB = xB + t * delta
            vstat[q] = _AT_UPPER if vstat[q] == _AT_LOWER else _AT_LOWER
            if not p1:
                obj += dcur[q] * s * t
        else:
            if long_step:
                r = r_long
                t = t_rows
                tgt_r = tgt_long
            elif bland:
                masked = np.where(tie, basis, np.iinfo(np.int64).max)
                r = int(np.argmin(masked))
                t = float(ratio[r])
                tgt_r = float(tgt[r])
            else:
                r = int(np.argmax(np.where(tie, np.abs(w), -np.inf)))
                t = float(ratio[r])
                tgt_r = float(tgt[r])
            wr = float(w[r])
            lv = int(basis[r])
            if vstat[q] in (_AT_LOWER, _FIXED):
                enter_base = lo[q]
            elif vstat[q] == _AT_UPPER:
                enter_base = hi[q]
            else:
                enter_base = 0.0
            if loB[r] == hiB[r]:
                lstat = _FIXED
            elif tgt_r == hiB[r]:
                lstat = _AT_UPPER
            else:
                lstat = _AT_LOWER

            if not p1:
                # pivot row α = (B⁻¹)_r A before the basis update
                rho = np.zeros(M)
                rho[r] = 1.0
                rho = lu.btran(rho)
                alpha = AT_csr @ rho
                rd = dcur[q] / wr
                d = d - rd * alpha
                d[q] = 0.0
                d[lv] = -rd
                obj += dcur[q] * s * t
                if use_devex:
                    gq = max(weights[q], 1.0)
                    tcol = alpha / wr
                    weights = np.maximum(weights, (tcol * tcol) * gq)
                    weights[lv] = max(gq / (wr * wr), 1.0)
                    weights[q] = 1.0
                    if gq > opts.devex_reset:
                        weights = np.ones(N)

            xB = xB + t * delta
            xB[r] = enter_base + s * t
            basis[r] = q
            vstat[lv] = lstat
            vstat[q] = _BASIC
            if not p1:
                d[vstat == _BASIC] = 0.0
            lu.update(w, r)

        since_refresh += 1
        if since_refresh >= refactor_period and status == int(Status.RUNNING):
            if not refresh():
                status = int(Status.NUMERICAL)
                break
            fresh = True
            since_refresh = 0

        if progress_every and niter % progress_every == 0:
            print(
                f"[hostlp] niter={niter} phase={phase} infeas={infeas:.3e} "
                f"obj={obj:.6e} etas={lu.n_etas}", flush=True,
            )

        # ---- progress accounting (anti-cycling trigger) ---------------------
        eps = 1e-10 * (1.0 + (abs(best) if np.isfinite(best) else 0.0))
        if metric < best - eps:
            noimprove = 0
        else:
            noimprove += 1
        best = min(best, metric)

    if status == int(Status.RUNNING):
        status = int(Status.MAX_ITER)
    xN = _nonbasic_x(vstat, lo, hi)
    x = np.array(xN)
    x[basis] = xB
    return HostResult(
        status=status,
        basis=basis.astype(np.int32),
        vstat=vstat.astype(np.int8),
        niter=niter,
        obj=float(c @ x),
        bland_iters=bland_iters,
        lu=lu if (fresh and lu.n_etas == 0) else None,
    )


def _dual_perturbation_cleanup(
    A, b, c, lo, hi, basis, vstat, opts, niter, bland_iters,
) -> Optional[HostResult]:
    """Remove the anti-cycling cost perturbation exactly: warm primal
    re-solve against the TRUE costs from the (primal-feasible) final basis.
    Phase 1 is a no-op; the few phase-2 pivots absorb whatever tiny dual
    infeasibility the perturbation left behind."""
    res = solve_host_sparse(
        A, b, c, lo, hi, basis, vstat, opts=opts,
    )
    if res is None or int(res.status) not in (
        int(Status.OPTIMAL), int(Status.INFEASIBLE), int(Status.UNBOUNDED)
    ):
        return None
    return res._replace(
        niter=res.niter + niter,
        bland_iters=res.bland_iters + bland_iters,
    )


def solve_host_dual(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    basis0: np.ndarray,
    vstat0: np.ndarray,
    *,
    opts: SolverOptions,
    max_iter: Optional[int] = None,
    progress_every: int = 0,
    A_csc: Optional[sp.csc_matrix] = None,
) -> Optional[HostResult]:
    """Exact-f64 sparse DUAL simplex from a dual-feasible basis.

    The reference restores feasibility after every edit with the dual method
    (`Solver::restore_feasibility`, `src/solver.rs` [CODE]): after
    `add_constraint` / `fix_var` / a Gomory cut the warm basis is dual
    feasible but primal infeasible, and dual pivots drive the violated
    basics out.  This mirrors `engine/dual.py` one-for-one — exact dual
    steepest edge leaving-row choice (violation² / ‖B⁻ᵀe_r‖², computed
    sparsely only for violated rows), Harris two-pass dual ratio test with
    the same tie window and largest-|α| stabilization, entering-variable
    bound flips, Bland fallback by lowest index — over the sparse
    `BasisLU` + eta file instead of the dense explicit inverse, so the
    pivot sequences agree (gated by tests/test_hostlp.py).

    Returns None when the starting basis is singular or NOT dual feasible
    beyond opt_tol (the caller falls back to the primal host loop, which
    handles any start).
    """
    M, N = A.shape
    if max_iter is None:
        max_iter = opts.effective_max_iter(M, N)
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    if A_csc is None:
        A_csc = sp.csc_matrix(A)
    AT_csr = A_csc.T.tocsr()

    basis = np.array(basis0, dtype=np.int64, copy=True)
    vstat = np.array(vstat0, dtype=np.int64, copy=True)
    feas_tol = float(opts.feas_tol)
    opt_tol = float(opts.opt_tol)
    pivot_tol = float(opts.pivot_tol)
    tie_rel = float(opts.ratio_tie_rel)
    tie_abs = float(opts.ratio_tie_abs)
    refactor_period = opts.effective_refactor_period(M)
    idx_n = np.arange(N, dtype=np.int64)

    lu: Optional[BasisLU] = None
    d = np.zeros(N)
    xB = np.zeros(M)
    obj = 0.0
    # working costs: identical to c until the anti-cycling perturbation below
    # fires; all in-loop pricing/ratio quantities use c_work, the returned
    # objective is always recomputed against the TRUE c
    c_work = c
    perturbed = False

    def col(q: int) -> np.ndarray:
        s0, s1 = A_csc.indptr[q], A_csc.indptr[q + 1]
        out = np.zeros(M)
        out[A_csc.indices[s0:s1]] = A_csc.data[s0:s1]
        return out

    def refresh() -> bool:
        nonlocal lu, xB, d, obj
        try:
            lu = BasisLU(A_csc, basis)
        except (RuntimeError, ValueError):
            return False
        xN = _nonbasic_x(vstat, lo, hi)
        xB = lu.ftran(b - A_csc @ xN)
        y = lu.btran(c_work[basis])
        d = c_work - AT_csr @ y
        d[vstat == _BASIC] = 0.0
        obj = float(c_work[basis] @ xB + c_work @ xN)
        return True

    if not refresh():
        return None

    # dual feasibility precondition: nonbasics' reduced costs on their
    # feasible side (AT_LOWER ⇒ d ≥ −opt_tol, AT_UPPER ⇒ d ≤ opt_tol,
    # FREE ⇒ |d| ≤ opt_tol; FIXED unconstrained)
    bad = (((vstat == _AT_LOWER) & (d < -opt_tol))
           | ((vstat == _AT_UPPER) & (d > opt_tol))
           | ((vstat == _FREE) & (np.abs(d) > opt_tol)))
    if bad.any():
        return None

    status = int(Status.RUNNING)
    niter = 0
    bland_iters = 0
    noimprove = 0
    best = np.inf
    fresh = True
    since_refresh = 0

    while status == int(Status.RUNNING) and niter < max_iter:
        loB = lo[basis]
        hiB = hi[basis]
        viol_lo = np.maximum(loB - xB, 0.0)
        viol_hi = np.maximum(xB - hiB, 0.0)
        viol = viol_lo + viol_hi
        max_viol = float(viol.max()) if M else 0.0

        if max_viol <= feas_tol:
            if not fresh:
                if not refresh():
                    status = int(Status.NUMERICAL)
                    break
                fresh = True
                since_refresh = 0
                continue
            status = int(Status.OPTIMAL)
            break

        # ---- anti-cycling cost perturbation (VERDICT r4 missing #4) ---------
        # Under the massive dual degeneracy of a warm re-solve (every
        # nonbasic priced to d ≈ 0 by the previous optimum) the dual ratio
        # test is all-ties and the method can 2-cycle between states that
        # Bland-on-entering alone does not break (measured: 42k iterations
        # on a basis 6 primal pivots from optimal).  The standard remedy is
        # structured cost perturbation: when the Bland window is exhausted
        # without violation progress, shift every nonbasic reduced cost
        # strictly INTO its feasible side by a tiny, per-column-distinct
        # amount — ties vanish, every dual step gains a strictly positive
        # dual-objective increment, and cycling is impossible.  The
        # perturbation lives in `c_work` only; once the (perturbed) dual
        # terminates primal-feasible, a warm primal clean-up against the
        # TRUE costs removes it exactly (a few phase-2 pivots — the basis
        # is primal feasible and near-optimal for c).
        if noimprove >= opts.bland_after and not perturbed:
            perturbed = True
            # deterministic per-column magnitudes (Knuth-hash spread keeps
            # them pairwise distinct — that is what breaks the ties)
            psi = ((idx_n * 2654435761) % (1 << 16)).astype(np.float64)
            psi = psi / float(1 << 16)
            mag = 16.0 * opt_tol * (1.0 + np.abs(c)) * (0.5 + 0.5 * psi)
            pert = np.where(vstat == _AT_LOWER, mag,
                            np.where(vstat == _AT_UPPER, -mag, 0.0))
            c_work = c + pert
            if not refresh():
                status = int(Status.NUMERICAL)
                break
            fresh = True
            since_refresh = 0
            noimprove = 0
            best = np.inf
            continue
        bland = noimprove >= opts.bland_after

        # -- leaving row: exact dual steepest edge over the violated rows ----
        # ‖B⁻ᵀe_r‖² needs one sparse BTRAN per violated row — the violated
        # set is small on the warm re-solve path (often just the new cut
        # row), so this is exact DSE at eta-file cost (dense mirror:
        # engine/dual.py computes it as explicit-inverse row norms).  When
        # the violated set is LARGE (a cold/many-violation start), exact DSE
        # would go quadratic in eta-solves (ADVICE r4: the measured 881k-btran
        # stall shows the scale) — cap it INSIDE this function: beyond
        # `dse_cap` rows, pre-rank by violation magnitude and score only the
        # top `dse_cap` exactly (still one btran each, still deterministic:
        # stable sort by (-viol, index)).
        vrows = np.nonzero(viol > 0.0)[0]
        dse_cap = 64
        if vrows.size > dse_cap:
            order = np.lexsort((vrows, -viol[vrows]))
            vrows = np.sort(vrows[order[:dse_cap]])
        r = -1
        r_score = -np.inf
        rho_r: Optional[np.ndarray] = None
        for rr in vrows:
            e_r = np.zeros(M)
            e_r[rr] = 1.0
            rho = lu.btran(e_r)
            beta = max(float(rho @ rho), 1e-12)
            score = viol[rr] * viol[rr] / beta
            if score > r_score:  # strict > = lowest-index tie-break
                r_score = score
                r = int(rr)
                rho_r = rho
        e = 1.0 if viol_lo[r] > 0 else -1.0
        target = loB[r] if e > 0 else hiB[r]

        # -- pivot row α = (B⁻ᵀe_r)ᵀ A ---------------------------------------
        alpha = AT_csr @ rho_r
        at = e * alpha
        nb_lo = vstat == _AT_LOWER
        nb_hi = vstat == _AT_UPPER
        free = vstat == _FREE
        elig = ((nb_lo & (at < -pivot_tol))
                | (nb_hi & (at > pivot_tol))
                | (free & (np.abs(at) > pivot_tol)))

        if not elig.any():
            if not fresh:
                if not refresh():
                    status = int(Status.NUMERICAL)
                    break
                fresh = True
                since_refresh = 0
                continue
            # dual unbounded ⇒ primal infeasible.  The discovering iteration
            # counts (engine/dual.py increments niter whenever max_viol >
            # feas_tol, entering column or not — the sequence gate matches
            # counts exactly).
            niter += 1
            status = int(Status.INFEASIBLE)
            break

        with np.errstate(divide="ignore", invalid="ignore"):
            theta = np.where(elig, np.abs(d) / np.abs(alpha), np.inf)
            relaxed = np.where(
                elig, (np.abs(d) + opt_tol) / np.abs(alpha), np.inf
            )
        theta_min = float(theta.min())
        t_relaxed = float(relaxed.min())
        tie = ((theta <= t_relaxed)
               | (theta <= theta_min * (1.0 + tie_rel) + tie_abs)) & elig
        if bland:
            q = int(idx_n[tie][0])
        else:
            q = int(np.argmax(np.where(tie, np.abs(alpha), -np.inf)))

        dq_step = (xB[r] - target) / alpha[q]
        w = lu.ftran(col(q))
        niter += 1
        if bland:
            bland_iters += 1
        fresh = False

        rng_q = hi[q] - lo[q]
        if rng_q <= abs(dq_step):
            # bound flip: the entering variable's own opposite bound blocks
            # first; basis, inverse and reduced costs stay put and the
            # violation at r strictly shrinks
            step_f = float(np.sign(dq_step) * rng_q)
            xB = xB - step_f * w
            vstat[q] = _AT_UPPER if vstat[q] == _AT_LOWER else _AT_LOWER
            obj += d[q] * step_f
        else:
            if vstat[q] in (_AT_LOWER, _FIXED):
                enter_base = lo[q]
            elif vstat[q] == _AT_UPPER:
                enter_base = hi[q]
            else:
                enter_base = 0.0
            lv = int(basis[r])
            lstat = (_FIXED if loB[r] == hiB[r]
                     else (_AT_LOWER if e > 0 else _AT_UPPER))
            dq_old = float(d[q])
            xB = xB - dq_step * w
            xB[r] = enter_base + dq_step
            basis[r] = q
            vstat[lv] = lstat
            vstat[q] = _BASIC
            delta_dual = dq_old / alpha[q]
            d = d - delta_dual * alpha
            d[q] = 0.0
            d[lv] = -delta_dual
            d[vstat == _BASIC] = 0.0
            obj += dq_old * dq_step
            lu.update(w, r)

        since_refresh += 1
        if since_refresh >= refactor_period and status == int(Status.RUNNING):
            if not refresh():
                status = int(Status.NUMERICAL)
                break
            fresh = True
            since_refresh = 0

        eps = 1e-10 * (1.0 + (abs(best) if np.isfinite(best) else 0.0))
        if max_viol < best - eps:
            noimprove = 0
        else:
            noimprove += 1
        best = min(best, max_viol)
        if noimprove >= 2 * max(int(opts.bland_after), 25):
            # Stall exit: under the massive dual degeneracy of a warm
            # re-solve (every nonbasic priced to d ≈ 0 by the previous
            # optimum), the dual can 2-cycle between states Bland-on-
            # entering alone does not break (measured: 42k iterations on a
            # basis 6 primal pivots from optimal).  A full Bland window
            # with zero violation improvement — even under the Bland rule —
            # means the method is not converging here; hand back MAX_ITER
            # and let the caller run the primal loop, which finishes these
            # nodes in single-digit pivots.
            status = int(Status.MAX_ITER)
            break
        if progress_every and niter % progress_every == 0:
            print(f"[hostdual] niter={niter} max_viol={max_viol:.3e} "
                  f"nviol={int((viol > 0).sum())} bland={bland} "
                  f"obj={obj:.6e}", flush=True)

    if status == int(Status.RUNNING):
        status = int(Status.MAX_ITER)
    if perturbed and status == int(Status.OPTIMAL):
        # the terminal state is optimal for the PERTURBED costs; clean up
        # against the true c before claiming anything (primal warm re-solve,
        # typically zero to a few phase-2 pivots)
        res = _dual_perturbation_cleanup(
            A, b, c, lo, hi, basis.astype(np.int32), vstat.astype(np.int8),
            opts, niter, bland_iters,
        )
        if res is not None:
            return res
        status = int(Status.MAX_ITER)  # caller falls back to the primal loop
    xN = _nonbasic_x(vstat, lo, hi)
    x = np.array(xN)
    x[basis] = xB
    return HostResult(
        status=status,
        basis=basis.astype(np.int32),
        vstat=vstat.astype(np.int8),
        niter=niter,
        obj=float(c @ x),
        bland_iters=bland_iters,
    )
