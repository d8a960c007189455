"""PDHG → simplex crossover: cold solves beyond the kernel envelope
(PyTorch port of `minilp_tpu/engine/crossover.py`).

A cold slack-basis simplex at maros-r7 scale prices ~10⁵ pivots; the
first-order engine reaches a moderate KKT error far sooner, and the optimal
basis is readable off the converged iterate.  The crossover replaces tens
of thousands of cold pivots with a few hundred exact warm ones:

1. classify every column of the canonical LP from (x, y): strictly
   interior ⇒ basic candidate (ranked by relative interior depth),
   at-bound ⇒ AT_LOWER/AT_UPPER by the nearer bound;
2. repair the candidate set to a NONSINGULAR basis with a slack-seeded
   eta crash (`identify_basis`);
3. warm-start the exact host simplex (`hostlp.solve_host_sparse`) from that
   basis; it finishes and certifies in f64.

The PDHG stage runs first on the solve's CUDA device (`_device_pdhg_stage`:
dense f32 halpern, a bf16-rounded phase at large A, chunked launches with
the exact f64 KKT of every chunk's iterate computed on the host); the host
sparse-f64 stage then starts cold or continues warm on the CPU, as the
reference pins it there.  Differences from the reference, named:

* the device stage runs on a CUDA device, where the reference's runs on a
  TPU; it returns None when the solve's device is the CPU (the reference:
  off a TPU), and its `device=` keyword runs its logic on any device;
* no `except Exception` around the device stage: a fault there fails the
  solve instead of handing over to the host stage;
* the stage timer `crossover_pdhg_tpu_s` is gone (nothing read it), and
  its counter `crossover_pdhg_tpu_iters` is `crossover_pdhg_device_iters`.

`identify_basis` and `kkt_error_f64` are numpy and scipy, carried over.
"""

from __future__ import annotations

import dataclasses
import time
import types
from typing import Optional, Tuple

import numpy as np
import scipy.sparse as sp
import torch

from ..options import SolverOptions
from ..status import Status, VarStat
from ..utils import profiling
from . import hostlp, pdhg

_BASIC = int(VarStat.BASIC)
_AT_LOWER = int(VarStat.AT_LOWER)
_AT_UPPER = int(VarStat.AT_UPPER)
_FREE = int(VarStat.FREE)
_FIXED = int(VarStat.FIXED)

#: iterations of the device stage's first launch; later launches adapt to
#: about 10 s each
FIRST_CHUNK = 2_000


def identify_basis(
    A: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x: np.ndarray,
    d: np.ndarray,
    basis0: np.ndarray,
    *,
    interior_tol: float = 1e-7,
    pivot_rel: float = 1e-4,
    refactor_every: int = 128,
    cand_cap_factor: float = 1.5,
    A_csc=None,
) -> Tuple[np.ndarray, np.ndarray]:
    """Active-set basis from a near-optimal primal iterate x (+ reduced
    costs d, used only to rank ties).

    Returns (basis (M,), vstat (N,)).  `basis0` must be the canonical slack
    basis (row i ↔ its slack column) — the crash's nonsingular seed.
    Deterministic: candidate order is (score desc, index asc); row choice is
    largest |pivot| (lowest index on ties via argmax-first-max).
    """
    M, N = A.shape
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    x = np.asarray(x, dtype=np.float64)
    d = np.asarray(d, dtype=np.float64)

    dist_lo = np.where(np.isfinite(lo), x - lo, np.inf)
    dist_hi = np.where(np.isfinite(hi), hi - x, np.inf)
    interior = np.minimum(dist_lo, dist_hi)
    rel = interior / (1.0 + np.abs(x))
    fixed = lo == hi

    # candidates: strictly interior columns, best (deepest, smallest |d|)
    # first.  |d| only tie-breaks — at convergence an interior column has
    # d ≈ 0, so the ranking is dominated by interior depth.
    cand_mask = (rel > interior_tol) & ~fixed
    cand = np.nonzero(cand_mask)[0]
    score = rel[cand] / (1.0 + np.abs(d[cand]))
    order = np.lexsort((cand, -score))  # score desc, index asc
    cand = cand[order]
    cap = int(cand_cap_factor * M)
    if cand.size > cap:
        cand = cand[:cap]

    if A_csc is None:
        A_csc = sp.csc_matrix(np.asarray(A, dtype=np.float64))
    basis = np.array(basis0, dtype=np.int64, copy=True)
    slack_row = {int(basis[i]): i for i in range(M)}
    free_row = np.ones(M, dtype=bool)

    # pass 1: candidates that ARE a row's seed slack stay basic in place
    pending = []
    for q in cand:
        r = slack_row.get(int(q))
        if r is not None:
            free_row[r] = False
        else:
            pending.append(int(q))

    lu = hostlp.BasisLU(A_csc, basis)  # slack basis: never singular
    since_refactor = 0
    n_free = int(free_row.sum())
    for q in pending:
        if n_free == 0:
            break
        s0, s1 = A_csc.indptr[q], A_csc.indptr[q + 1]
        aq = np.zeros(M)
        aq[A_csc.indices[s0:s1]] = A_csc.data[s0:s1]
        w = lu.ftran(aq)
        wmax = np.abs(w).max()
        wfree = np.where(free_row, np.abs(w), -1.0)
        r = int(np.argmax(wfree))
        if wfree[r] < max(1e-8, pivot_rel * wmax):
            continue  # numerically dependent on the accepted set: skip
        lu.update(w, r)
        basis[r] = q
        free_row[r] = False
        n_free -= 1
        since_refactor += 1
        if since_refactor >= refactor_every:
            lu = hostlp.BasisLU(A_csc, basis)
            since_refactor = 0

    vstat = np.empty(N, dtype=np.int8)
    vstat[:] = np.where(
        fixed, _FIXED,
        np.where(
            dist_lo <= dist_hi,
            np.where(np.isfinite(lo), _AT_LOWER, _FREE),
            np.where(np.isfinite(hi), _AT_UPPER, _FREE),
        ),
    )
    vstat[basis] = _BASIC
    return basis.astype(np.int32), vstat


def kkt_error_f64(
    A: np.ndarray,
    b: np.ndarray,
    c: np.ndarray,
    lo: np.ndarray,
    hi: np.ndarray,
    x: np.ndarray,
    y: np.ndarray,
    feas_tol: float,
) -> float:
    """Exact host-f64 relative KKT error of (x, y) — the original-space
    mirror of `pdhg._kkt_error` (dr = dc = 1), used to monitor the device's
    f32 PDHG stage from the host: the f32 error is noisy near its
    resolution floor, so every stop/continue decision is taken on this
    number instead.  `A` may be dense or scipy-sparse (the canonical form's
    cached CSC: two O(nnz) matvecs per check)."""
    if not sp.issparse(A):
        A = np.asarray(A, np.float64)
    x = np.asarray(x, np.float64)
    y = np.asarray(y, np.float64)
    scale_b = 1.0 + np.linalg.norm(b)
    scale_c = 1.0 + np.linalg.norm(c)
    r_p = np.linalg.norm(A @ x - b) / scale_b
    red = c - y @ A
    at_lo = x <= lo + feas_tol
    at_hi = x >= hi - feas_tol
    viol = np.where(at_lo, np.minimum(red, 0.0), red)
    viol = np.where(at_hi & ~at_lo, np.maximum(red, 0.0), viol)
    viol = np.where(at_lo & at_hi, 0.0, viol)
    r_d = np.linalg.norm(viol) / scale_c
    lo_f = np.where(np.isfinite(lo), lo, 0.0)
    hi_f = np.where(np.isfinite(hi), hi, 0.0)
    contrib = np.where(red > 0, red * lo_f, red * hi_f)
    dobj = b @ y + contrib.sum()
    pobj = c @ x
    gap = abs(pobj - dobj) / (1.0 + abs(pobj) + abs(dobj))
    return float(max(r_p, r_d, gap))


def stage_options(opts: SolverOptions, tol: float) -> SolverOptions:
    """The device stage's PDHG options: f32, dense, the halpern variant, and
    an in-loop tolerance a little below the target (the host f64 check
    decides either way).  Halpern needs ~40% fewer iterations to the 1e-4
    neighbourhood at the maros shape (the reference's measurement); its
    frozen-ω weakness is what the stage's f64-monitored hand-offs absorb."""
    return dataclasses.replace(
        opts, dtype="float32", feas_tol=max(0.5 * tol, 1e-6),
        pdhg_matrix="dense", pdhg_variant="halpern",
    )


def _check_full_f32() -> None:
    """The stage's f32 products must be full f32, as the reference's are: a
    TF32 matmul keeps about three decimal digits."""
    if (torch.backends.cuda.matmul.allow_tf32
            or torch.get_float32_matmul_precision() != "highest"):
        raise RuntimeError(
            "the device PDHG stage needs full-f32 matmuls: "
            "torch.backends.cuda.matmul.allow_tf32 must be False and "
            'torch.get_float32_matmul_precision() "highest"'
        )


#: the A size (entries) from which the device stage runs a bf16 phase first
BF16_MIN_ENTRIES = 1 << 22


def _device_pdhg_stage(can, opts: SolverOptions, tol: float, *, device=None,
                       budget_s: Optional[float] = None):
    """f32 dense PDHG on the solve's CUDA device for the crossover.

    Chunk-launched (2 000 iterations, then about 10 s a launch); after every
    chunk the host computes the EXACT f64 KKT error of the pulled iterate
    and decides: stop at `tol`, stop at the precision floor of the phase's
    operator (3 consecutive chunks with < 3% relative improvement), or
    continue.  At large A (≥ BF16_MIN_ENTRIES) a first phase runs with the
    scaled matrix rounded to bf16, down to max(40·tol, 4e-3), then the f32
    matrix finishes.  Returns (x, y, niter, f64_err, omega) — possibly above
    `tol` when a floor was hit — or None when the solve's device is the CPU
    (`device=None`) or the run produced nothing finite.  `device` runs the
    stage on that device whatever the options say (the tests run it on the
    CPU).  `budget_s` is a soft wall budget (the bench's PDHG line): no
    chunk starts once it has passed, and an adapted chunk is cut to the
    time left at the last chunk's rate (at least 500 iterations).
    """
    if device is None:
        dev = torch.device(opts.device)
        if dev.type == "cpu":
            return None
    else:
        dev = torch.device(device)
    if dev.type == "cuda":
        _check_full_f32()
    f32 = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=dev)
    A64 = can.csc()  # sparse KKT monitor (kkt_error_f64 accepts sparse A)
    b64 = np.asarray(can.b, np.float64)
    c64 = np.asarray(can.c, np.float64)
    lo64 = np.asarray(can.lo, np.float64)
    hi64 = np.asarray(can.hi, np.float64)
    vecs = (f32(can.b), f32(can.c), f32(can.lo), f32(can.hi))
    A_f32 = f32(can.A)
    p_opts = stage_options(opts, tol)
    phases = []
    if can.A.size >= BF16_MIN_ENTRIES:  # ≥ ~16 MB f32: A's bytes set the step's cost
        phases.append((A_f32.to(torch.bfloat16), max(40.0 * tol, 4e-3)))
    phases.append((A_f32, tol))
    st = None
    done = 0
    x = y = None
    err = np.inf
    t_start = time.perf_counter()
    out_of_budget = False
    for A_phase, phase_tol in phases:
        if out_of_budget:
            break
        chunk = FIRST_CHUNK
        n_launches = 0
        stalled = 0
        best_err = err if np.isfinite(err) else np.inf
        if st is not None:
            # fresh averaging window for the new operator precision
            st = st._replace(
                x_sum=torch.zeros_like(st.x), y_sum=torch.zeros_like(st.y),
                x_rst=st.x, y_rst=st.y,
                inner=torch.zeros_like(st.inner),
                status=torch.full_like(st.status, int(Status.MAX_ITER)),
            )
        while True:
            if budget_s is not None and time.perf_counter() - t_start > budget_s:
                out_of_budget = True
                break
            cap = min(done + chunk, opts.pdhg_max_iter)
            t0 = time.perf_counter()
            st = pdhg.solve_pdhg(A_phase, *vecs, opts=p_opts, state0=st,
                                 stop_at=cap)
            x = st.x.double().cpu().numpy()  # waits for the launch too
            y = st.y.double().cpu().numpy()
            dt = time.perf_counter() - t0
            prev_done, done = done, int(st.niter)
            err = kkt_error_f64(A64, b64, c64, lo64, hi64, x, y, tol)
            n_launches += 1
            if err <= phase_tol:
                break
            if (int(st.status) != int(Status.MAX_ITER)
                    or done >= opts.pdhg_max_iter):
                # terminal in the loop (f32 claims done/INFEASIBLE/
                # UNBOUNDED): the host f64 error is what we have; the
                # caller's exact machinery decides
                break
            if err >= best_err * 0.97:
                stalled += 1
                if stalled >= 3:
                    break  # precision floor of this phase's operator
            else:
                stalled = 0
            best_err = min(best_err, err)
            if n_launches > 2:  # the reference's rule: adapt from the third
                rate = max(done - prev_done, 1) / max(dt, 1e-3)
                chunk = int(min(max(rate * 10.0, 500), 100_000))
                if budget_s is not None:
                    left = budget_s - (time.perf_counter() - t_start)
                    chunk = int(max(min(chunk, rate * max(left, 0.5)), 500))
        if err <= tol or done >= opts.pdhg_max_iter:
            break
    if x is None or not np.isfinite(err):
        return None
    return x, y, done, err, float(st.omega)


def warm_state(x, y, niter: int, err: float, omega: float,
               device="cpu") -> pdhg.PdhgState:
    """An f64 PdhgState that re-enters `solve_pdhg(_sparse)` warm from an
    original-space iterate: averages reset, restart point = the iterate,
    MAX_ITER (turned into RUNNING on entry)."""
    f64 = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=device)
    x, y = f64(x), f64(y)
    return pdhg.PdhgState(
        x=x, y=y, x_sum=torch.zeros_like(x), y_sum=torch.zeros_like(y),
        x_rst=x, y_rst=y,
        omega=f64(max(min(omega, 1e6), 1e-6)),
        inner=f64(0.0),
        last_err=f64(err),
        niter=torch.tensor(int(niter), dtype=torch.int32, device=device),
        status=torch.tensor(int(Status.MAX_ITER), dtype=torch.int32, device=device),
        err=f64(err),
    )


def solve_cold_crossover(can, opts: SolverOptions) -> Optional[hostlp.HostResult]:
    """Cold solve via PDHG + crossover + exact host polish.  Returns a
    terminal HostResult or None (the caller goes on to the other cold
    routes).

    The device stage runs first (`_device_pdhg_stage`).  Its f64 KKT error
    picks the hand-off: ≤ 10·tol, identify from the device iterate
    directly; > 1e-2, the host sparse-f64 stage runs cold; between, the
    host stage continues WARM from the device iterate.  On a CPU solve the
    host stage runs alone.  The host stage runs on the CPU.
    """
    if opts.dtype != "float64":
        return None

    # moderate-accuracy PDHG: the basis is combinatorial — identifying it
    # does not need 1e-8 residuals, and the last decades are the slow ones
    tol = max(float(opts.crossover_tol), float(opts.feas_tol))
    p_opts = dataclasses.replace(opts, feas_tol=tol, pdhg_matrix="sparse")
    dev_result = None
    dev = _device_pdhg_stage(can, opts, tol)
    if dev is not None:
        x_d, y_d, dev_iters, err_d, _omega_d = dev
        profiling.bump_stage("crossover_pdhg_device_iters", dev_iters)
        if err_d <= 10.0 * tol:
            # good enough to identify from directly: the exact polish absorbs
            # looser identification far cheaper than the PDHG tail costs
            dev_result = (x_d, y_d, dev_iters, err_d)
        elif err_d > 1e-2:
            dev = None  # the device run went nowhere — full host stage below
        # else: floor above the target — the host continues WARM below
    if dev_result is not None:
        pstate = types.SimpleNamespace(
            x=dev_result[0], y=dev_result[1], niter=dev_result[2],
            err=dev_result[3], status=int(Status.OPTIMAL),
        )
    else:
        with profiling.span("crossover_pdhg", host=True):
            A_csr = torch.as_tensor(np.asarray(can.A, np.float64)).to_sparse_csr()
            state0 = None if dev is None else warm_state(*dev[:2], dev[2], dev[3], dev[4])
            cpu = lambda v: torch.as_tensor(np.asarray(v, np.float64))
            pstate = pdhg.solve_pdhg_sparse(
                A_csr, cpu(can.b), cpu(can.c), cpu(can.lo), cpu(can.hi),
                opts=p_opts, state0=state0,
            )
    status = int(pstate.status)
    if status in (int(Status.INFEASIBLE), int(Status.UNBOUNDED)):
        # a first-order certificate is not an exact claim to surface from a
        # cold solve; let the exact engine derive its own
        return None
    if status == int(Status.MAX_ITER) and float(pstate.err) > 1e-2:
        return None  # nowhere near the optimum: identification would be noise

    x = np.asarray(pstate.x, dtype=np.float64)
    y = np.asarray(pstate.y, dtype=np.float64)
    A = np.asarray(can.A, dtype=np.float64)
    d = np.asarray(can.c, dtype=np.float64) - y @ A
    with profiling.span("crossover_identify", host=True):
        basis, vstat = identify_basis(
            A, can.lo, can.hi, x, d, np.asarray(can.basis0),
            A_csc=can.csc(),
        )
    with profiling.span("crossover_polish", host=True):
        res = hostlp.solve_host_sparse(
            can.A, can.b, can.c, can.lo, can.hi, basis, vstat, opts=opts,
            A_csc=can.csc(),
        )
    if res is None:
        return None
    if int(res.status) not in (
        int(Status.OPTIMAL), int(Status.INFEASIBLE), int(Status.UNBOUNDED)
    ):
        return None
    # niter stays a PIVOT count; the first-order iterations go to the stage
    # counters
    profiling.bump_stage("crossover_pdhg_iters", int(pstate.niter))
    return res
