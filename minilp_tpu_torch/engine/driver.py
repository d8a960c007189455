"""Host-side driver: canonicalize → device solve → Solution wrapper (PyTorch port).

The seam between the API layer and the engines, ported from
`minilp_tpu/engine/driver.py` for the single-LP `Problem.solve()` path:

    presolve → canonicalize → [K1 megakernel (padded up to (512, 2048))
    or K2 streaming kernel (Netlib scale) → f64 check
    → (uncertified claim) exact host polish] → certified state → certify()

with the f64 torch engine as the last resort.  The device is explicit
(`SolverOptions.device`): a CUDA device that is not present raises, and
nothing falls back quietly to the CPU.  Unlike the JAX package, no
`except Exception` wraps a kernel: a failed build or launch fails the solve.
The algorithmic fallbacks stay — they act on a result, not on a fault: an
uncertified claim goes to the exact polish, any other kernel claim to the
f64 engine.

The f64 check of the final basis, the certified state rebuilt from it,
`certify()` and the dense B⁻¹ of a warm restart all ask `certificate.check`
(`engine/certificate.py`): the basis kernel on a card solve, the host's LU
on a CPU solve, one factorization for every seam that asks for the same
(basis, vstat) of the same canonical form.

Above `_CROSSOVER_M` padded rows a cold f64 solve starts with the PDHG →
simplex crossover (`engine/crossover.py`: the PDHG stage on the device,
basis identification, the exact host polish); `engine="pdhg"` runs the
first-order engine alone (`engine/pdhg.py`, one call on the solve's device
in the options' dtype, as the JAX package runs it off a TPU).

The handle (`EngineHandle`) owns the canonical form and the final state, and
carries the incremental re-solve API (`engine/incremental.py`): host-first
warm re-solves, then K1 or K2 restarted warm from (basis, vstat, B⁻¹), then
the f64 torch engines (`engine/dual.py`, `engine/primal.py`).

Not ported: the TPU-only f32 mid-size pass (it works around the TPU's
emulated f64), and the TPU branch of the PDHG engine's driver (chunked
launches under the TPU worker's watchdog, and an f32 head start for f64).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np
import torch

from .. import api
from ..canonical import CanonicalLP, canonicalize, nonbasic_values
from ..options import SolverOptions
from ..status import Status, VarStat
from ..utils import profiling, records
from . import certificate, hostlp, incremental
from .primal import solve_canonical
from .state import SimplexState, state_to_numpy

#: padded-row threshold above which a cold f64 solve starts with the PDHG →
#: simplex crossover (the JAX package's literal 2048)
_CROSSOVER_M = 2048

#: K1's optimality tolerance over the LP's largest |c_j| (`_k1_opt_tol`).
#: K1 keeps its reduced costs in f32, updated at each pivot and recomputed
#: from an f32 B⁻¹ every `refactor_period` pivots, so a column whose exact
#: reduced cost is 0, such as the twin of a basic column, reads a few 1e-6
#: of the costs' scale.  At an absolute 1e-6 K1 kept swapping such twins:
#: on an H100, 13 of the 64 degen2-shaped LPs of `degen2-cold` (largest
#: |c_j| 2.5 to 4.9) ran to `max_iter`, 46056 pivots, from a basis that was
#: already optimal.  At 1e-5, 3e-5 and 1e-4 each ended OPTIMAL after 2429 to
#: 3304 pivots.
_K1_OPT_REL = 1e-5


def _np_dtype(opts: SolverOptions):
    return np.float64 if opts.dtype == "float64" else np.float32


def _device(opts: SolverOptions) -> torch.device:
    """The solve's torch device; a CUDA device without a card raises."""
    dev = torch.device(opts.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"SolverOptions.device={opts.device!r} but no CUDA device is "
            'available; pass device="cpu" to solve on the CPU'
        )
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {opts.device!r}")
    return dev


def _raise_for_status(status: int) -> None:
    if status == Status.OPTIMAL:
        return
    if status == Status.INFEASIBLE:
        raise api.Infeasible()
    if status == Status.UNBOUNDED:
        raise api.Unbounded()
    raise api.SolverFailure(f"solver terminated with status {Status(status).name}")


def _exact_inverse(can: CanonicalLP, basis, vstat, opts: SolverOptions) -> np.ndarray:
    """The exact f64 B⁻¹ of `basis` (`certificate.check`); a singular basis
    raises LinAlgError."""
    binv = certificate.check(can, basis, vstat, opts, inverse=True).Binv
    if binv is None:
        raise np.linalg.LinAlgError("Singular matrix")
    return binv.copy()  # the caller's own: the certificate stays as it was


class EngineHandle:
    """Owns the canonical form + the final solver state for one Problem.

    The reference's `Solution` owns its `Solver` (`src/lib.rs` [API]); here
    the `Solution` facade owns this handle.  Its state is host numpy: every
    consumer (`certify`, `var_value`) reads it on the host.  The reported
    solution is *certified*: the exact vertex is recomputed from
    (basis, vstat) in f64 and checked primal + dual feasible
    (`certificate.check`).
    """

    def __init__(
        self,
        can: CanonicalLP,
        state: SimplexState,
        problem: "api.Problem",
        opts: SolverOptions,
    ):
        self.can = can
        self.state = state  # setter detects a lazy (0, 0) Binv placeholder
        self.problem = problem
        self.opts = opts
        #: var idx -> original (lo, hi) saved by fix_var (for unfix_var)
        self.fixed_bounds: Dict[int, Tuple[float, float]] = {}
        self._x_cache: np.ndarray | None = None
        self._exact_obj: float | None = None
        #: populated by `certify()`: True/False after a certification attempt
        self.certified: bool | None = None

    # -- lazy basis inverse ------------------------------------------------------
    # A cold solve builds its state with a (0, 0) B⁻¹ placeholder
    # (`_state_from_certified_basis`); the dense inverse is only needed by
    # warm restarts, so it is materialized on first access to `state`.
    @property
    def state(self) -> SimplexState:
        if self.binv_stale:
            self.ensure_binv()
        return self._state

    @state.setter
    def state(self, value: SimplexState) -> None:
        self._state = value
        self.binv_stale = tuple(value.Binv.shape) != (self.can.M, self.can.M)

    def ensure_binv(self) -> None:
        """Materialize the dense basis inverse into the state (no-op when
        already present)."""
        if not self.binv_stale:
            return
        with certificate.span("state_rebuild", self.opts):
            Binv = certificate.check(self.can, self._state.basis, self._state.vstat, self.opts,
                                     inverse=True).Binv
            # certified bases are nonsingular; an identity seed keeps the
            # handle usable and a warm restart's Newton telltale catches it;
            # else the handle's own copy: the certificate stays as it was
            Binv = np.eye(self.can.M) if Binv is None else Binv.copy()
            self._state = self._state._replace(
                Binv=np.asarray(Binv, dtype=_np_dtype(self.opts)))
        self.binv_stale = False

    # -- accessors ---------------------------------------------------------------
    def _x_full(self) -> np.ndarray:
        if self._x_cache is None:
            x = nonbasic_values(np.asarray(self._state.vstat), self.can.lo.astype(np.float64),
                                self.can.hi.astype(np.float64))
            x[np.asarray(self._state.basis)] = np.asarray(self._state.xB)
            self._x_cache = x
        return self._x_cache

    def certify(self, tol: float = 1e-7) -> bool:
        """Recompute the vertex exactly in f64 from (basis, vstat) and check
        primal + dual feasibility; on success the handle serves exact values."""
        with certificate.span("certify", self.opts):
            cert = certificate.check(self.can, self._state.basis, self._state.vstat, self.opts,
                                     tol=tol)
        self.certified = cert.verified
        if self.certified:
            self._x_cache = cert.x.copy()
            self._exact_obj = cert.obj
        return self.certified

    def user_objective(self) -> float:
        obj = self._exact_obj if self._exact_obj is not None else float(self._state.obj)
        return float(self.can.obj_sign * obj)

    def var_value(self, idx: int) -> float:
        if not (0 <= idx < self.can.nv):
            raise IndexError(f"variable index {idx} out of range")
        return float(self._x_full()[idx])

    def iterations(self) -> int:
        return int(self._state.niter)

    # -- incremental API (SURVEY.md §4.2/§4.3 call stacks) -----------------------
    def add_constraint(self, solution, terms, op, rhs) -> "api.Solution":
        return incremental.add_constraint(self, terms, op, rhs)

    def fix_var(self, solution, idx: int, val: float) -> "api.Solution":
        return incremental.fix_var(self, idx, val)

    def unfix_var(self, solution, idx: int) -> Tuple[bool, "api.Solution"]:
        return incremental.unfix_var(self, idx)

    def add_gomory_cut(self, solution, idx: int) -> "api.Solution":
        return incremental.add_gomory_cut(self, idx)


class PdhgHandle:
    """Solution handle for the first-order engine (no basis, no incremental API).

    The PDHG engine returns primal/dual iterates rather than a simplex basis;
    the incremental warm-start surface is simplex-specific, so those methods
    direct the user back to `engine="simplex"`.  The iterates are kept as
    host numpy in the options' dtype.
    """

    def __init__(self, can: CanonicalLP, pstate, problem, opts):
        self.can = can
        self.pstate = pstate
        self.x = pstate.x.cpu().numpy()
        self.problem = problem
        self.opts = opts

    def user_objective(self) -> float:
        return float(self.can.obj_sign * (self.can.c @ self.x))

    def var_value(self, idx: int) -> float:
        if not (0 <= idx < self.can.nv):
            raise IndexError(f"variable index {idx} out of range")
        return float(self.x[idx])

    def iterations(self) -> int:
        return int(self.pstate.niter)

    def _no_incremental(self, *_args, **_kw):
        raise api.SolverFailure(
            "incremental re-solve requires the simplex engine "
            '(SolverOptions(engine="simplex"))'
        )

    add_constraint = fix_var = unfix_var = add_gomory_cut = _no_incremental


def _maybe_presolve(problem: "api.Problem") -> "api.Problem":
    """Apply host presolve when enabled; may raise Infeasible/Unbounded."""
    if not problem.options.presolve:
        return problem
    from ..presolve import presolve_problem

    with profiling.span("presolve", host=True):
        reduced, stats = presolve_problem(problem)
    profiling.bump_stage("presolve_parallel_rows", stats.parallel_rows)
    return reduced


def _use_sparse_pdhg(A: np.ndarray, opts: SolverOptions) -> bool:
    if opts.pdhg_matrix == "sparse":
        return True
    if opts.pdhg_matrix == "dense":
        return False
    if opts.pdhg_matrix != "auto":
        raise ValueError(f"unknown pdhg_matrix {opts.pdhg_matrix!r}")
    # auto: sparse pays off when the densified matvec would waste memory
    # bandwidth on zeros — large instance, low density.
    return A.size >= (1 << 16) and np.count_nonzero(A) <= 0.1 * A.size


def _solve_problem_pdhg(problem: "api.Problem") -> "api.Solution":
    """`engine="pdhg"`: one PDHG call on the solve's device, in the options'
    dtype, over a dense or CSR A (`_use_sparse_pdhg`)."""
    from .pdhg import solve_pdhg, solve_pdhg_sparse

    opts = problem.options
    dev = _device(opts)
    problem = _maybe_presolve(problem)
    can = canonicalize(problem, dtype=_np_dtype(opts))
    put = lambda v: torch.as_tensor(np.asarray(v), device=dev)
    with profiling.span("upload", dev):
        args = (put(can.b), put(can.c), put(can.lo), put(can.hi))
    with _route("pdhg") as route:
        with profiling.span("upload", dev):
            amat = put(can.A)
        if _use_sparse_pdhg(can.A, opts):
            solver, amat = solve_pdhg_sparse, amat.to_sparse_csr()
        else:
            solver = solve_pdhg
        pstate = solver(amat, *args, opts=opts)
        status = int(pstate.status)
    handle = PdhgHandle(can, pstate, problem, opts)
    if records.enabled():
        records.emit(records.SolveRecord(
            event="pdhg_solve", engine="pdhg", status=Status(status).name,
            rows=can.m, cols=can.nv, padded_rows=can.M, padded_cols=can.N,
            iterations=int(pstate.niter),
            objective=(handle.user_objective()
                       if status == Status.OPTIMAL else None),
            wall_s=route.wall_s, backend=dev.type, dtype=opts.dtype,
        ))
    if status == Status.MAX_ITER:
        raise api.SolverFailure(
            f"PDHG did not converge in {opts.pdhg_max_iter} iterations "
            f"(KKT error {float(pstate.err):.2e})"
        )
    _raise_for_status(status)
    return api.Solution(handle, problem)


def _megakernel_eligible(can: CanonicalLP, opts: SolverOptions) -> bool:
    if opts.use_megakernel == "never":
        return False
    if opts.use_megakernel == "always":
        return True
    if opts.use_megakernel != "auto":
        raise ValueError(f"unknown use_megakernel {opts.use_megakernel!r}")
    # auto: a CUDA device and the TPU package's (512, 2048) envelope; the
    # H100's own threshold waits for the port's measurements
    return _device(opts).type == "cuda" and can.M <= 512 and can.N <= 2048


def _state_from_certified_basis(
    can: CanonicalLP, basis: np.ndarray, vstat: np.ndarray, niter: int,
    opts: SolverOptions,
    lu=None,
) -> SimplexState | None:
    """Exact f64 SimplexState (host numpy) rebuilt from a certified
    (basis, vstat): (xB, d, obj) from its certificate (`certificate.check`,
    the route's own check's when it made one; `lu`, a host route's factors).
    The dense B⁻¹ is a (0, 0) placeholder that `EngineHandle.ensure_binv`
    fills on first access.  Returns None on a singular basis (caller falls
    back).  Its host part is the host span `state_rebuild_host`."""
    with profiling.span("state_rebuild"):
        cert = certificate.check(can, basis, vstat, opts, lu=lu)
        if cert.singular:
            return None
        with profiling.span("state_rebuild_host", host=True):
            d = cert.d.copy()
            d[np.asarray(vstat) == int(VarStat.BASIC)] = 0.0
            dtype = _np_dtype(opts)
            return SimplexState(
                basis=np.asarray(basis, dtype=np.int32),
                vstat=np.asarray(vstat, dtype=np.int8),
                xB=np.array(cert.xB, dtype=dtype),
                d=np.asarray(d, dtype=dtype),
                Binv=np.zeros((0, 0), dtype=dtype),  # lazy placeholder (handle materializes)
                obj=np.asarray(cert.obj, dtype=dtype),
                niter=np.int32(int(niter)),
                status=np.int32(int(Status.OPTIMAL)),
                noimprove=np.int32(0),
                best=np.asarray(np.inf, dtype=dtype),
                weights=np.ones_like(d.astype(dtype)),
                phase=np.int32(2),
            )


def _host_polish_from_basis(
    can: CanonicalLP, basis: np.ndarray, vstat: np.ndarray, opts: SolverOptions,
    niter0: int = 0,
    accept_any_terminal: bool = False,
) -> SimplexState | None:
    """Finish an uncertified near-optimal f32 basis exactly, on the host.

    The sparse host engine (`hostlp.solve_host_sparse`) runs first; if it
    declines, the f64 torch engine runs warm from that basis on the CPU, as
    the JAX package runs its f64 engine on its CPU backend here.  Returns the
    exact f64 state (host numpy), or None (singular basis, or a terminal
    status outside `accept_any_terminal`'s set).  `niter0`, the pivot count
    of the f32 run, is added to the polished state's niter.
    """
    if opts.dtype != "float64":
        return None
    terminal_ok = (
        (int(Status.OPTIMAL), int(Status.INFEASIBLE), int(Status.UNBOUNDED))
        if accept_any_terminal else (int(Status.OPTIMAL),)
    )
    with profiling.span("host_polish", host=True):
        res = hostlp.solve_host_sparse(
            can.A, can.b, can.c, can.lo, can.hi, basis, vstat, opts=opts,
            A_csc=can.csc() if can.M >= certificate.SPARSE_HOST_M else None,
        )
    if res is not None and int(res.status) in terminal_ok:
        state = _state_from_certified_basis(
            can, res.basis, res.vstat, niter0 + res.niter, opts, lu=res.lu,
        )
        if state is not None:
            if int(res.status) != int(Status.OPTIMAL):
                state = state._replace(status=np.int32(int(res.status)))
            return state

    Bmat = can.A[:, basis].astype(np.float64)
    try:
        Binv0 = np.linalg.inv(Bmat)
    except np.linalg.LinAlgError:
        return None
    f64 = dataclasses.replace(opts, dtype="float64")
    cpu = lambda v: torch.as_tensor(np.asarray(v, dtype=np.float64))
    state = solve_canonical(
        cpu(can.A), cpu(can.b), cpu(can.c), cpu(can.lo), cpu(can.hi),
        vstat, basis, opts=f64, Binv0=cpu(Binv0),
    )
    if int(state.status) not in terminal_ok:
        return None
    state = state_to_numpy(state)
    return state._replace(niter=np.int32(int(state.niter) + niter0))


def _try_megakernel_solve(can: CanonicalLP, opts: SolverOptions,
                          warm_state=None) -> SimplexState | None:
    """Solve one canonical LP through K1 (f32 iterate) on the solve's device.

    Returns what `_finish_claim` makes of K1's claim: the exact f64 state,
    the polished state, or None (the caller runs the f64 engine).  A kernel
    fault raises.  `warm_state=(basis, vstat, Binv)` (unbatched host arrays)
    re-solves from a previous basis: the incremental API's warm restart.
    """
    from ..ops.kernels import batched_simplex as bs

    dev = _device(opts)
    if warm_state is not None:
        warm_state = tuple(np.asarray(x)[None] for x in warm_state)
    lp = [x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)]
    with profiling.span("megakernel", dev):
        # f32 on the device; `_finish_claim` checks the basis in exact f64
        with profiling.span("upload", dev):
            inputs = bs.upload(dev, *lp, dtype=np.float32)
        # K1's launch alone, with the copy of its result rows back
        clusters = bs.cluster_launches
        with profiling.span("megakernel_launch", dev):
            rows = bs.megakernel_rows(
                *inputs,
                slack0=can.nv,
                max_iter=opts.effective_max_iter(can.M, can.N),
                opt_tol=_k1_opt_tol(can, opts),
                warm_state=warm_state,
            ).cpu().numpy()
        profiling.bump_stage("megakernel_pivots", int(rows[0, -1]))
        if bs.cluster_launches > clusters:
            profiling.bump_stage("megakernel_cluster")
    m, n = can.M, can.N
    return _finish_claim("megakernel", _K1_POLISHED, can, rows[0, :m],
                         rows[0, m:m + n].astype(np.int8), int(rows[0, m + n]),
                         int(rows[0, m + n + 1]), opts)


def _k1_opt_tol(can: CanonicalLP, opts: SolverOptions) -> float:
    """K1's optimality tolerance on `can`: `_K1_OPT_REL` of its largest
    |c_j|, at least the kernel's default 1e-6 and the options' `opt_tol`.
    A recorded deviation: the JAX package runs K1 at 1e-6 here.  It
    only steers the f32 iterate; the f64 check of the basis decides."""
    return max(1e-6, opts.opt_tol, _K1_OPT_REL * float(np.abs(can.c).max(initial=0.0)))


def _finish_claim(route: str, polished: tuple, can: CanonicalLP, basis, vstat, status: int,
                  niter: int, opts: SolverOptions) -> SimplexState | None:
    """A kernel route's claim (K1's or K2's: `route` is "megakernel" or
    "streaming"): the exact f64 state when it is OPTIMAL and the basis passes
    its f64 check (`certificate.check`, whose certificate the state and
    `certify()` then share); the host polish from the basis for a claim whose status is in
    `polished` that failed it, as a basis after many f32 pivots is
    normally a few exact pivots from optimal and the polish banks the
    device's work; None for any other claim (the caller runs the host
    engines).  Counted as `route.<route>.polished` or `.declined`."""
    if status == int(Status.OPTIMAL) and certificate.check(can, basis, vstat, opts).verified:
        return _state_from_certified_basis(can, basis, vstat, niter, opts)
    if status in polished:
        profiling.bump_stage(f"route.{route}.polished")
        return _host_polish_from_basis(can, basis, vstat, opts, niter0=niter)
    profiling.bump_stage(f"route.{route}.declined")
    return None


#: the claims each kernel route polishes when they fail the f64 check: K1's
#: OPTIMAL, as the JAX package's route does; K2's OPTIMAL, NUMERICAL (the
#: kernel's Newton telltale: the basis outgrew f32) and MAX_ITER
_K1_POLISHED = (int(Status.OPTIMAL),)
_K2_POLISHED = (int(Status.OPTIMAL), int(Status.NUMERICAL), int(Status.MAX_ITER))


def _streaming_eligible(can: CanonicalLP, opts: SolverOptions) -> bool:
    if opts.use_streaming == "never":
        return False
    if opts.use_streaming == "always":
        return True
    if opts.use_streaming != "auto":
        raise ValueError(f"unknown use_streaming {opts.use_streaming!r}")
    # auto: a CUDA device, above K1's envelope and within the TPU package's
    # K2 envelope (padded M in (512, 4096], N <= 32768); the H100's own
    # thresholds wait for the port's measurements
    return (_device(opts).type == "cuda"
            and 512 < can.M <= 4096 and can.N <= 32768)


def _f32_opts(opts: SolverOptions) -> SolverOptions:
    """f32 working copy of `opts` with tolerances loosened to what single
    precision can actually resolve (the certification step restores exact
    accuracy; these only steer the iterate)."""
    return dataclasses.replace(
        opts,
        dtype="float32",
        feas_tol=max(opts.feas_tol, 1e-5),
        opt_tol=max(opts.opt_tol, 1e-6),
        pivot_tol=max(opts.pivot_tol, 1e-6),
    )


def streaming_options(can: CanonicalLP, opts: SolverOptions) -> dict:
    """The options `_try_streaming_solve` gives `solve_streaming` (and
    `chip_smoke.py` gives `prepare_launch`, to compare K2 with its plain
    version on the main path's launch)."""
    f32 = _f32_opts(opts)  # user tolerances, loosened to f32 resolution
    return dict(
        device=_device(opts),
        slack0=can.nv,
        max_iter=opts.effective_max_iter(can.M, can.N),
        # the Newton refresh is the kernel's costliest block; the auto floor
        # of 128 amortizes it (explicit settings respected verbatim)
        refactor_period=opts.streaming_refactor_period(can.M),
        feas_tol=f32.feas_tol, opt_tol=f32.opt_tol, pivot_tol=f32.pivot_tol,
        bland_after=max(opts.bland_after, 400),
        devex_reset=opts.devex_reset,
    )


def _try_streaming_solve(can: CanonicalLP, opts: SolverOptions,
                         warm_state=None) -> SimplexState | None:
    """Solve one canonical LP through K2 (f32 iterate) on the solve's device.

    Same contract as `_try_megakernel_solve` (`_finish_claim`).  A kernel
    fault raises.  `warm_state=(basis, vstat, Binv)` restarts K2 from a
    previous basis, on `can.A` as it stands.
    """
    from ..ops.kernels.streaming_simplex import solve_streaming

    options = streaming_options(can, opts)
    certificate.upload(can, opts)  # before the launch: outside the span `finish`
    res = solve_streaming(can.A, can.b, can.c, can.lo, can.hi, **options,
                          warm_state=warm_state)
    return _finish_claim("streaming", _K2_POLISHED, can, res.basis, res.vstat.astype(np.int8),
                         int(res.status), int(res.niter), opts)


def _solve_engine(can: CanonicalLP, opts: SolverOptions) -> SimplexState:
    """The f64 (or `opts.dtype`) torch engine cold on the solve's device,
    with the exact-inverse resume after a Newton divergence."""
    dev = _device(opts)
    dt = torch.float64 if opts.dtype == "float64" else torch.float32
    put = lambda v: torch.as_tensor(np.asarray(v), dtype=dt, device=dev)
    with profiling.span("upload", dev):
        args = (put(can.A), put(can.b), put(can.c), put(can.lo), put(can.hi))
    state = solve_canonical(*args, can.vstat0, can.basis0, opts=opts)
    if int(state.status) == int(Status.NUMERICAL):
        # Rare: the Newton refresh diverged.  Rebuild the inverse exactly
        # (on the card for a card solve) and resume from the failed state's
        # basis.
        Binv0 = _exact_inverse(can, state.basis.cpu().numpy(), state.vstat.cpu().numpy(), opts)
        state = solve_canonical(
            *args, state.vstat, state.basis, opts=opts, Binv0=put(Binv0),
        )
    return state_to_numpy(state)


def solve_problem(problem: "api.Problem") -> "api.Solution":
    """Cold solve: `Problem::solve` equivalent (SURVEY.md §4.1)."""
    opts = problem.options
    _device(opts)  # a missing card fails the solve before any work
    if opts.engine == "pdhg":
        return _solve_problem_pdhg(problem)
    if opts.engine != "simplex":
        raise ValueError(f"unknown engine {opts.engine!r}")
    user_problem = problem
    problem = _maybe_presolve(problem)

    with profiling.span("canonicalize", host=True):
        can = canonicalize(
            problem,
            extra_row_capacity=opts.row_capacity_slack,
            dtype=_np_dtype(opts),
        )
    if _megakernel_eligible(can, opts):
        with _route("megakernel") as route:
            state = _try_megakernel_solve(can, opts)
        if state is not None:
            return api.Solution(_handle("cold_solve_megakernel", can, state, route.wall_s,
                                        problem, opts), user_problem)
        # uncertified polish failure / non-optimal claim → f64 engine below
    if (opts.dtype == "float64" and can.M > _CROSSOVER_M
            and opts.crossover != "never" and opts.use_streaming != "always"):
        # PDHG → simplex crossover first at these sizes, on any device: a
        # cold slack-basis simplex there prices ~10⁵ pivots, the crossover a
        # few hundred exact ones after the PDHG stage.  K2 stays the cold
        # path below this size and the warm-restart path at every size.
        from .crossover import solve_cold_crossover

        with _route("crossover") as route:
            res = solve_cold_crossover(can, opts)
        if res is not None:
            state = _state_from_certified_basis(
                can, res.basis, res.vstat, res.niter, opts, lu=res.lu,
            )
            if state is not None:
                state = state._replace(status=np.int32(int(res.status)))
                return api.Solution(_handle("cold_solve_crossover", can, state, route.wall_s,
                                            problem, opts), user_problem)
        # crossover declined (PDHG far from optimum / singular crash) →
        # K2, then the host engines below
    if _streaming_eligible(can, opts):
        with _route("streaming") as route:
            state = _try_streaming_solve(can, opts)
        if state is not None:
            return api.Solution(_handle("cold_solve_streaming", can, state, route.wall_s,
                                        problem, opts), user_problem)
        # uncertified non-optimal claim or failed polish → host engines below
    if opts.dtype == "float64" and can.M > 2048:
        # Above the kernels' envelope with the crossover declined: the host
        # sparse engine cold (splu; the f64 torch engine on the CPU as its
        # fallback).
        with _route("host") as route:
            state = _host_polish_from_basis(
                can, np.asarray(can.basis0), np.asarray(can.vstat0), opts,
                niter0=0, accept_any_terminal=True,
            )
        if state is not None:
            return api.Solution(_handle("cold_solve_host", can, state, route.wall_s,
                                        problem, opts), user_problem)
    with _route("engine") as route:
        state = _solve_engine(can, opts)
    # Opportunistic certification for every dtype: one f64 solve against the
    # final basis (on the card for a card solve); when it passes, exact
    # values are served.
    handle = _handle("cold_solve", can, state, route.wall_s, problem, opts)
    if not handle.certified and int(state.status) == int(Status.OPTIMAL):
        # An OPTIMAL claim that fails exact certification is a drifted stop:
        # repair with exact host pivots from the claimed basis.
        # accept_any_terminal: an exact INFEASIBLE/UNBOUNDED finding ends the
        # solve — the drifted OPTIMAL claim was wrong.
        polished = _host_polish_from_basis(
            can, np.asarray(state.basis), np.asarray(state.vstat), opts,
            niter0=int(state.niter), accept_any_terminal=True,
        )
        if polished is not None:
            _raise_for_status(int(polished.status))
            handle = EngineHandle(can, polished, problem, opts)
            handle.certify()
    return api.Solution(handle, user_problem)


def _handle(event: str, can: CanonicalLP, state: SimplexState, wall_s: float,
            problem: "api.Problem", opts: SolverOptions) -> EngineHandle:
    """A route's final state as the solve's handle: the solve record
    `event`, a terminal status other than OPTIMAL raised, then `certify()`."""
    status = int(state.status)
    _emit_record(event, can, state, status, wall_s, opts)
    _raise_for_status(status)
    handle = EngineHandle(can, state, problem, opts)
    handle.certify()
    return handle


def _route(name: str) -> profiling.span:
    """The span of one route of a solve, `route.<name>`, counted under the
    same name as it is entered; its wall is the route's solve record's
    `wall_s`."""
    profiling.bump_stage(f"route.{name}")
    return profiling.span(f"route.{name}")


def _emit_record(event, can, state, status, wall_s, opts, engine="simplex"):
    if not records.enabled():
        return
    records.emit(records.SolveRecord(
        event=event,
        engine=engine,
        status=Status(status).name,
        rows=can.m,
        cols=can.nv,
        padded_rows=can.M,
        padded_cols=can.N,
        iterations=int(state.niter),
        objective=(
            float(can.obj_sign * float(state.obj))
            if status == Status.OPTIMAL else None
        ),
        wall_s=wall_s,
        backend=_device(opts).type,
        dtype=opts.dtype,
    ))
