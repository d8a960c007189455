"""Host-side driver: canonicalize → device solve → Solution wrapper (PyTorch port).

The seam between the API layer and the engines, ported from
`minilp_tpu/engine/driver.py` for the single-LP `Problem.solve()` path:

    presolve → canonicalize → [K1 megakernel → host f64 check
    → (uncertified OPTIMAL) exact host polish] → certified state → certify()

with the f64 torch engine as the last resort.  The device is explicit
(`SolverOptions.device`): a CUDA device that is not present raises, and
nothing falls back quietly to the CPU.  Unlike the JAX package, no
`except Exception` wraps a kernel: a failed build or launch fails the solve.
The algorithmic fallbacks stay — they act on a result, not on a fault: an
uncertified OPTIMAL claim goes to the exact polish, any other kernel claim
to the f64 engine.

Not ported yet (each raises `NotImplementedError` or routes past it):
`engine="pdhg"` and the PDHG → simplex crossover (ROADMAP.md Queue 1 item
9), the streaming kernel K2 (item 7), and the TPU-only f32 mid-size pass.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from .. import api
from ..canonical import CanonicalLP, canonicalize, nonbasic_values
from ..options import SolverOptions
from ..status import Status, VarStat
from ..utils import profiling, records
from . import hostlp
from .primal import solve_canonical
from .state import SimplexState, state_to_numpy

#: padded-row threshold above which host-side exact linear algebra goes
#: through the sparse LU (engine/hostlp.py) instead of dense LAPACK
_SPARSE_HOST_M = 1024


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


class EngineHandle:
    """Owns the canonical form + the final solver state for one Problem.

    The reference's `Solution` owns its `Solver` (`src/lib.rs` [API]); here
    the `Solution` facade owns this handle.  Its state is host numpy: every
    consumer (`certify`, `var_value`) reads it on the host.  The reported
    solution is *certified*: the exact vertex is recomputed from
    (basis, vstat) in host f64 and checked primal + dual feasible.
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
        can = self.can
        basis = np.asarray(self._state.basis)
        A = can.A.astype(np.float64)
        t0 = time.perf_counter()
        if can.M >= _SPARSE_HOST_M:
            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
            Binv = None if lu is None else lu.lu.solve(np.eye(can.M))
        else:
            try:
                Binv = np.linalg.inv(A[:, basis])
            except np.linalg.LinAlgError:
                Binv = None
        if Binv is None:
            # certified bases are nonsingular; an identity seed keeps the
            # handle usable and a warm restart's Newton telltale catches it
            Binv = np.eye(can.M)
        self._state = self._state._replace(Binv=np.asarray(Binv, dtype=_np_dtype(self.opts)))
        self.binv_stale = False
        profiling.record_stage("state_rebuild_s", time.perf_counter() - t0)

    # -- accessors ---------------------------------------------------------------
    def _x_full(self) -> np.ndarray:
        if self._x_cache is None:
            vstat = np.asarray(self._state.vstat)
            lo = self.can.lo.astype(np.float64)
            hi = self.can.hi.astype(np.float64)
            x = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
            x = np.where(vstat == int(VarStat.AT_UPPER), hi, x)
            x = np.where(vstat == int(VarStat.FIXED), lo, x)
            x[np.asarray(self._state.basis)] = np.asarray(self._state.xB)
            self._x_cache = x
        return self._x_cache

    def certify(self, tol: float = 1e-7) -> bool:
        """Recompute the vertex exactly in f64 from (basis, vstat) and check
        primal + dual feasibility; on success the handle serves exact values."""
        with profiling.stage("certify_s"):
            return self._certify_timed(tol)

    def _certify_timed(self, tol: float = 1e-7) -> bool:
        can = self.can
        basis = np.asarray(self._state.basis)
        vstat = np.asarray(self._state.vstat)
        A = can.A.astype(np.float64)
        lo = can.lo.astype(np.float64)
        hi = can.hi.astype(np.float64)
        c = can.c.astype(np.float64)
        xN = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
        xN = np.where(vstat == int(VarStat.AT_UPPER), hi, xN)
        xN = np.where(vstat == int(VarStat.FIXED), lo, xN)
        xN = np.where(vstat == int(VarStat.BASIC), 0.0, xN)
        if can.M >= _SPARSE_HOST_M:
            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
            if lu is None:
                self.certified = False
                return False
            xB = lu.lu.solve(can.b.astype(np.float64) - A @ xN)
            y = lu.lu.solve(c[basis], trans="T")
        else:
            Bmat = A[:, basis]
            try:
                xB = np.linalg.solve(Bmat, can.b.astype(np.float64) - A @ xN)
                y = np.linalg.solve(Bmat.T, c[basis])
            except np.linalg.LinAlgError:
                self.certified = False
                return False
        d = c - y @ A
        loB, hiB = lo[basis], hi[basis]
        pfeas = bool(((xB >= loB - tol) & (xB <= hiB + tol)).all())
        at_lo = vstat == int(VarStat.AT_LOWER)
        at_hi = vstat == int(VarStat.AT_UPPER)
        free = vstat == int(VarStat.FREE)
        dfeas = bool(
            (np.where(at_lo, d >= -tol, True)
             & np.where(at_hi, d <= tol, True)
             & np.where(free, np.abs(d) <= tol, True)).all()
        )
        if not (pfeas and dfeas):
            self.certified = False
            return False
        x = xN.copy()
        x[basis] = xB
        self._x_cache = x
        self._exact_obj = float(c @ x)
        self.certified = True
        return True

    def user_objective(self) -> float:
        obj = self._exact_obj if self._exact_obj is not None else float(self._state.obj)
        return float(self.can.obj_sign * obj)

    def var_value(self, idx: int) -> float:
        if not (0 <= idx < self.can.nv):
            raise IndexError(f"variable index {idx} out of range")
        return float(self._x_full()[idx])

    def iterations(self) -> int:
        return int(self._state.niter)


def _maybe_presolve(problem: "api.Problem") -> "api.Problem":
    """Apply host presolve when enabled; may raise Infeasible/Unbounded."""
    if not problem.options.presolve:
        return problem
    from ..presolve import presolve_problem

    with profiling.stage("presolve_s"):
        reduced, _stats = presolve_problem(problem)
    return reduced


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
    (basis, vstat).

    One host LU gives (xB, d, obj) consistent with the basis; the dense B⁻¹
    is a (0, 0) placeholder that `EngineHandle.ensure_binv` fills on first
    access.  Returns None on a singular basis (caller falls back)."""
    t_rebuild = time.perf_counter()
    A = can.A.astype(np.float64)
    xN = nonbasic_values(vstat, can.lo, can.hi)
    if can.M >= _SPARSE_HOST_M:
        if lu is None:
            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
        if lu is None:
            return None
        xB = lu.lu.solve(can.b.astype(np.float64) - A @ xN)
        y = lu.lu.solve(can.c[basis].astype(np.float64), trans="T")
    else:
        Bmat = A[:, basis]
        try:
            xB = np.linalg.solve(Bmat, can.b.astype(np.float64) - A @ xN)
            y = np.linalg.solve(Bmat.T, can.c[basis].astype(np.float64))
        except np.linalg.LinAlgError:
            return None
    Binv = np.zeros((0, 0))  # lazy placeholder (handle materializes)
    d = can.c - y @ A
    d[vstat == int(VarStat.BASIC)] = 0.0
    obj = float(can.c[basis] @ xB + can.c @ xN)
    dtype = _np_dtype(opts)
    state = SimplexState(
        basis=np.asarray(basis, dtype=np.int32),
        vstat=np.asarray(vstat, dtype=np.int8),
        xB=np.asarray(xB, dtype=dtype),
        d=np.asarray(d, dtype=dtype),
        Binv=np.asarray(Binv, dtype=dtype),
        obj=np.asarray(obj, dtype=dtype),
        niter=np.int32(int(niter)),
        status=np.int32(int(Status.OPTIMAL)),
        noimprove=np.int32(0),
        best=np.asarray(np.inf, dtype=dtype),
        weights=np.ones_like(d.astype(dtype)),
        phase=np.int32(2),
    )
    profiling.record_stage("state_rebuild_s", time.perf_counter() - t_rebuild)
    return state


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
    with profiling.stage("host_polish_s"):
        res = hostlp.solve_host_sparse(
            can.A, can.b, can.c, can.lo, can.hi, basis, vstat, opts=opts,
            A_csc=can.csc() if can.M >= _SPARSE_HOST_M else None,
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


def _try_megakernel_solve(can: CanonicalLP, opts: SolverOptions) -> SimplexState | None:
    """Solve one canonical LP through K1 (f32 iterate) on the solve's device.

    Returns the exact f64 state when the discovered basis passes f64
    certification, the polished state when an OPTIMAL claim failed it, or
    None for any other claim (the caller runs the f64 engine).  A kernel
    fault raises.
    """
    from ..ops.kernels.batched_simplex import solve_batch_megakernel

    dev = _device(opts)
    with profiling.stage("megakernel_s", dev):
        res = solve_batch_megakernel(
            can.A[None], can.b[None], can.c[None], can.lo[None], can.hi[None],
            device=dev,
            slack0=can.nv,
            max_iter=opts.effective_max_iter(can.M, can.N),
        )
    basis = np.asarray(res.basis[0])
    vstat = np.asarray(res.vstat[0]).astype(np.int8)
    if not bool(res.verified[0]):
        # near-optimal f32 claim that failed exact certification: finish it
        # with a few exact f64 pivots on the host
        if int(res.status[0]) == int(Status.OPTIMAL):
            return _host_polish_from_basis(
                can, basis, vstat, opts, niter0=int(res.niter[0])
            )
        return None
    return _state_from_certified_basis(can, basis, vstat, int(res.niter[0]), opts)


def _streaming_eligible(can: CanonicalLP, opts: SolverOptions) -> bool:
    """The streaming kernel (K2) is not ported yet (ROADMAP.md Queue 1 item
    7); the JAX package likewise declines it off its TPU under "auto"."""
    return False


def _f32_midsize_eligible(can: CanonicalLP, opts: SolverOptions) -> bool:
    """The f32 mid-size pass works around the TPU's emulated f64; the JAX
    package enables it only there, and the port has no such backend."""
    return False


def _solve_engine(can: CanonicalLP, opts: SolverOptions) -> SimplexState:
    """The f64 (or `opts.dtype`) torch engine cold on the solve's device,
    with the exact-inverse resume after a Newton divergence."""
    dev = _device(opts)
    dt = torch.float64 if opts.dtype == "float64" else torch.float32
    put = lambda v: torch.as_tensor(np.asarray(v), dtype=dt, device=dev)
    args = (put(can.A), put(can.b), put(can.c), put(can.lo), put(can.hi))
    state = solve_canonical(*args, can.vstat0, can.basis0, opts=opts)
    if int(state.status) == int(Status.NUMERICAL):
        # Rare: the Newton refresh diverged.  Rebuild the inverse exactly on
        # the host and resume from the failed state's basis.
        B = can.A[:, state.basis.cpu().numpy()]
        state = solve_canonical(
            *args, state.vstat, state.basis, opts=opts,
            Binv0=put(np.linalg.inv(B)),
        )
    return state_to_numpy(state)


def solve_problem(problem: "api.Problem") -> "api.Solution":
    """Cold solve: `Problem::solve` equivalent (SURVEY.md §4.1)."""
    opts = problem.options
    _device(opts)  # a missing card fails the solve before any work
    if opts.engine == "pdhg":
        raise NotImplementedError(
            'engine="pdhg" is not ported to minilp_tpu_torch yet '
            "(ROADMAP.md, Queue 1 item 9: PDHG and crossover)"
        )
    if opts.engine != "simplex":
        raise ValueError(f"unknown engine {opts.engine!r}")
    user_problem = problem
    problem = _maybe_presolve(problem)

    with profiling.stage("canonicalize_s"):
        can = canonicalize(
            problem,
            extra_row_capacity=opts.row_capacity_slack,
            dtype=_np_dtype(opts),
        )
    if _megakernel_eligible(can, opts):
        with records.timed() as t:
            state = _try_megakernel_solve(can, opts)
        if state is not None:
            _emit_record("cold_solve_megakernel", can, state,
                         int(Status.OPTIMAL), t.wall_s, opts)
            handle = EngineHandle(can, state, problem, opts)
            handle.certify()
            return api.Solution(handle, user_problem)
        # uncertified polish failure / non-optimal claim → f64 engine below
    if opts.dtype == "float64" and can.M > 2048 and opts.crossover != "never":
        raise NotImplementedError(
            "cold solves above 2048 padded rows start with the PDHG → simplex "
            "crossover, which is not ported to minilp_tpu_torch yet (ROADMAP.md, "
            'Queue 1 item 9); pass SolverOptions(crossover="never") for the '
            "host sparse engine"
        )
    if _streaming_eligible(can, opts) or _f32_midsize_eligible(can, opts):
        raise NotImplementedError("streaming / f32 mid-size paths are not ported")
    if opts.dtype == "float64" and can.M > 2048:
        # Above the kernels' envelope with the crossover declined: the host
        # sparse engine cold (splu; the f64 torch engine on the CPU as its
        # fallback).
        with records.timed() as t:
            state = _host_polish_from_basis(
                can, np.asarray(can.basis0), np.asarray(can.vstat0), opts,
                niter0=0, accept_any_terminal=True,
            )
        if state is not None:
            status = int(state.status)
            _emit_record("cold_solve_host", can, state, status, t.wall_s, opts)
            _raise_for_status(status)
            handle = EngineHandle(can, state, problem, opts)
            handle.certify()
            return api.Solution(handle, user_problem)
    with records.timed() as t:
        state = _solve_engine(can, opts)
        status = int(state.status)
    _emit_record("cold_solve", can, state, status, t.wall_s, opts)
    _raise_for_status(status)
    handle = EngineHandle(can, state, problem, opts)
    # Opportunistic certification for every dtype: one host f64 solve against
    # the final basis; when it passes, exact values are served.
    if not handle.certify() and status == int(Status.OPTIMAL):
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
