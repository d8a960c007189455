"""K2, the streaming single-LP simplex kernel: Netlib-scale LPs on one card.

PyTorch port of `minilp_tpu/ops/kernels/streaming_simplex.py`.  K1 (the
megakernel) keeps a whole LP per thread block and tops out at padded
(512, 2048); this kernel takes one larger LP (the 25fv47 class: 821×1571,
canonicalized to 824×2432) and organises the simplex around one pass over Aᵀ
per MAJOR iteration:

* a major prices every column once against Aᵀ (phase 1: the composite
  infeasibility costs; phase 2: the reduced costs from y = c_B·B⁻¹) and
  picks the top `minor_k` candidates by projected steepest-edge weights;
* the candidates' tableau block W = (B⁻¹·A_cand)ᵀ is formed once, and up to
  `minor_k` MINOR pivots run on it alone, keeping the candidate reduced
  costs exact (phase 2) or recomputing them against σ (phase 1), with
  stale Devex weights synced on the entering and leaving lanes;
* the pivots' eta vectors are composed in a ledger and folded into the
  dense f32 B⁻¹ once per major;
* every `refactor_period` pivots (and before any terminal claim) B⁻¹ is
  refreshed by Newton sweeps X ← 2X − (X·B)·X against the basis matrix
  gathered from Aᵀ; the telltale ‖I − X·B‖∞ > 0.5 exits NUMERICAL;
* phase 1 may take a long step (the piecewise-linear search over the
  breakpoints), at `m >= long_step_min_m`.

Three layers, as for K1:

* `stream_kernel_call` — the kernel wrapper.  On a CUDA tensor it launches
  the hand-written CUDA kernel (`minilp_tpu_torch/csrc/streaming_simplex.cu`,
  replacing the Pallas TPU kernel `_stream_kernel`) and counts the launch in
  `launches`; on a CPU tensor it runs `stream_plain`.  Nothing else selects
  between the two, and nothing falls back: a failed build or launch raises.
  The kernel is one cooperative grid (`k2_grid_blocks`: one block per SM
  at Netlib scale): block 0 runs the simplex loop and its minors, and the
  others join its Newton refresh and vector recompute, each major's
  pricing, candidate merge and tableau block W, and the fold of the eta
  ledger, with results bit-identical to one block's.
* `stream_plain` — the kernel's plain torch version (any device), a
  transcription of the TPU kernel's loop.  The CPU tests hold it against the
  Pallas kernel in interpret mode; `chip_smoke.py` holds the CUDA kernel
  against it on the card.
* `solve_streaming` — host numpy in, Aᵀ and the vectors to the device in
  f32 (`prepare_launch`, which `chip_smoke.py` also calls to hold the
  kernel against its plain version on the main path's own first launch),
  then a chunk loop: each launch runs at most `chunk_iters` pivots, a
  host monitor (`SurrenderTracker`) reads the launch's packed scalars (one
  device-to-host copy per chunk) and either stops or relaunches warm from
  the device-resident (basis, vstat, B⁻¹).  The final basis is certified on
  the host in f64 (`_verify_f64`, shared with K1).

The iterate is f32 (matmuls in full f32: the plain version expects
`torch.backends.cuda.matmul.allow_tf32` to be False, PyTorch's default).
Reduction orders differ between the kernel, the plain version and the TPU,
so pivot sequences may differ; statuses, `verified` flags and certified
objectives agree.
"""

from __future__ import annotations

import ctypes
import time
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...status import Status, VarStat
from ...utils import profiling
from . import build
from .batched_simplex import _verify_f64


class StreamResult(NamedTuple):
    basis: np.ndarray     # (m,) int32 — final basis
    vstat: np.ndarray     # (n,) int32 — final variable statuses
    status: np.int32      # Status of the last launch (NUMERICAL on surrender)
    niter: np.int32       # pivots over all launches
    obj: np.float64       # exact objective (f64 recompute)
    verified: np.bool_    # f64 optimality certificate held
    x: np.ndarray         # (n,) f64 — exact vertex (f64 recompute)


class StreamOut(NamedTuple):
    """One launch's outputs, on the inputs' device."""

    basis: torch.Tensor    # (m,) int32
    vstat: torch.Tensor    # (n,) int32
    Binv: torch.Tensor     # (m, m) f32 — the maintained inverse (next warm seed)
    #: (7,) int32 [status, niter, phase, infeas, obj, majors, refreshes];
    #: infeas and obj hold f32 bit patterns (`.view(torch.float32)`): the
    #: primal infeasibility and the claimed objective that the chunk
    #: monitor reads.  majors and refreshes count the launch's major
    #: iterations and Newton refreshes.
    monitor: torch.Tensor


class SurrenderTracker:
    """f32 precision surrender across chunk launches.

    Once phase 2 is reached, residual primal infeasibility should sit at
    f32-roundoff level; if it stays orders of magnitude above feas_tol
    without improving across chunks, the instance's conditioning exceeds
    what f32 iteration can resolve (measured at maros scale: phase 2
    wanders, re-fixing drift-induced violations forever).  The driver then
    warm-starts the exact host engine from the (near-optimal) basis.

    A chunk only counts as stalled when BOTH the infeasibility has stopped
    halving AND the claimed objective has stopped moving — the round-2
    post-mortem: a pure infeasibility count surrendered while the objective
    was still in motion, handing the host a basis an hour of exact pivots
    from optimal.  Factored out of the chunk loop so the joint-stagnation
    policy is unit-testable without hardware (VERDICT r3 weak #6).

    PHASE-AGNOSTIC since round 4: a chip run at the maros shape froze in
    PHASE 1 (constant infeasibility, flat objective, all-degenerate
    pivots) and the phase-2-only tracker let it burn 345 s of device time
    to MAX_ITER; healthy phase 1 decays infeasibility geometrically, so
    the joint not-halving + obj-flat condition is just as meaningful there.
    """

    def __init__(self, feas_tol: float, patience: int = 4):
        self.feas_tol = float(feas_tol)
        self.patience = int(patience)
        self.stalled = 0
        self.best_infeas = float("inf")
        self.last_obj: float | None = None

    def update(self, phase: int, infeas: float, obj: float) -> bool:
        """Record one chunk's exit telemetry; True ⇒ surrender now."""
        fire = False
        if infeas > 1e3 * self.feas_tol:
            obj_moving = self.last_obj is None or (
                abs(obj - self.last_obj) > 1e-6 * (1.0 + abs(obj))
            )
            if infeas >= 0.5 * self.best_infeas and not obj_moving:
                self.stalled += 1
            else:
                self.stalled = 0
            self.best_infeas = min(self.best_infeas, infeas)
            fire = self.stalled >= self.patience
        else:
            self.stalled = 0
        self.last_obj = obj
        return fire


#: launches of the CUDA kernel in this process (plain-version calls do not
#: count); `chip_smoke.py` resets it before driving the main path and reads
#: it after
launches = 0

#: the kernel keeps its candidate lanes in shared memory
MAX_MINOR_K = 128

#: most blocks of one launch (the kernel's telltale slots, `kMaxGrid`)
MAX_GRID = 1024
#: the kernel's block (512 threads, 16 warps)
_THREADS, _WARPS = 512, 16

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p


def _library(defines: tuple = ()) -> ctypes.CDLL:
    return _bind(build.load("streaming_simplex", defines).lib)


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface of a K2 library."""
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.streaming_simplex_workspace_floats.argtypes = [_I, _I, _I]
    lib.streaming_simplex_workspace_floats.restype = ctypes.c_size_t
    lib.streaming_simplex_launch.argtypes = (
        [_P] * 13 + [_I] * 8 + [_F] * 7 + [_I] * 4 + [_P])
    lib.streaming_simplex_launch.restype = _I
    lib.streaming_simplex_grid_limits.argtypes = [ctypes.POINTER(_I)] * 2
    lib.streaming_simplex_grid_limits.restype = _I
    lib.streaming_simplex_error_string.argtypes = [_I]
    lib.streaming_simplex_error_string.restype = ctypes.c_char_p
    return lib


def k2_grid_blocks(m: int, n: int, sm_count: int, per_sm: int) -> int:
    """Blocks of K2's cooperative grid for an (n, m) Aᵀ: as many as can be
    resident at once (`sm_count` × `per_sm`), but no more than the widest
    grid phase has work items: the m² entries of the Newton gather and copy
    at one per thread, or the n rows of the reduced-cost product at one per
    warp.  At least 1, at most `MAX_GRID`."""
    resident = sm_count * per_sm
    if resident < 1:
        raise ValueError(f"no block of K2 fits: {sm_count} SMs x {per_sm} per SM")
    work = max(-(-m * m // _THREADS), -(-n // _WARPS))
    return max(1, min(resident, work, MAX_GRID))


def grid_limits(device) -> Tuple[int, int]:
    """(SM count, K2 blocks per SM) of a CUDA device; raises with the CUDA
    error when the device cannot launch a cooperative grid."""
    lib = _library()
    sms, per_sm = _I(0), _I(0)
    with torch.cuda.device(device):
        err = lib.streaming_simplex_grid_limits(ctypes.byref(sms), ctypes.byref(per_sm))
    if err != 0:
        msg = lib.streaming_simplex_error_string(err).decode()
        raise RuntimeError(f"streaming_simplex cannot launch a cooperative grid: {msg} ({err})")
    return sms.value, per_sm.value


def default_blocks(device, m: int, n: int) -> int:
    """`k2_grid_blocks` on a CUDA device's own limits."""
    return k2_grid_blocks(m, n, *grid_limits(device))


def _check_inputs(AT, b, c, lo, hi, warm, minor_k):
    if AT.dim() != 2:
        raise ValueError(f"AT must be (n, m), got shape {tuple(AT.shape)}")
    n, m = AT.shape
    want = {"AT": (AT, (n, m), torch.float32), "b": (b, (m,), torch.float32),
            "c": (c, (n,), torch.float32), "lo": (lo, (n,), torch.float32),
            "hi": (hi, (n,), torch.float32)}
    if warm is not None:
        basis0, vstat0, Binv0 = warm
        want.update({
            "basis0": (basis0, (m,), torch.int32),
            "vstat0": (vstat0, (n,), torch.int32),
            "Binv0": (Binv0, (m, m), torch.float32),
        })
    for name, (t, shape, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != AT.device:
            raise ValueError(f"{name} is on {t.device}, AT on {AT.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m > n:
        raise ValueError(f"need m <= n, got m={m}, n={n}")
    if not (1 <= minor_k <= MAX_MINOR_K):
        raise ValueError(f"minor_k={minor_k} must be in [1, {MAX_MINOR_K}]")


def stream_kernel_call(
    AT, b, c, lo, hi, warm=None, *,
    slack0: int, max_iter: int, refactor_period: int, newton_sweeps: int,
    feas_tol: float, opt_tol: float, pivot_tol: float, bland_after: int,
    devex_floor: float, devex_reset: float, minor_k: int, regress_tol: float,
    se_weights: bool, minor_decay: float, xb_refine: bool, long_step: bool,
    blocks: Optional[int] = None,
) -> StreamOut:
    """Run K2 on one LP; returns its `StreamOut` on the inputs' device.

    Inputs: AT (n, m) — A transposed —, b (m,), c/lo/hi (n,), all f32 and
    contiguous on one device; `warm` is None or ``(basis0 (m,) i32,
    vstat0 (n,) i32, Binv0 (m, m) f32)``.  CUDA tensors launch the kernel
    on the current stream (no synchronisation) as one cooperative grid of
    `blocks` blocks, by default `default_blocks`; the results do not depend
    on it (the card checks launch `blocks=1` to show that).  A device that
    cannot take the grid raises.  CPU tensors run `stream_plain`.
    """
    if blocks is not None and not (1 <= blocks <= MAX_GRID):
        raise ValueError(f"blocks={blocks} must be in [1, {MAX_GRID}]")
    _check_inputs(AT, b, c, lo, hi, warm, minor_k)
    kw = dict(slack0=slack0, max_iter=max_iter, refactor_period=refactor_period,
              newton_sweeps=newton_sweeps, feas_tol=feas_tol, opt_tol=opt_tol,
              pivot_tol=pivot_tol, bland_after=bland_after,
              devex_floor=devex_floor, devex_reset=devex_reset,
              minor_k=minor_k, regress_tol=regress_tol, se_weights=se_weights,
              minor_decay=minor_decay, xb_refine=xb_refine, long_step=long_step)
    if AT.device.type == "cpu":
        return stream_plain(AT, b, c, lo, hi, warm, **kw)
    if AT.device.type != "cuda":
        raise ValueError(f"K2 runs on CUDA (kernel) or CPU (plain), not {AT.device}")
    return _launch(_library(), AT, b, c, lo, hi, warm, blocks=blocks, **kw)


def _launch(lib, AT, b, c, lo, hi, warm=None, *, blocks=None, slack0, max_iter,
            refactor_period, newton_sweeps, feas_tol, opt_tol, pivot_tol, bland_after,
            devex_floor, devex_reset, minor_k, regress_tol, se_weights, minor_decay,
            xb_refine, long_step) -> StreamOut:
    """One launch of `lib`'s kernel (the wrapper's, or a diagnostic build's)
    on checked CUDA inputs; counted in `launches`."""
    n, m = AT.shape
    dev = AT.device
    if blocks is None:
        blocks = default_blocks(dev, m, n)
    out = StreamOut(
        basis=torch.empty(m, dtype=torch.int32, device=dev),
        vstat=torch.empty(n, dtype=torch.int32, device=dev),
        Binv=torch.empty((m, m), dtype=torch.float32, device=dev),
        monitor=torch.empty(7, dtype=torch.int32, device=dev),
    )
    ws = torch.empty(lib.streaming_simplex_workspace_floats(m, n, minor_k),
                     dtype=torch.float32, device=dev)
    ptr = lambda t: None if t is None else t.data_ptr()
    basis0, vstat0, Binv0 = warm if warm is not None else (None, None, None)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        err = lib.streaming_simplex_launch(
            ptr(AT), ptr(b), ptr(c), ptr(lo), ptr(hi),
            ptr(basis0), ptr(vstat0), ptr(Binv0),
            ptr(out.basis), ptr(out.vstat), ptr(out.Binv), ptr(out.monitor),
            ptr(ws),
            m, n, slack0, max_iter, refactor_period, newton_sweeps,
            bland_after, minor_k,
            feas_tol, opt_tol, pivot_tol, devex_floor, devex_reset,
            regress_tol, minor_decay,
            int(se_weights), int(xb_refine), int(long_step), blocks, stream,
        )
    if err != 0:
        msg = lib.streaming_simplex_error_string(err).decode()
        raise RuntimeError(f"streaming_simplex kernel launch failed: {msg} ({err})")
    global launches
    launches += 1
    return out


def stream_plain(
    AT, b, c, lo, hi, warm=None, *,
    slack0: int, max_iter: int, refactor_period: int, newton_sweeps: int,
    feas_tol: float, opt_tol: float, pivot_tol: float, bland_after: int,
    devex_floor: float, devex_reset: float, minor_k: int, regress_tol: float,
    se_weights: bool, minor_decay: float, xb_refine: bool, long_step: bool,
) -> StreamOut:
    """Plain torch version of the kernel (any device), same inputs and
    outputs as `stream_kernel_call`.

    A transcription of the TPU kernel's loop on one LP: tensor values where
    the kernel has vectors and f32 scalars, Python values for its loop
    control.  The TPU kernel's one-hot selects and masked sums become
    indexing, and its candidate lanes are `minor_k` long (lanes past the
    selected candidates are inert in the TPU kernel too)."""
    n, m = AT.shape
    dev, f32 = AT.device, torch.float32
    AT_LOWER, AT_UPPER, FREE, FIXED, BASIC = (
        int(VarStat.AT_LOWER), int(VarStat.AT_UPPER), int(VarStat.FREE),
        int(VarStat.FIXED), int(VarStat.BASIC))
    RUNNING = int(Status.RUNNING)
    K = minor_k
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    eye = torch.eye(m, dtype=f32, device=dev)
    inf = torch.tensor(float("inf"), dtype=f32, device=dev)
    ninf = -inf

    if warm is not None:
        basis = warm[0].to(torch.int64).clone()
        vstat = warm[1].clone()
        Binv = warm[2].clone()
    else:
        Binv = eye.clone()
        basis = rows + slack0
        vstat = torch.where(
            torch.isfinite(lo), AT_LOWER,
            torch.where(torch.isfinite(hi), AT_UPPER, FREE))
        vstat = torch.where(lo == hi, FIXED, vstat)
        is_slack = (cols >= slack0) & (cols < slack0 + m)
        vstat = torch.where(is_slack, BASIC, vstat).to(torch.int32)
    loB, hiB, cB = lo[basis], hi[basis], c[basis]
    wts = torch.ones_like(c)
    tell = torch.zeros((), dtype=f32, device=dev)

    def nonbasic_x(vstat):
        x = torch.where(vstat == AT_LOWER, lo, 0.0)
        x = torch.where(vstat == AT_UPPER, hi, x)
        return torch.where(vstat == FIXED, lo, x)

    def recompute_vectors():
        """xB (with one refinement step), d and the steepest-edge weights
        from B⁻¹ and the statuses."""
        nonlocal xB, d, wts
        beff = b - nonbasic_x(vstat) @ AT
        xB = Binv @ beff
        if xb_refine:
            # r = b_eff − B·x_B, then x_B += B⁻¹·r
            xB = xB + Binv @ (beff - xB @ AT[basis])
        d = torch.where(vstat == BASIC, 0.0, c - AT @ (cB @ Binv))
        if se_weights:
            # γ_j = 1 + ‖B⁻¹ a_j‖², exact at every refresh
            Wt = AT @ Binv.T
            wts = 1.0 + (Wt * Wt).sum(1)

    def newton_refresh():
        """`newton_sweeps` sweeps X ← 2X − (X·B)·X; returns ‖I − X·B‖∞ of
        the last sweep (NaN-propagating, as the telltale's max)."""
        nonlocal Binv
        BT = AT[basis]  # Bᵀ: the basic columns of A as rows
        resid = torch.zeros((), dtype=f32, device=dev)
        for _ in range(newton_sweeps):
            H = Binv @ BT.T
            resid = (eye - H).abs().max()
            Binv = 2.0 * Binv - H @ Binv
        return resid

    def viol(xB):
        return (torch.clamp(loB - xB, min=0.0) + torch.clamp(xB - hiB, min=0.0))

    xB = d = None
    recompute_vectors()
    status, niter, phase, noimp, force, sref = RUNNING, 0, 1, 0, 0, 0
    fresh = 0 if warm is not None else 1
    n_major = n_refresh = 0
    best_inf = inf.clone()

    while status == RUNNING and niter < max_iter:
        n_major += 1
        # ---- refresh decision; the phase flip is confirmed on the refreshed
        # (exact) state
        feasible_pre = not bool(((xB < loB - feas_tol) | (xB > hiB + feas_tol)).any())
        do_refresh = (phase == 1 and feasible_pre) or force == 1 \
            or sref >= refactor_period
        if do_refresh:
            n_refresh += 1
            tell = newton_refresh()
            recompute_vectors()
            sref, fresh = 0, 1
        diverged = do_refresh and bool(tell > 0.5)
        ok_now = not bool((viol(xB) > regress_tol).any())
        transition = phase == 1 and do_refresh and ok_now
        regress = phase == 2 and do_refresh and not ok_now
        if transition or regress:
            phase = 2 if transition else 1
            noimp = 0
            best_inf = inf.clone()
        p1 = phase == 1

        # ---- major pricing: one pass over Aᵀ
        if p1:
            sigma0 = torch.where(xB < loB - feas_tol, -1.0,
                                 torch.where(xB > hiB + feas_tol, 1.0, 0.0)).to(f32)
            d1 = torch.where(vstat == BASIC, 0.0, -(AT @ (sigma0 @ Binv)))
            dcur = d1
        else:
            if not do_refresh:
                d = torch.where(vstat == BASIC, 0.0, c - AT @ (cB @ Binv))
            dcur = d
        bland = noimp >= bland_after
        can_up = (vstat == AT_LOWER) | (vstat == FREE)
        can_dn = (vstat == AT_UPPER) | (vstat == FREE)
        elig = (can_up & (dcur < -opt_tol)) | (can_dn & (dcur > opt_tol))
        nelig = int(elig.sum())
        found_any = nelig > 0
        gam = torch.ones_like(wts) if p1 else wts
        score0 = torch.where(elig, dcur * dcur / torch.clamp(gam, min=devex_floor), ninf)
        best0 = score0.max()

        # ---- candidates: the top minor_k scores, lowest index first on ties
        # (repeated argmax); under Bland only the lowest eligible index
        if bland:
            ncand = min(1, nelig)
            cand = torch.where(elig, cols, n).min().reshape(1)[:ncand]
        else:
            ncand = min(K, nelig)
            cand = torch.sort(score0, descending=True, stable=True).indices[:ncand]
        cand_ids = torch.full((K,), -1, dtype=torch.int64, device=dev)
        cand_ids[:ncand] = cand
        d_cand = torch.zeros(K, dtype=f32, device=dev)
        d_cand[:ncand] = dcur[cand]
        wts_cand = torch.ones(K, dtype=f32, device=dev)
        wts_cand[:ncand] = wts[cand]
        vstat_cand = torch.full((K,), FIXED, dtype=torch.int32, device=dev)
        vstat_cand[:ncand] = vstat[cand]
        # candidate tableau block: W[k] = B⁻¹·a_cand(k); rows past ncand inert
        W = torch.zeros((K, m), dtype=f32, device=dev)
        W[:ncand] = AT[cand] @ Binv.T
        etas = torch.zeros((K, m), dtype=f32, device=dev)
        eta_rs = torch.zeros(K, dtype=torch.int64, device=dev)
        n_eta, stop, wexit = 0, False, False

        # ---- minor pivots on the candidates
        j = 0
        while j < K and not stop and status == RUNNING and niter < max_iter:
            below = xB < loB - feas_tol
            above = xB > hiB + feas_tol
            if p1:
                sigma = torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(f32)
                d_cand = -(W @ sigma)
            dc = torch.where(vstat_cand == BASIC, 0.0, d_cand)
            valid_c = cand_ids >= 0
            can_up_c = (vstat_cand == AT_LOWER) | (vstat_cand == FREE)
            can_dn_c = (vstat_cand == AT_UPPER) | (vstat_cand == FREE)
            elig_c = valid_c & ((can_up_c & (dc < -opt_tol)) | (can_dn_c & (dc > opt_tol)))
            gam_c = torch.ones_like(wts_cand) if p1 else wts_cand
            score_c = torch.where(
                elig_c, dc * dc / torch.clamp(gam_c, min=devex_floor), ninf)
            found = bool(elig_c.any())
            # suboptimization exit: the best remaining candidate decayed well
            # below the major's top score
            decayed = bool(score_c.max() < best0 * minor_decay)
            found = found and (not decayed or bland)
            if bland:
                ksel = int(torch.where(elig_c, cand_ids, n).argmin())
            else:
                ksel = int(score_c.argmax())
            q = int(cand_ids[ksel])
            dq = dc[ksel]
            gq = torch.clamp(wts_cand[ksel], min=1.0)
            vq = int(vstat_cand[ksel])
            s = torch.where(dq < 0.0, 1.0, -1.0).to(f32)
            w = W[ksel].clone()

            # ---- ratio test (the megakernel's)
            delta = -s * w
            up = delta > pivot_tol
            dn = delta < -pivot_tol
            tgt = torch.where(up, torch.where(below, loB, hiB),
                              torch.where(dn, torch.where(above, hiB, loB), 0.0))
            blockable = ((up & ~above) | (dn & ~below)) & torch.isfinite(tgt)
            ratio = torch.where(
                blockable, (tgt - xB) / torch.where(up | dn, delta, 1.0), inf)
            ratio = torch.clamp(ratio, min=0.0)
            t_rows = ratio.min()
            tie = ratio <= t_rows * 1.0001 + 1e-6
            if bland:
                r = int(torch.where(tie, basis, n).argmin())
            else:
                r = int(torch.where(tie, w.abs(), ninf).argmax())

            # ---- long-step phase-1 override
            ls_active = ls_cross = False
            ls_t = ls_tgt = None
            if long_step and p1 and not bland and found:
                (ls_active, ls_cross, ls_t, r_ls, ls_tgt) = _long_step(
                    xB, loB, hiB, below, above, delta, up, dn, inf)
                if ls_active:
                    t_rows = ls_t if ls_cross else inf
                if ls_active and ls_cross:
                    r = r_ls
            lo_q, hi_q = lo[q], hi[q]
            rng_q = hi_q - lo_q
            flip = bool(rng_q <= t_rows)
            unbounded = not bool(torch.isfinite(torch.minimum(t_rows, rng_q)))
            if flip:
                t = rng_q
            elif ls_active and ls_cross:
                t = ls_t
            else:
                t = ratio[r]
            do_pivot = found and not flip and not unbounded
            do_flip = found and flip and not unbounded

            # pre-step values for the status accounting below
            feas_m = not bool((viol(xB) > regress_tol).any())
            move = t * w.abs().max()
            xb_scale = xB.abs().max()

            if do_pivot:
                if vq in (AT_LOWER, FIXED):
                    enter_base = lo_q
                elif vq == AT_UPPER:
                    enter_base = hi_q
                else:
                    enter_base = torch.zeros((), dtype=f32, device=dev)
                lv = int(basis[r])
                tgt_r = ls_tgt if (ls_active and ls_cross) else tgt[r]
                if bool(loB[r] == hiB[r]):
                    lstat = FIXED
                elif bool(tgt_r == hiB[r]):
                    lstat = AT_UPPER
                else:
                    lstat = AT_LOWER
                wr = w[r]
                wr_safe = torch.where(wr == 0.0, 1.0, wr)
                xB = xB + t * delta
                xB[r] = enter_base + s * t
                basis[r] = q
                vstat[lv] = lstat
                vstat[q] = BASIC
                loB[r], hiB[r], cB[r] = lo_q, hi_q, c[q]
                # exact candidate reduced costs and Devex weights on the
                # lanes: the pivot row over the candidates is column r of W
                rd = dq / wr_safe
                alpha_c = W[:, r].clone()
                is_q, is_lv = cand_ids == q, cand_ids == lv
                dc2 = d_cand - rd * alpha_c
                dc2 = torch.where(is_q, 0.0, dc2)
                d_cand = torch.where(is_lv, -rd, dc2)
                tc = alpha_c / wr_safe
                w_lv = torch.clamp(gq / (wr_safe * wr_safe), min=1.0)
                wc = torch.maximum(wts_cand, (tc * tc) * gq)
                wc = torch.where(is_lv, w_lv, wc)
                wc = torch.where(is_q, 1.0, wc)
                reset = bool(gq > devex_reset)
                wts_cand = torch.ones_like(wc) if reset else wc
                vstat_cand = torch.where(is_lv, lstat, torch.where(is_q, BASIC, vstat_cand)
                                         ).to(torch.int32)
                # stale Devex: only the leaving and entering columns sync to
                # the full weight vector (a reset clears all of it)
                if reset:
                    wts = torch.ones_like(wts)
                else:
                    wts[lv] = w_lv
                    wts[q] = 1.0
                # W takes the pivot's eta transform; the ledger composes it
                # into the stored etas and records it with its leaving row
                g_row = (w - (rows == r).to(f32)) / wr_safe
                W = W - alpha_c[:, None] * g_row[None, :]
                etas = etas - etas[:, r].clone()[:, None] * g_row[None, :]
                etas[n_eta] = g_row
                eta_rs[n_eta] = r
            elif do_flip:
                xB = xB + t * delta
                toggled = AT_UPPER if int(vstat[q]) == AT_LOWER else AT_LOWER
                vstat[q] = toggled
                flip_c = torch.where(vstat_cand == AT_LOWER, AT_UPPER, AT_LOWER)
                vstat_cand = torch.where(cand_ids == q, flip_c, vstat_cand).to(torch.int32)

            # ---- minor status and progress accounting; an UNBOUNDED claim
            # needs a fresh state and (phase 2) primal feasibility to the
            # drift floor
            believe = fresh == 1 and (p1 or feas_m)
            if found and unbounded:
                if believe:
                    status = int(Status.NUMERICAL if p1 else Status.UNBOUNDED)
                else:
                    wexit = True
            applied = found and not unbounded
            if applied:
                fresh = 0
                niter += 1
                sref += 1
                # phase 1 counts every pivot (the major resets on measured
                # progress); phase 2 counts degenerate steps relative to
                # the iterate's scale
                degenerate = bool(move <= 1e-7 * (1.0 + xb_scale))
                noimp = noimp + 1 if (p1 or degenerate) else 0
            if do_pivot:
                n_eta += 1
            if (not found) or unbounded or sref >= refactor_period or bland:
                stop = True
            j += 1

        # ---- fold the composed etas into B⁻¹ (rows of the old B⁻¹ at the
        # pivot rows)
        if n_eta > 0:
            P = Binv[eta_rs[:n_eta]]
            Binv = Binv - etas[:n_eta].T @ P

        # ---- phase-1 progress (the noimp reset authority)
        inf_now = viol(xB).sum()
        if p1:
            if bool(inf_now < best_inf - 1e-6 * (1.0 + best_inf)):
                noimp = 0
            best_inf = torch.minimum(best_inf, inf_now)

        # ---- major terminal claims (only from a fresh state)
        believe = fresh == 1
        if not found_any and believe and status == RUNNING:
            status = int(Status.INFEASIBLE if p1 else Status.OPTIMAL)
        force = 1 if ((not found_any or wexit) and not believe
                      and status == RUNNING) else 0
        if diverged:
            status = int(Status.NUMERICAL)

    if status == RUNNING:
        status = int(Status.MAX_ITER)
    infeas = viol(xB).sum()
    xn = torch.where(vstat == BASIC, 0.0, nonbasic_x(vstat))
    obj = (cB * xB).sum() + (c * xn).sum()
    bits = torch.stack([infeas, obj]).to(f32).view(torch.int32)
    ints = lambda *v: torch.tensor(v, dtype=torch.int32, device=dev)
    monitor = torch.cat([ints(status, niter, phase), bits, ints(n_major, n_refresh)])
    return StreamOut(basis=basis.to(torch.int32), vstat=vstat.to(torch.int32),
                     Binv=Binv.contiguous(), monitor=monitor)


def _long_step(xB, loB, hiB, below, above, delta, up, dn, inf):
    """Phase-1 long step (hostlp.py semantics): walk the convex piecewise-
    linear phase-1 objective along the ray to where its slope turns
    non-negative, so one pivot repairs many violated rows.

    Returns (active, cross, t, r, tgt): `active` when the slope starts
    negative; `cross` when it turns within a finite step; then the step t,
    the leaving row r and its target bound."""
    ninf = -inf
    sig = torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(xB.dtype)
    slope0 = (sig * delta).sum()
    sdelta = torch.where(up | dn, delta, 1.0)
    e1_ok = (up & below) | (dn & above)
    e1_tgt = torch.where(up, loB, hiB)
    e1_w = torch.where(e1_ok, delta, 0.0).abs()
    e1_t = torch.where(e1_ok, torch.clamp((e1_tgt - xB) / sdelta, min=0.0), inf)
    e2_ok = ((up & ~above & torch.isfinite(hiB))
             | (dn & ~below & torch.isfinite(loB)))
    e2_tgt = torch.where(up, hiB, loB)
    e2_w = torch.where(e2_ok, delta, 0.0).abs()
    e2_t = torch.where(e2_ok, torch.clamp((e2_tgt - xB) / sdelta, min=0.0), inf)
    tmax = torch.maximum(torch.where(e1_ok, e1_t, ninf).max(),
                         torch.where(e2_ok, e2_t, ninf).max())

    def g_at(tt):
        return (slope0 + torch.where(e1_t <= tt, e1_w, 0.0).sum()
                + torch.where(e2_t <= tt, e2_w, 0.0).sum())

    active = bool(slope0 < 0.0)
    cross = active and bool(torch.isfinite(tmax)) and bool(g_at(tmax) >= 0.0)
    absd = delta.abs()

    def emit(tl, th):
        """The leaving event inside (tl, th], largest |delta| first."""
        s1 = torch.where((e1_t > tl) & (e1_t <= th), absd, ninf)
        s2 = torch.where((e2_t > tl) & (e2_t <= th), absd, ninf)
        if bool(s2.max() > s1.max()):
            r = int(s2.argmax())
            return e2_t[r], r, e2_tgt[r]
        r = int(s1.argmax())
        return e1_t[r], r, e1_tgt[r]

    # first-breakpoint probe: when the slope is already non-negative at the
    # earliest event, that event is the crossing and the bisection is skipped
    t_min = torch.minimum(e1_t.min(), e2_t.min())
    tl = torch.tensor(-1.0, dtype=xB.dtype, device=xB.device)
    t, r, tgt = emit(tl, t_min)
    if cross and bool(g_at(t_min) < 0.0):
        th = torch.where(torch.isfinite(tmax), tmax, 0.0)
        for _ in range(22):
            mid = 0.5 * (tl + th)
            if bool(g_at(mid) >= 0.0):
                th = mid
            else:
                tl = mid
        t, r, tgt = emit(tl, th)
    return active, cross, t, r, tgt


class Launch(NamedTuple):
    """K2's first launch in a `solve_streaming` call (`prepare_launch`)."""

    A: np.ndarray          # (m, n_pad) host LP as given, n padded
    b: np.ndarray          # (m,)
    c: np.ndarray          # (n_pad,)
    lo: np.ndarray         # (n_pad,)
    hi: np.ndarray         # (n_pad,)
    args: tuple            # (AT, b, c, lo, hi) on the device, f32
    warm: Optional[tuple]  # (basis0, vstat0, Binv0) on the device, or None
    kw: dict               # `stream_kernel_call`'s keywords, max_iter the first chunk's
    max_iter: int          # the pivot budget over all chunks


def prepare_launch(
    A, b, c, lo, hi,
    *,
    device,
    slack0: Optional[int] = None,
    tile_n: int = 1,
    max_iter: int = 50_000,
    refactor_period: int = 128,
    newton_sweeps: int = 2,
    feas_tol: float = 1e-5,
    opt_tol: float = 1e-6,
    pivot_tol: float = 1e-6,
    bland_after: int = 400,
    devex_floor: float = 1e-12,
    devex_reset: float = 1e8,
    minor_k: int = 16,
    regress_tol: float = 1e-3,
    se_weights: bool = True,
    minor_decay: float = 0.0625,
    xb_refine: bool = True,
    long_step_min_m: int = 2048,
    warm_state: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
    chunk_iters: int | str | None = "auto",
) -> Launch:
    """The inputs of K2's first launch in `solve_streaming` (its options).

    Host arrays A (m, n), b (m,), c/lo/hi (n,): cast to f32 for the device
    (A transposed), kept as given for the certificate.  The identity slack
    block occupies columns [slack0, slack0+m) and forms the initial basis;
    `slack0=None` means the last m columns.  n is padded to a multiple of
    `tile_n` with inert FIXED columns (zero column, lo = hi = 0: FIXED is
    never eligible to enter); the kernel takes any n, so the default pads
    nothing (the TPU kernel needed tiles of 512).

    `warm_state=(basis0 (m,), vstat0 (n,), Binv0 (m, m))` starts from that
    state instead of the slack basis; the inverse is the Newton seed and a
    refresh precedes any terminal claim.

    `chunk_iters` bounds the pivots per kernel launch: "auto" takes 32768
    up to m = 1024 and 8192 above; None is one launch of `max_iter`.  The
    long step is on at `m >= long_step_min_m`.
    """
    A = np.asarray(A)
    m, n = A.shape
    if slack0 is None:
        slack0 = n - m
    n_pad = -(-n // tile_n) * tile_n
    b, c, lo, hi = np.asarray(b), np.asarray(c), np.asarray(lo), np.asarray(hi)
    if n_pad != n:
        pad = n_pad - n
        A = np.concatenate([A, np.zeros((m, pad), A.dtype)], axis=1)
        c = np.concatenate([c, np.zeros(pad, c.dtype)])
        lo = np.concatenate([lo, np.zeros(pad)])
        hi = np.concatenate([hi, np.zeros(pad)])
    dev = torch.device(device)
    # C order on the device whatever the host layout (a B⁻¹ from the sparse
    # LU's solve is Fortran-ordered)
    up = lambda x, dt: torch.tensor(np.ascontiguousarray(x, dtype=dt), device=dev)
    warm = None
    if warm_state is not None:
        basis0, vstat0, Binv0 = warm_state
        vstat0 = np.asarray(vstat0, dtype=np.int32)
        if vstat0.shape[0] != n_pad:  # padding columns are inert FIXED
            vstat0 = np.concatenate([
                vstat0,
                np.full(n_pad - vstat0.shape[0], int(VarStat.FIXED), np.int32),
            ])
        warm = (up(basis0, np.int32), up(vstat0, np.int32), up(Binv0, np.float32))
    with profiling.stage("stream_prep_s", dev):
        # host transpose + upload of Aᵀ: a real cold-wall term, attributed
        # apart from the first launch
        args = tuple([up(np.ascontiguousarray(A.T), np.float32)]
                     + [up(x, np.float32) for x in (b, c, lo, hi)])
    if chunk_iters == "auto":
        chunk_iters = 32768 if m <= 1024 else 8192
    chunk = max_iter if chunk_iters is None else min(int(chunk_iters), max_iter)
    kw = dict(slack0=slack0, max_iter=chunk, refactor_period=refactor_period,
              newton_sweeps=newton_sweeps, feas_tol=feas_tol, opt_tol=opt_tol,
              pivot_tol=pivot_tol, bland_after=bland_after,
              devex_floor=devex_floor, devex_reset=devex_reset,
              minor_k=minor_k, regress_tol=regress_tol, se_weights=se_weights,
              minor_decay=minor_decay, xb_refine=xb_refine,
              long_step=bool(m >= long_step_min_m))
    return Launch(A=A, b=b, c=c, lo=lo, hi=hi, args=args, warm=warm, kw=kw,
                  max_iter=max_iter)


def solve_streaming(A, b, c, lo, hi, **options) -> StreamResult:
    """Solve ONE canonical LP through K2 (module docstring); `options` are
    `prepare_launch`'s.

    Each launch runs at most the chunk's pivots; the solve relaunches warm
    from the previous launch's device-resident (basis, vstat, B⁻¹) until a
    terminal status, `max_iter` pivots in all, or a surrender of the
    `SurrenderTracker` between chunks.  The padding columns are stripped
    from the result.
    """
    launch = prepare_launch(A, b, c, lo, hi, **options)
    n = np.asarray(A).shape[1]
    warm, kw, max_iter = launch.warm, launch.kw, launch.max_iter
    total_iter, surrender = 0, False
    tracker = SurrenderTracker(kw["feas_tol"])
    first_launch = True
    while True:
        t_launch = time.perf_counter()
        out = stream_kernel_call(*launch.args, warm, **kw)
        # the one device-to-host copy of a chunk: its packed monitor scalars
        mon = out.monitor.cpu()
        st, niter, ph = (int(v) for v in mon[:3])
        inf_now, obj_now = (float(v) for v in mon[3:5].view(torch.float32))
        total_iter += niter
        profiling.bump_stage("stream_majors", int(mon[5]))
        profiling.bump_stage("stream_refreshes", int(mon[6]))
        # the first launch carries the kernel build and one-time costs
        profiling.record_stage(
            "stream_first_launch_s" if first_launch else "stream_chunks_s",
            time.perf_counter() - t_launch)
        profiling.bump_stage("stream_n_chunks")
        first_launch = False
        if st != int(Status.MAX_ITER) or total_iter >= max_iter:
            break
        if tracker.update(ph, inf_now, obj_now):
            surrender = True
            break
        # relaunch warm from this chunk's device-resident state
        warm = (out.basis, out.vstat, out.Binv)
    basis = out.basis.cpu().numpy()
    vstat = out.vstat.cpu().numpy()
    status = np.int32(Status.NUMERICAL) if surrender else np.int32(st)
    t_verify = time.perf_counter()
    obj, verified, x = _verify_f64(
        launch.A[None], launch.b[None], launch.c[None], launch.lo[None],
        launch.hi[None], basis[None], vstat[None], np.asarray(status)[None],
    )
    profiling.record_stage("stream_verify_s", time.perf_counter() - t_verify)
    return StreamResult(
        basis=basis, vstat=vstat[:n], status=status, niter=np.int32(total_iter),
        obj=obj[0], verified=verified[0], x=x[0][:n],
    )
