"""K1, the batched small-LP simplex megakernel.

PyTorch port of `minilp_tpu/ops/kernels/batched_simplex.py`.  The whole
bounded two-phase primal simplex of each LP runs inside one kernel launch —
pricing, FTRAN, the ratio test, the rank-1 product-form update of a dense
f32 B⁻¹ and the periodic Newton refresh — with no host round trip per pivot.
A batch runs one LP per thread block (grid = batch); a launch of one LP, the
single-LP `Problem.solve()` path, runs as one cooperative grid of
thread-block clusters (`k1_grid_blocks`: as many clusters as the card holds
at the main path's shapes).  The leader's cluster takes each pivot's
phase-1 duals, FTRAN, rank-1 update and pivot row, handed over at the
cluster's barrier; the whole grid takes the refresh and the recompute.  The
kernel is hand-written CUDA C++ for Hopper
(`minilp_tpu_torch/csrc/batched_simplex.cu`, replacing the Pallas TPU kernel
`_simplex_kernel`); its source note says what bounds it on an H100.

Three layers, as in the JAX package:

* `simplex_kernel_call` — the kernel wrapper.  On a CUDA tensor it launches
  the kernel (and counts the launch in `launches`); on a CPU tensor it runs
  `simplex_plain`, the kernel's plain torch version.  Nothing else selects
  between the two, and nothing falls back: a failed build or launch raises.
* `simplex_plain` — a torch transcription of the kernel on tensors (any
  device), batched over LPs in lockstep.  The CPU tests use it, and
  `chip_smoke.py` compares the kernel against it on the card.
* `megakernel_rows` — one kernel call on device tensors, cast to f32 on the
  device.  The basis it finds is combinatorial, so the exact vertex and an
  f64 optimality certificate follow from one f64 LU per LP:
  `solve_batch_megakernel`, the batch entry point, certifies on the same
  device (`certify.py`'s kernel, one device-to-host copy of the results);
  the driver's single-LP route checks its basis through
  `engine/certificate.py`.  `_verify_f64` is the JAX package's host check,
  which the tests hold the certificates to.

The iterate is f32 (matmuls in full f32: the plain version expects
`torch.backends.cuda.matmul.allow_tf32` to be False, PyTorch's default).
Reduction order differs between the kernel, the plain version and the TPU,
so f32 pivot sequences may differ; statuses, `verified` flags and certified
objectives agree.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from ...status import Status, VarStat
from . import build, certify


class BatchResult(NamedTuple):
    basis: np.ndarray     # (B, m) int32 — final basis
    vstat: np.ndarray     # (B, n) int32 — final variable statuses
    status: np.ndarray    # (B,) int32
    niter: np.ndarray     # (B,) int32
    obj: np.ndarray       # (B,) f64 — exact objective (f64 recompute)
    verified: np.ndarray  # (B,) bool — f64 optimality certificate held
    x: np.ndarray         # (B, n) f64 — exact vertex (f64 recompute)


#: launches of the CUDA kernel in this process (plain-version calls do not
#: count); `chip_smoke.py` resets it before driving the main path and reads
#: it after
launches = 0
#: of those, the launches whose grid ran in thread-block clusters (a batch of
#: one on more than one block)
cluster_launches = 0

#: most blocks of one launch (`kMaxGrid` of `csrc/simplex_grid.cuh`)
MAX_GRID = 1024
#: the kernel's block (512 threads, 16 warps) and its GEMM tile
_THREADS, _WARPS, _TILE = 512, 16, 64

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p


def _library(defines: tuple = ()) -> ctypes.CDLL:
    lib = _bind(build.load("batched_simplex", defines).lib)
    lib.batched_simplex_cluster_limits.argtypes = [ctypes.POINTER(_I)] * 2
    lib.batched_simplex_cluster_limits.restype = _I
    return lib


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare the C interface that `raw_launch` needs, which every K1
    library has (another checkout's too)."""
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.batched_simplex_workspace_floats.argtypes = [_I, _I, _I]
    lib.batched_simplex_workspace_floats.restype = ctypes.c_size_t
    lib.batched_simplex_launch.argtypes = [_P] * 10 + [_I] * 6 + [_F] * 3 + [_I, _I, _P]
    lib.batched_simplex_launch.restype = _I
    lib.batched_simplex_error_string.argtypes = [_I]
    lib.batched_simplex_error_string.restype = ctypes.c_char_p
    return lib


def k1_grid_blocks(m: int, n: int, cluster: int, clusters: int) -> int:
    """Blocks of the cooperative grid of a one-LP K1 launch at (m, n) on a
    device whose K1 clusters have `cluster` blocks, `clusters` of them
    resident at once: a whole number of clusters, as many as are resident
    but no more than the widest grid phase has work items (the m² entries
    of the rank-1 update and the Newton gather at one per thread, the
    refresh GEMM's 64×64 tiles, the m rows of a matvec at one per warp, or
    the n column sums at one warp per 32 columns and block), and at most
    `MAX_GRID`; at least one cluster."""
    if cluster < 1 or clusters < 1:
        raise ValueError(f"no cluster of K1 fits: {clusters} clusters of {cluster} blocks")
    tiles = -(-m // _TILE)
    work = max(-(-m * m // _THREADS), tiles * tiles, -(-m // _WARPS), -(-n // 32))
    return cluster * max(1, min(clusters, work // cluster, MAX_GRID // cluster))


def check_blocks(blocks: Optional[int], batch: int, cluster: Optional[int] = None) -> None:
    """Raise ValueError unless `blocks` (None: the default) can be the grid
    of a K1 launch of `batch` LPs: 1 to `MAX_GRID`, 1 for a batch (one
    block per LP), and for one LP 1 or a whole number of clusters of
    `cluster` blocks (None: no card's cluster to hold it to)."""
    if blocks is None:
        return
    if not 1 <= blocks <= MAX_GRID:
        raise ValueError(f"blocks={blocks} must be in [1, {MAX_GRID}]")
    if blocks > 1 and batch > 1:
        raise ValueError(f"blocks={blocks} spreads one LP; a batch of {batch} runs "
                         "one block per LP")
    if blocks > 1 and cluster is not None and blocks % cluster:
        raise ValueError(f"blocks={blocks} must be 1 or a whole number of clusters "
                         f"of {cluster} blocks")


#: `grid_limits` of each CUDA device, by index
_LIMITS: dict = {}


def grid_limits(device) -> Tuple[int, int]:
    """(blocks of a K1 cluster, clusters resident at once) of a CUDA device,
    asked of it once; raises with the CUDA error when the device cannot
    launch a cooperative grid of clusters."""
    dev = torch.device(device)
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if index not in _LIMITS:
        lib = _library()
        size, clusters = _I(0), _I(0)
        with torch.cuda.device(index):
            err = lib.batched_simplex_cluster_limits(ctypes.byref(size), ctypes.byref(clusters))
        if err != 0:
            msg = lib.batched_simplex_error_string(err).decode()
            raise RuntimeError(f"batched_simplex cannot launch a cooperative grid: {msg} ({err})")
        _LIMITS[index] = (size.value, clusters.value)
    return _LIMITS[index]


def default_blocks(device, m: int, n: int) -> int:
    """`k1_grid_blocks` on a CUDA device's own limits."""
    return k1_grid_blocks(m, n, *grid_limits(device))


def _check_inputs(A, b, c, lo, hi, warm):
    if A.dim() != 3:
        raise ValueError(f"A must be (B, m, n), got shape {tuple(A.shape)}")
    Bsz, m, n = A.shape
    want = {"A": (A, (Bsz, m, n), torch.float32), "b": (b, (Bsz, m), torch.float32),
            "c": (c, (Bsz, n), torch.float32), "lo": (lo, (Bsz, n), torch.float32),
            "hi": (hi, (Bsz, n), torch.float32)}
    if warm is not None:
        basis0, vstat0, Binv0 = warm
        want.update({
            "basis0": (basis0, (Bsz, m), torch.int32),
            "vstat0": (vstat0, (Bsz, n), torch.int32),
            "Binv0": (Binv0, (Bsz, m, m), torch.float32),
        })
    for name, (t, shape, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(
                f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m > n:
        raise ValueError(f"need m <= n, got m={m}, n={n}")


def simplex_kernel_call(
    A, b, c, lo, hi, warm=None, *,
    slack0: int, max_iter: int, refactor_period: int, feas_tol: float,
    opt_tol: float, pivot_tol: float, bland_after: int,
    blocks: Optional[int] = None,
) -> torch.Tensor:
    """Run K1 on a batch of LPs; returns (B, m + n + 2) int32 rows
    ``[basis | vstat | status | niter]`` on the inputs' device.

    Inputs: A (B, m, n), b (B, m), c/lo/hi (B, n), all f32 and contiguous on
    one device; `warm` is None or ``(basis0 (B, m) i32, vstat0 (B, n) i32,
    Binv0 (B, m, m) f32)``.  CUDA tensors launch the kernel on the current
    stream (no synchronisation): a batch of one as one cooperative grid of
    `blocks` blocks, by default `default_blocks`, in clusters of the card's
    size (`blocks` 1, one block with no cluster, or a whole number of
    clusters), whose results do not depend on it (the card checks launch
    `blocks=1` to show that); a larger batch as one block per LP, which
    takes no `blocks` above 1.  A device that cannot take the grid raises.
    CPU tensors run `simplex_plain`.
    """
    return _launch(A, b, c, lo, hi, warm, slack0=slack0, max_iter=max_iter,
                   refactor_period=refactor_period, feas_tol=feas_tol,
                   opt_tol=opt_tol, pivot_tol=pivot_tol, bland_after=bland_after,
                   blocks=blocks)[0]


def _launch(A, b, c, lo, hi, warm=None, *, blocks: Optional[int] = None, **kw):
    """`simplex_kernel_call`'s work: returns (out, ws), with ws the kernel's
    workspace (None from the plain version), whose first m·m floats of each
    LP's share hold its final B⁻¹."""
    _check_inputs(A, b, c, lo, hi, warm)
    Bsz, m, n = A.shape
    spread = A.device.type == "cuda" and Bsz == 1 and blocks is not None and blocks > 1
    check_blocks(blocks, Bsz, grid_limits(A.device)[0] if spread else None)
    if A.device.type == "cpu":
        return simplex_plain(A, b, c, lo, hi, warm, **kw), None
    if A.device.type != "cuda":
        raise ValueError(f"K1 runs on CUDA (kernel) or CPU (plain), not {A.device}")
    if Bsz > 1:
        blocks = 1
    elif blocks is None:
        blocks = default_blocks(A.device, m, n)
    out, ws = raw_launch(_library(), A, b, c, lo, hi, warm, blocks=blocks, **kw)
    global launches, cluster_launches
    launches += 1
    cluster_launches += blocks > 1
    return out, ws


def raw_launch(lib, A, b, c, lo, hi, warm, *, blocks: int, slack0, max_iter,
               refactor_period, feas_tol, opt_tol, pivot_tol, bland_after):
    """One launch of the K1 library `lib` (this tree's, a diagnostic build's or
    another checkout's, bound by `_bind`) on checked CUDA inputs, on `blocks`
    blocks; returns (out, ws).  Counts no launch."""
    Bsz, m, n = A.shape
    out = torch.empty((Bsz, m + n + 2), dtype=torch.int32, device=A.device)
    ws = torch.empty(lib.batched_simplex_workspace_floats(Bsz, m, n),
                     dtype=torch.float32, device=A.device)
    ptr = lambda t: None if t is None else t.data_ptr()
    basis0, vstat0, Binv0 = warm if warm is not None else (None, None, None)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.batched_simplex_launch(
            ptr(A), ptr(b), ptr(c), ptr(lo), ptr(hi),
            ptr(basis0), ptr(vstat0), ptr(Binv0), ptr(out), ptr(ws),
            Bsz, m, n, slack0, max_iter, refactor_period, feas_tol, opt_tol, pivot_tol,
            bland_after, blocks, stream,
        )
    if err != 0:
        msg = lib.batched_simplex_error_string(err).decode()
        raise RuntimeError(f"batched_simplex kernel launch failed: {msg} ({err})")
    return out, ws


def simplex_plain(
    A, b, c, lo, hi, warm=None, *,
    slack0: int, max_iter: int, refactor_period: int, feas_tol: float,
    opt_tol: float, pivot_tol: float, bland_after: int, pack: int = 1,
) -> torch.Tensor:
    """Plain torch version of the kernel (any device), same inputs and
    output packing as `simplex_kernel_call`.

    A line-for-line transcription of the TPU kernel's loop body, batched:
    every LP steps in lockstep and an LP's state stops changing once its own
    loop condition fails (the semantics of a vmapped while loop).

    `pack > 1` is K3's rule (`packed_simplex.packed_plain`): consecutive
    groups of `pack` LPs share one refresh decision per iteration — any
    running member's phase-1 → 2 transition, any running member's forced
    exit check, or the group's largest pivot count (finished members
    included) a positive multiple of `refactor_period` refreshes every
    running member.  `pack=1` is K1's per-LP rule."""
    Bsz, m, n = A.shape
    dev, f32 = A.device, torch.float32
    i32 = lambda v: torch.full((Bsz,), int(v), dtype=torch.int32, device=dev)
    rows = torch.arange(m, device=dev)
    cols = torch.arange(n, device=dev)
    bidx = torch.arange(Bsz, device=dev)
    eye = torch.eye(m, dtype=f32, device=dev).expand(Bsz, m, m)
    AT_LOWER, AT_UPPER, FREE, FIXED, BASIC = (
        int(VarStat.AT_LOWER), int(VarStat.AT_UPPER), int(VarStat.FREE),
        int(VarStat.FIXED), int(VarStat.BASIC))

    if warm is not None:
        basis0, vstat0, Binv0 = warm
        basis = basis0.to(torch.int64)
        vstat = vstat0.clone()
        Binv = Binv0.clone()
    else:
        Binv = eye.clone()
        basis = (rows + slack0).expand(Bsz, m).clone()
        vstat = torch.where(
            torch.isfinite(lo), AT_LOWER,
            torch.where(torch.isfinite(hi), AT_UPPER, FREE)).to(torch.int32)
        vstat = torch.where(lo == hi, FIXED, vstat)
        is_slack = (cols >= slack0) & (cols < slack0 + m)
        vstat = torch.where(is_slack, BASIC, vstat).to(torch.int32)
    loB, hiB, cB = lo.gather(1, basis), hi.gather(1, basis), c.gather(1, basis)
    wts = torch.ones_like(c)

    def nonbasic_x(vstat):
        x = torch.where(vstat == AT_LOWER, lo, 0.0)
        x = torch.where(vstat == AT_UPPER, hi, x)
        return torch.where(vstat == FIXED, lo, x)

    def recompute(Binv, vstat, cB):
        rhs = b - (A @ nonbasic_x(vstat).unsqueeze(2)).squeeze(2)
        xB = (Binv @ rhs.unsqueeze(2)).squeeze(2)
        y = (cB.unsqueeze(1) @ Binv).squeeze(1)
        d = c - (y.unsqueeze(1) @ A).squeeze(1)
        return xB, torch.where(vstat == BASIC, 0.0, d)

    xB, d = recompute(Binv, vstat, cB)
    status, niter, phase = i32(Status.RUNNING), i32(0), i32(1)
    noimp, force = i32(0), i32(0)
    fresh = i32(0 if warm is not None else 1)
    best = torch.full((Bsz,), torch.inf, dtype=f32, device=dev)

    while True:
        active = (status == Status.RUNNING) & (niter < max_iter)
        if not bool(active.any()):
            break
        col = lambda v: v.unsqueeze(1)

        # -- refresh decision (transition, periodic, or exit-check), per
        #    group of `pack` LPs; a finished LP's state is never read again,
        #    so only running LPs refresh
        viol_pre = (xB < loB - feas_tol) | (xB > hiB + feas_tol)
        transition = (phase == 1) & ~viol_pre.any(1) & active
        phase_n = torch.where(transition, 2, phase)
        grp = lambda v: v.view(-1, pack)
        top = grp(niter).amax(1)
        do_refresh = active & (
            grp(transition).any(1) | grp((force == 1) & active).any(1)
            | ((top > 0) & (top % refactor_period == 0))).repeat_interleave(pack)
        Binv_c, xB_c, d_c = Binv, xB, d
        if bool(do_refresh.any()):
            Bmat = A.gather(2, basis.unsqueeze(1).expand(Bsz, m, m))
            X = Binv
            for _ in range(2):
                X = X + X @ (eye - Bmat @ X)
            xB_r, d_r = recompute(X, vstat, cB)
            Binv_c = torch.where(do_refresh.view(-1, 1, 1), X, Binv)
            xB_c = torch.where(col(do_refresh), xB_r, xB)
            d_c = torch.where(col(do_refresh), d_r, d)

        below = xB_c < loB - feas_tol
        above = xB_c > hiB + feas_tol
        sigma = torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(f32)
        viol = (torch.clamp(loB - xB_c, min=0.0) + torch.clamp(xB_c - hiB, min=0.0))
        infeas = viol.sum(1)
        p1 = phase_n == 1

        # -- phase-1 composite reduced costs; pricing (Dantzig / Devex; Bland)
        y1 = (sigma.unsqueeze(1) @ Binv_c).squeeze(1)
        d1 = -(y1.unsqueeze(1) @ A).squeeze(1)
        d1 = torch.where(vstat == BASIC, 0.0, d1)
        dcur = torch.where(col(p1), d1, d_c)
        bland = noimp >= bland_after
        can_up = (vstat == AT_LOWER) | (vstat == FREE)
        can_dn = (vstat == AT_UPPER) | (vstat == FREE)
        elig = (can_up & (dcur < -opt_tol)) | (can_dn & (dcur > opt_tol))
        gam = torch.where(col(p1), 1.0, wts)
        score = torch.where(elig, dcur * dcur / torch.clamp(gam, min=1e-3), -torch.inf)
        q_d = score.argmax(1)
        q_b = torch.where(elig, cols, n).amin(1)
        found = elig.any(1)
        q = torch.where(bland, q_b, q_d).clamp(max=n - 1)
        take = lambda v, idx: v.gather(1, col(idx)).squeeze(1)
        dq = take(dcur, q)
        s = torch.where(dq < 0, 1.0, -1.0).to(f32)

        # -- FTRAN and the ratio test (unified phase rule)
        Acol = A[bidx, :, q]
        w = (Binv_c @ Acol.unsqueeze(2)).squeeze(2)
        delta = -col(s) * w
        up = delta > pivot_tol
        dn = delta < -pivot_tol
        tgt = torch.where(up, torch.where(below, loB, hiB),
                          torch.where(dn, torch.where(above, hiB, loB), 0.0))
        blockable = ((up & ~above) | (dn & ~below)) & torch.isfinite(tgt)
        ratio = torch.where(
            blockable, (tgt - xB_c) / torch.where(up | dn, delta, 1.0), torch.inf)
        ratio = torch.clamp(ratio, min=0.0)
        t_rows = ratio.amin(1)
        tie = ratio <= col(t_rows * 1.0001 + 1e-6)
        r = torch.where(tie, w.abs(), -torch.inf).argmax(1)
        lo_q, hi_q = take(lo, q), take(hi, q)
        rng_q = hi_q - lo_q
        flip = rng_q <= t_rows
        unbounded = ~torch.isfinite(torch.minimum(t_rows, rng_q))
        t = torch.where(flip, rng_q, take(ratio, r))
        do_pivot = active & found & ~flip & ~unbounded
        do_flip = active & found & flip & ~unbounded

        # -- entering/leaving bookkeeping
        vq = take(vstat, q)
        enter_base = torch.where(
            (vq == AT_LOWER) | (vq == FIXED), lo_q,
            torch.where(vq == AT_UPPER, hi_q, 0.0))
        lv = take(basis, r)
        loB_r, hiB_r, tgt_r = take(loB, r), take(hiB, r), take(tgt, r)
        lstat = torch.where(loB_r == hiB_r, FIXED,
                            torch.where(tgt_r == hiB_r, AT_UPPER, AT_LOWER))
        is_q = cols == col(q)
        is_lv = cols == col(lv)
        is_r = rows == col(r)

        # bound flip
        xB_step = xB_c + col(t) * delta
        vstat_flip = torch.where(
            is_q, torch.where(vstat == AT_LOWER, AT_UPPER, AT_LOWER), vstat)

        # pivot: PFI rank-1 update + gathered-state updates
        wr = take(w, r)
        pr = Binv_c[bidx, r, :] / col(wr)
        Binv_piv = Binv_c - (w - is_r.to(f32)).unsqueeze(2) * pr.unsqueeze(1)
        x_enter = enter_base + s * t
        xB_piv = torch.where(is_r, col(x_enter), xB_step)
        basis_piv = torch.where(is_r, col(q), basis)
        vstat_piv = torch.where(is_lv, col(lstat), vstat)
        vstat_piv = torch.where(is_q, BASIC, vstat_piv).to(torch.int32)
        loB_piv = torch.where(is_r, col(lo_q), loB)
        hiB_piv = torch.where(is_r, col(hi_q), hiB)
        cB_piv = torch.where(is_r, col(take(c, q)), cB)
        # phase-2 incremental reduced costs (pivot row α = wr·(pr·A))
        alpha = (pr.unsqueeze(1) @ A).squeeze(1) * col(wr)
        rd = dq / wr
        d_piv = d_c - col(rd) * alpha
        d_piv = torch.where(is_q, 0.0, d_piv)
        d_piv = torch.where(is_lv, col(-rd), d_piv)
        d_piv = torch.where(vstat_piv == BASIC, 0.0, d_piv)
        # Devex reference-weight update
        gq = torch.clamp(take(wts, q), min=1.0)
        tcol = alpha / col(wr)
        w_cand = torch.maximum(wts, (tcol * tcol) * col(gq))
        w_cand = torch.where(is_lv, col(torch.clamp(gq / (wr * wr), min=1.0)), w_cand)
        w_cand = torch.where(is_q, 1.0, w_cand)
        w_cand = torch.where(col(gq > 1e6), 1.0, w_cand)

        # -- select + write back (only LPs still running change)
        piv, flp, upd2 = col(do_pivot), col(do_flip), col(do_pivot & ~p1)
        wts = torch.where(upd2, w_cand, wts)
        Binv = torch.where(do_pivot.view(-1, 1, 1), Binv_piv, Binv_c)
        xB = torch.where(piv, xB_piv, torch.where(flp, xB_step, xB_c))
        basis = torch.where(piv, basis_piv, basis)
        vstat = torch.where(piv, vstat_piv, torch.where(flp, vstat_flip, vstat))
        loB = torch.where(piv, loB_piv, loB)
        hiB = torch.where(piv, hiB_piv, hiB)
        cB = torch.where(piv, cB_piv, cB)
        d = torch.where(upd2, d_piv, d_c)

        # -- status transitions (terminal only from a fresh state)
        fresh_now = torch.where(do_refresh, 1, fresh)
        wants_exit = ~found | unbounded
        believe = fresh_now == 1
        status_n = torch.where(
            found,
            torch.where(unbounded & believe,
                        torch.where(p1, int(Status.NUMERICAL), int(Status.UNBOUNDED)),
                        status),
            torch.where(believe,
                        torch.where(p1, int(Status.INFEASIBLE), int(Status.OPTIMAL)),
                        status))
        force_n = (wants_exit & ~believe & (status_n == Status.RUNNING)).to(torch.int32)
        applied = found & ~unbounded
        fresh_n = torch.where(applied, 0, fresh_now)
        niter_n = niter + applied.to(torch.int32)
        # phase-1 stall counter
        improved = infeas < best - 1e-6
        noimp_n = torch.where(p1, torch.where(improved, 0, noimp + 1), 0)
        best_n = torch.where(p1, torch.minimum(best, infeas), best)

        keep = lambda new, old: torch.where(active, new, old).to(old.dtype)
        status, force, fresh = keep(status_n, status), keep(force_n, force), keep(fresh_n, fresh)
        niter, phase, noimp = keep(niter_n, niter), keep(phase_n, phase), keep(noimp_n, noimp)
        best = keep(best_n, best)

    status = torch.where(status == Status.RUNNING, int(Status.MAX_ITER), status)
    return torch.cat([basis.to(torch.int32), vstat.to(torch.int32),
                      status.unsqueeze(1), niter.unsqueeze(1)], dim=1).contiguous()


def upload(device, *arrays, dtype=np.float64) -> list:
    """Host arrays → C-ordered tensors of `dtype` on `device` (a B⁻¹ from the
    sparse LU's solve is Fortran-ordered)."""
    dev = torch.device(device)
    return [torch.tensor(np.ascontiguousarray(x, dtype=dtype), device=dev) for x in arrays]


def megakernel_rows(
    A, b, c, lo, hi,
    *,
    slack0: Optional[int] = None,
    max_iter: int = 2000,
    refactor_period: int = 32,
    feas_tol: float = 1e-5,
    opt_tol: float = 1e-6,
    pivot_tol: float = 1e-6,
    bland_after: int = 200,
    warm_state: Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]] = None,
) -> torch.Tensor:
    """One K1 call on the batch A (B, m, n), b (B, m), c/lo/hi (B, n), tensors
    on one device, cast to f32 there (round to nearest even: the bits of
    numpy's `astype(np.float32)`).  The identity slack block occupies columns
    [slack0, slack0+m) and forms the initial basis; `slack0=None` means the
    last m columns, while canonicalized problems pass `slack0=can.nv`.
    `warm_state=(basis0 (B, m), vstat0 (B, n), Binv0 (B, m, m))`, host
    arrays, starts each LP from that state instead of the slack basis.
    Returns the out rows (B, m + n + 2) int32 on that device."""
    m, n = A.shape[1], A.shape[2]
    f32 = [x.to(torch.float32).contiguous() for x in (A, b, c, lo, hi)]
    warm = None
    if warm_state is not None:
        basis0, vstat0, Binv0 = warm_state
        warm = (*upload(A.device, basis0, vstat0, dtype=np.int32),
                *upload(A.device, Binv0, dtype=np.float32))
    return simplex_kernel_call(
        *f32, warm, slack0=n - m if slack0 is None else slack0, max_iter=max_iter,
        refactor_period=refactor_period, feas_tol=feas_tol, opt_tol=opt_tol,
        pivot_tol=pivot_tol, bland_after=bland_after,
    )


def solve_batch_megakernel(A, b, c, lo, hi, *, device, **kernel_kwargs) -> BatchResult:
    """Solve B canonical LPs in one K1 call on `device`, every lane certified
    on the same device: the batch entry point (module docstring).

    Inputs: host arrays A (B, m, n), b (B, m), c/lo/hi (B, n), uploaded in
    f64; the kernel takes them cast to f32 on the device, the certificate
    (`certify.certify_out`) in f64.  `kernel_kwargs` are `megakernel_rows`'s.
    Returns exact f64 objectives and vertices recomputed from the discovered
    bases plus `verified` flags, after one device-to-host copy.
    """
    data = upload(device, A, b, c, lo, hi)
    out = megakernel_rows(*data, **kernel_kwargs)
    m, n = data[0].shape[1:]
    return BatchResult(*certify.host_fields(certify.certify_out(out, *data).cpu().numpy(), m, n))


def _verify_f64(A, b, c, lo, hi, basis, vstat, status):
    """Exact f64 vertex + optimality certificate from the f32 bases.

    Runs on the HOST in numpy: the basis is combinatorial, so the exact vertex
    is one batched f64 LU solve.  (Unchanged from the JAX package.)  The
    reference check: the batch entry points certify on the device
    (`certify.py`) and the single-LP routes through `engine/certificate.py`,
    and the tests hold both to it.
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    basis = np.asarray(basis)
    vstat = np.asarray(vstat)
    status = np.asarray(status)
    B, m, n = A.shape

    Bmat = np.take_along_axis(A, basis[:, None, :].repeat(m, axis=1), axis=2)
    xN = np.where(vstat == int(VarStat.AT_LOWER), lo, 0.0)
    xN = np.where(vstat == int(VarStat.AT_UPPER), hi, xN)
    xN = np.where(vstat == int(VarStat.FIXED), lo, xN)
    xN = np.where(vstat == int(VarStat.BASIC), 0.0, xN)
    rhs = b - np.einsum("bmn,bn->bm", A, xN)
    try:
        xB = np.linalg.solve(Bmat, rhs[..., None])[..., 0]
        yT = np.linalg.solve(
            np.swapaxes(Bmat, 1, 2),
            np.take_along_axis(c, basis, axis=1)[..., None],
        )[..., 0]
        singular = np.zeros(B, dtype=bool)
    except np.linalg.LinAlgError:
        xB = np.zeros((B, m))
        yT = np.zeros((B, m))
        singular = np.ones(B, dtype=bool)
    d = c - np.einsum("bm,bmn->bn", yT, A)
    loB = np.take_along_axis(lo, basis, axis=1)
    hiB = np.take_along_axis(hi, basis, axis=1)
    pfeas = ((xB >= loB - 1e-7) & (xB <= hiB + 1e-7)).all(axis=1)
    at_lo = vstat == int(VarStat.AT_LOWER)
    at_hi = vstat == int(VarStat.AT_UPPER)
    free = vstat == int(VarStat.FREE)
    dfeas = (
        np.where(at_lo, d >= -1e-7, True)
        & np.where(at_hi, d <= 1e-7, True)
        & np.where(free, np.abs(d) <= 1e-7, True)
    ).all(axis=1)
    obj = (np.take_along_axis(c, basis, axis=1) * xB).sum(axis=1) + (c * xN).sum(axis=1)
    ok = pfeas & dfeas & (status == int(Status.OPTIMAL)) & ~singular
    x = xN.copy()
    np.put_along_axis(x, basis, xB, axis=1)
    return obj, ok, x
