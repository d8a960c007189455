"""PDHG (PDLP-style) first-order engine, PyTorch port of
`minilp_tpu/engine/pdhg.py`.

Operates directly on the canonical equality form  min c·x  s.t.  Ax = b,
lo ≤ x ≤ hi  (free equality duals y):

    x⁺ = Π_[lo,hi](x − τ (c − Aᵀy))
    y⁺ = y + σ (b − A(2x⁺ − x))

with τ = ω/‖A‖₂, σ = 1/(ω‖A‖₂) (‖A‖₂ from power iteration).  Every operation
is a matvec or an elementwise pass: torch ops on the solve's device, with no
kernel of this repository underneath (the JAX package leaves the step to XLA
too; a fused Hopper step is later work, ROADMAP.md Queue 2).

The machinery is the reference's, decision for decision: Ruiz
equilibration (termination and reported quantities in the ORIGINAL space),
the adaptive primal weight ω (θ-smoothed refit at sufficient-decay
restarts; the halpern variant keeps ω frozen), the restarted-average
(vanilla) and reflected-anchored (halpern) schemes, β-factor and artificial
restarts, and the Farkas / recession-ray certificates.

The reference's `lax.while_loop` over windows becomes a Python loop: one
pass of the window body runs `pdhg_check_every` iterations, and the status
changes only at a window's end, so the host reads (status, niter) once per
window and at no other time.  Inside a window nothing is read back to the
host; every `jnp.where` is a `torch.where` on device tensors.

`solve_pdhg` takes a dense A; `solve_pdhg_sparse` a torch sparse CSR A
(the reference's BCOO), for which it builds Aᵀ as a CSR of its own, as the
reference builds its transposed BCOO.  `RowReduce` is the seam through which
a row-sharded loop (ROADMAP.md Queue 1 item 10) re-enters `_run_pdhg`.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..options import SolverOptions
from ..status import Status


class RowReduce(NamedTuple):
    """Reductions over the row (constraint) dimension of the problem.

    Single-device, every row-space vector is whole and the reductions are
    identities.  Under a row-sharded mesh each device holds a block of rows
    and these become an all-reduce sum / max over the devices — the only two
    collectives the distributed loop needs.
    """

    sum: Callable  # scalar partial-sum combiner
    max: Callable  # elementwise max combiner (column maxima)


#: identity reducer — the single-device / fully-replicated case
LOCAL_ROWS = RowReduce(sum=lambda s: s, max=lambda v: v)


def _norm(v):
    """‖v‖₂ as `jnp.linalg.norm` computes it for a real vector."""
    return torch.sqrt(torch.sum(v * v))


def _ynorm(v, rr: RowReduce):
    """‖v‖₂ of a (possibly row-sharded) row-space vector."""
    return torch.sqrt(rr.sum(torch.sum(v * v)))


def _ydot(u, v, rr: RowReduce):
    """u·v for (possibly row-sharded) row-space vectors."""
    return rr.sum(torch.sum(u * v))


class PdhgState(NamedTuple):
    x: torch.Tensor        # (N,) primal iterate (scaled space during the loop)
    y: torch.Tensor        # (M,) dual iterate (equality rows, free)
    x_sum: torch.Tensor    # (N,) running sum since last restart
    y_sum: torch.Tensor    # (M,)
    x_rst: torch.Tensor    # (N,) iterate adopted at the last restart
    y_rst: torch.Tensor    # (M,)
    omega: torch.Tensor    # () f — primal weight
    inner: torch.Tensor    # () f — iterations since last restart
    last_err: torch.Tensor  # () f — restart metric at the last restart
    niter: torch.Tensor    # () int32
    status: torch.Tensor   # () int32
    err: torch.Tensor      # () f — latest KKT error (of the returned iterate)


def _scalar(v, like: torch.Tensor, dtype=None) -> torch.Tensor:
    """A 0-d tensor on `like`'s device, in `dtype` (default: `like`'s)."""
    return torch.tensor(v, dtype=like.dtype if dtype is None else dtype,
                        device=like.device)


def _spectral_norm(A, AT, n, dtype, device, iters: int = 30) -> torch.Tensor:
    """‖A‖₂ by power iteration on AᵀA (deterministic start)."""
    v = torch.ones(n, dtype=dtype, device=device) / torch.sqrt(
        torch.tensor(n, dtype=dtype, device=device))
    for _ in range(iters):
        w = AT @ (A @ v)
        v = w / torch.clamp_min(_norm(w), 1e-30)
    return torch.sqrt(torch.clamp_min(_norm(AT @ (A @ v)), 1e-30))


def _ruiz_dense(A: torch.Tensor, iters: int, rr: RowReduce = LOCAL_ROWS):
    """Ruiz row/column equilibration scalings (d_r, d_c) for dense A.

    Returns positive vectors such that diag(d_r)·A·diag(d_c) has row and
    column max-norms ≈ 1.  Zero rows/columns (padding) keep scale 1.
    """
    M, N = A.shape
    dr = torch.ones(M, dtype=A.dtype, device=A.device)
    dc = torch.ones(N, dtype=A.dtype, device=A.device)
    absA = torch.abs(A)
    for _ in range(iters):
        As = absA * dr[:, None] * dc[None, :]
        rmax = torch.amax(As, dim=1)
        cmax = rr.max(torch.amax(As, dim=0))
        dr = dr / torch.sqrt(torch.where(rmax > 0, rmax, 1.0))
        dc = dc / torch.sqrt(torch.where(cmax > 0, cmax, 1.0))
    return dr, dc


def _csr_rows(A: torch.Tensor) -> torch.Tensor:
    """Row index of every stored entry of a CSR matrix."""
    crow = A.crow_indices()
    return torch.repeat_interleave(
        torch.arange(A.shape[0], device=crow.device), crow[1:] - crow[:-1])


def _ruiz_sparse(A: torch.Tensor, iters: int):
    """Ruiz scalings for a CSR matrix via scatter-max over its nonzeros (the
    reference's `_ruiz_bcoo`: an empty row or column keeps scale 1)."""
    M, N = A.shape
    data = A.values()
    rows, cols = _csr_rows(A), A.col_indices()
    absdata = torch.abs(data)
    dr = torch.ones(M, dtype=data.dtype, device=data.device)
    dc = torch.ones(N, dtype=data.dtype, device=data.device)
    for _ in range(iters):
        scaled = absdata * dr[rows] * dc[cols]
        # scaled ≥ 0, so the zero start is the max's identity here
        rmax = torch.zeros_like(dr).scatter_reduce(0, rows, scaled, "amax")
        cmax = torch.zeros_like(dc).scatter_reduce(0, cols, scaled, "amax")
        dr = dr / torch.sqrt(torch.where(rmax > 0, rmax, 1.0))
        dc = dc / torch.sqrt(torch.where(cmax > 0, cmax, 1.0))
    return dr, dc


def _kkt_error(Axs, ATys, xs, ys, b, c, lo, hi, dr, dc, scale_b, scale_c,
               feas_tol, rr: RowReduce = LOCAL_ROWS):
    """Relative KKT error in the ORIGINAL space from scaled-space quantities
    (the scaled matvec results A'x', A'ᵀy' and scaled iterates; elementwise
    unscaling recovers the original-space values)."""
    x = dc * xs
    r_vec = (Axs - b) / dr          # original A x − b   (b here is scaled b')
    r_p = _ynorm(r_vec, rr) / scale_b
    red = (c - ATys) / dc           # original c − Aᵀy   (c here is scaled c')
    lo_o = lo * dc                  # original bounds (lo/hi args are scaled)
    hi_o = hi * dc
    at_lo = x <= lo_o + feas_tol
    at_hi = x >= hi_o - feas_tol
    viol = torch.where(at_lo, torch.clamp_max(red, 0.0), red)
    viol = torch.where(at_hi & ~at_lo, torch.clamp_min(red, 0.0), viol)
    viol = torch.where(at_lo & at_hi, 0.0, viol)  # fixed vars: any sign ok
    r_d = _norm(viol) / scale_c
    # duality gap: dual objective b·y + Σ_j inf over box of red_j·x_j
    lo_f = torch.where(torch.isfinite(lo_o), lo_o, 0.0)
    hi_f = torch.where(torch.isfinite(hi_o), hi_o, 0.0)
    contrib = torch.where(red > 0, red * lo_f, red * hi_f)
    dobj = _ydot(b, ys, rr) + torch.sum(contrib)  # bᵀy = b'ᵀy' (scaled pairing)
    pobj = c @ xs                             # cᵀx = c'ᵀx'
    gap = torch.abs(pobj - dobj) / (1.0 + torch.abs(pobj) + torch.abs(dobj))
    return torch.maximum(torch.maximum(r_p, r_d), gap)


def _certificates(A, AT, dx_s, dy_s, b, c, lo, hi, dr, dc, tol,
                  rr: RowReduce = LOCAL_ROWS):
    """Farkas / recession-ray tests on the (scaled-space) displacement.

    Returns (primal_infeasible, unbounded) as 0-d bool tensors.  Every
    quantity is mapped to the original space and the candidate rays are
    unit-normalized, so every threshold is scale-free (the reference's
    `_certificates`, test for test).
    """
    # --- dual (Farkas) ray → primal infeasibility -----------------------------
    y_norm = _ynorm(dy_s * dr, rr)  # ‖y‖ in original space
    y_unit = torch.where(y_norm > 0, dy_s / torch.clamp_min(y_norm, 1e-30), 0.0)
    q = (AT @ y_unit) / dc               # original Aᵀŷ
    lo_o = lo * dc
    hi_o = hi * dc
    fin_lo = torch.isfinite(lo_o)
    fin_hi = torch.isfinite(hi_o)
    cone = torch.where(~fin_hi, torch.clamp_min(q, 0.0), 0.0) + torch.where(
        ~fin_lo, torch.clamp_min(-q, 0.0), 0.0
    )
    cone_ok = torch.amax(cone) <= tol
    qt = torch.where(~fin_hi, torch.clamp_max(q, 0.0), q)
    qt = torch.where(~fin_lo, torch.clamp_min(qt, 0.0), qt)
    lo_f = torch.where(fin_lo, lo_o, 0.0)
    hi_f = torch.where(fin_hi, hi_o, 0.0)
    s = torch.where(
        fin_lo & fin_hi,
        torch.maximum(qt * lo_f, qt * hi_f),
        torch.where(fin_lo, qt * lo_f, torch.where(fin_hi, qt * hi_f, 0.0)),
    )
    support = torch.sum(s)
    by = _ydot(b / dr, y_unit, rr)       # original bᵀŷ (b arg is scaled b')
    margin_ok = (by - support) > 1e2 * tol * (
        1.0 + torch.abs(by) + torch.abs(support))
    primal_infeas = cone_ok & margin_ok & (y_norm > 0)

    # --- primal recession ray → unboundedness ---------------------------------
    dx_norm = _norm(dx_s * dc)
    dx_unit = torch.where(dx_norm > 0, dx_s / torch.clamp_min(dx_norm, 1e-30), 0.0)
    Adx = (A @ dx_unit) / dr             # original A·d̂x
    dxo = dx_unit * dc
    rec_viol = torch.where(fin_lo & fin_hi, torch.abs(dxo), 0.0)
    rec_viol = rec_viol + torch.where(
        fin_lo & ~fin_hi, torch.clamp_min(-dxo, 0.0), 0.0
    )
    rec_viol = rec_viol + torch.where(
        ~fin_lo & fin_hi, torch.clamp_min(dxo, 0.0), 0.0
    )
    ray_ok = (_ynorm(Adx, rr) <= tol) & (torch.amax(rec_viol) <= tol)
    descent = (c / dc) @ dx_unit < -1e2 * tol * (1.0 + _norm(c / dc))
    unbounded = ray_ok & descent & (dx_norm > 0)
    return primal_infeas, unbounded


def _run_pdhg(A, AT, b, c, lo, hi, dr, dc, opts: SolverOptions, omega0,
              rr: RowReduce = LOCAL_ROWS, state0: "PdhgState | None" = None,
              stop_at=None) -> PdhgState:
    """The restarted-average adaptive-weight PDHG loop (scaled space).

    `A`/`AT` may be dense tensors or CSR matrices — only `@` is used.
    Returns a PdhgState whose x, y are in the ORIGINAL space.  `state0`
    (original space, as a previous call returned it) re-enters warm, and
    `stop_at` caps the iterations of this call (a capped call exits
    MAX_ITER, which the next warm entry turns back into RUNNING).
    """
    M, N = b.shape[0], c.shape[0]
    dtype, device = b.dtype, b.device
    norm_a = _spectral_norm(A, AT, N, dtype, device)
    scale_b = 1.0 + _ynorm(b / dr, rr)
    scale_c = 1.0 + _norm(c / dc)
    tol = opts.feas_tol
    cert_tol = opts.pdhg_infeas_tol
    every = opts.pdhg_check_every

    lo_c = torch.where(torch.isfinite(lo), lo, -1e30)
    hi_c = torch.where(torch.isfinite(hi), hi, 1e30)
    x0 = torch.clamp(torch.zeros(N, dtype=dtype, device=device), lo_c, hi_c)
    y0 = torch.zeros(M, dtype=dtype, device=device)

    halpern = opts.pdhg_variant == "halpern"
    if opts.pdhg_variant not in ("halpern", "vanilla"):
        raise ValueError(f"unknown pdhg_variant {opts.pdhg_variant!r}")
    optimal = int(Status.OPTIMAL)

    def step(x, y, tau, sig):
        """One plain PDHG step T(z): (x̃, ỹ, 2x̃ − x)."""
        x_t = torch.clamp(x - tau * (c - AT @ y), lo_c, hi_c)
        x_r = 2.0 * x_t - x
        return x_t, y + sig * (b - A @ x_r), x_r

    def body(st: PdhgState) -> PdhgState:
        tau = st.omega / norm_a
        sig = 1.0 / (st.omega * norm_a)
        x, y = st.x, st.y
        if halpern:
            # reflected PDHG + Halpern anchoring (cuPDLP-class scheme): z̃ =
            # T(z), reflect 2z̃ − z, pull toward the anchor (the last
            # restart point) with weight 1/(k+2)
            k = st.inner
            for _ in range(every):
                x_t, y_t, x_r = step(x, y, tau, sig)
                lam = 1.0 / (k + 2.0)
                x, y = (lam * st.x_rst + (1.0 - lam) * x_r,
                        lam * st.y_rst + (1.0 - lam) * (2.0 * y_t - y))
                k = k + 1.0
            xs, ys = st.x_sum, st.y_sum  # unused by this variant (stay zero)
        else:
            # PDLP restarted-average scheme
            xs, ys = st.x_sum, st.y_sum
            for _ in range(every):
                x, y, _x_r = step(x, y, tau, sig)
                xs, ys = xs + x, ys + y
        inner_cnt = st.inner + every
        niter = st.niter + every

        # -- candidate iterates ----------------------------------------------
        err_cur = _kkt_error(A @ x, AT @ y, x, y, b, c, lo, hi, dr, dc,
                             scale_b, scale_c, tol, rr)
        if halpern:
            # the current iterate; the "average displacement" certificate
            # below uses (current − anchor)
            x_avg, y_avg = x, y
            err_best = err_cur
            x_best, y_best = x, y
        else:
            x_avg = xs / inner_cnt
            y_avg = ys / inner_cnt
            err_avg = _kkt_error(A @ x_avg, AT @ y_avg, x_avg, y_avg, b, c,
                                 lo, hi, dr, dc, scale_b, scale_c, tol, rr)
            use_avg = err_avg < err_cur
            err_best = torch.minimum(err_avg, err_cur)
            x_best = torch.where(use_avg, x_avg, x)
            y_best = torch.where(use_avg, y_avg, y)

        done = err_best <= tol

        # -- infeasibility / unboundedness certificates: the one-step
        # difference and the average displacement since the last restart
        x_one, y_one, _x_r = step(x, y, tau, sig)
        p_inf1, unb1 = _certificates(
            A, AT, x_one - x, y_one - y, b, c, lo, hi, dr, dc, cert_tol, rr
        )
        p_inf2, unb2 = _certificates(
            A, AT, x_avg - st.x_rst, y_avg - st.y_rst, b, c, lo, hi, dr, dc,
            cert_tol, rr
        )
        p_inf = p_inf1 | p_inf2
        unb = unb1 | unb2
        # trust a ray only once the window is long enough, never after
        # convergence
        settled = (inner_cnt >= 4.0 * every) & ~done

        # -- β-factor restart on the restart METRIC (vanilla: the KKT error;
        # halpern: the fixed-point residual ‖T(z)−z‖), backstopped by the
        # artificial rule (window ≥ 36% of all iterations so far)
        if halpern:
            metric = torch.sqrt(
                torch.sum((x_one - x) ** 2)
                + rr.sum(torch.sum((y_one - y) ** 2))
            )
        else:
            metric = err_best
        artificial = inner_cnt >= 0.36 * niter.to(dtype)
        decay_restart = done | (metric <= opts.pdhg_restart_beta * st.last_err)
        restart = decay_restart | artificial
        # adaptive primal weight at sufficient-decay restarts (PDLP
        # θ-smoothing); halpern runs with a frozen ω (θ = 0)
        d_x = _norm((x_best - st.x_rst) * dc)
        d_y = _ynorm((y_best - st.y_rst) * dr, rr)
        can_fit = (d_x > 1e-12) & (d_y > 1e-12)
        th = 0.0 if halpern else opts.pdhg_weight_theta
        om_fit = torch.exp(
            th * torch.log(torch.clamp_min(d_y, 1e-30) / torch.clamp_min(d_x, 1e-30))
            + (1.0 - th) * torch.log(st.omega)
        )
        om_new = torch.where(decay_restart & can_fit, om_fit, st.omega)
        om_new = torch.clamp(om_new, 1e-6, 1e6)

        status = torch.where(done, optimal, st.status)
        status = torch.where(settled & p_inf, int(Status.INFEASIBLE), status)
        status = torch.where(settled & unb & ~p_inf, int(Status.UNBOUNDED), status)
        return PdhgState(
            x=torch.where(restart, x_best, x),
            y=torch.where(restart, y_best, y),
            x_sum=torch.where(restart, torch.zeros_like(xs), xs),
            y_sum=torch.where(restart, torch.zeros_like(ys), ys),
            x_rst=torch.where(restart, x_best, st.x_rst),
            y_rst=torch.where(restart, y_best, st.y_rst),
            omega=om_new, inner=torch.where(restart, 0.0, inner_cnt),
            last_err=torch.where(restart, metric, st.last_err),
            niter=niter, status=status, err=err_best,
        )

    i32 = torch.int32
    if state0 is None:
        st = PdhgState(
            x=x0, y=y0, x_sum=torch.zeros_like(x0), y_sum=torch.zeros_like(y0),
            x_rst=x0, y_rst=y0,
            omega=torch.as_tensor(omega0, dtype=dtype, device=device),
            inner=_scalar(0.0, b),
            last_err=_scalar(float("inf"), b),
            niter=_scalar(0, b, i32),
            status=_scalar(int(Status.RUNNING), b, i32),
            err=_scalar(float("inf"), b),
        )
    else:
        # warm re-entry: the handed-in iterates are in the ORIGINAL space,
        # x_sum / y_sum stayed scaled; a capped launch's MAX_ITER re-enters
        # RUNNING
        st = state0._replace(
            x=state0.x / dc, y=state0.y / dr,
            x_rst=state0.x_rst / dc, y_rst=state0.y_rst / dr,
            status=torch.where(state0.status == int(Status.MAX_ITER),
                               int(Status.RUNNING), state0.status),
        )
    hard_stop = (opts.pdhg_max_iter if stop_at is None
                 else min(int(stop_at), opts.pdhg_max_iter))
    while True:
        status, niter = torch.stack([st.status, st.niter]).tolist()  # one read a window
        if status != int(Status.RUNNING) or niter >= hard_stop:
            break
        st = body(st)
    st = st._replace(status=torch.where(st.status == int(Status.RUNNING),
                                        int(Status.MAX_ITER), st.status))
    # unscale the reported iterates back to the original space
    return st._replace(x=st.x * dc, y=st.y * dr, x_rst=st.x_rst * dc,
                       y_rst=st.y_rst * dr)


def _omega0(b, c, dr, dc, opts: SolverOptions, rr: RowReduce = LOCAL_ROWS):
    if opts.pdhg_omega is not None:
        return _scalar(float(opts.pdhg_omega), b)
    nb = _ynorm(b / dr, rr)
    nc = _norm(c / dc)
    ok = (nb > 1e-12) & (nc > 1e-12)
    return torch.where(ok, nc / torch.clamp_min(nb, 1e-30), 1.0)


def solve_pdhg(
    A: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    opts: SolverOptions,
    state0: "PdhgState | None" = None,
    stop_at=None,
) -> PdhgState:
    """Dense-path PDHG: Ruiz-equilibrate, then run to relative KKT ≤ feas_tol.

    Every tensor lies on the solve's device; x/y in the returned state are
    original-space.  When `A` arrives in a narrower dtype than the vectors
    (bfloat16 A with f32 b/c — the device stage's first phase), the scaled
    matrix is rounded to that dtype once, as the reference rounds it, and
    kept as a tensor of the vectors' dtype: the products are bf16-rounded
    entries times f32 vectors in f32 arithmetic, which is what the
    reference's mixed contraction computes (it does not save A's bytes
    here; ROADMAP.md Queue 2).
    """
    vdtype = b.dtype
    Af = A.to(vdtype)
    dr, dc = _ruiz_dense(Af, opts.pdhg_ruiz_iters)
    As = (Af * dr[:, None] * dc[None, :]).to(A.dtype).to(vdtype)
    bs = b * dr
    cs = c * dc
    los = lo / dc
    his = hi / dc
    om0 = _omega0(bs, cs, dr, dc, opts)
    return _run_pdhg(As, As.T, bs, cs, los, his, dr, dc, opts, om0,
                     state0=state0, stop_at=stop_at)


def csr_transpose(crow, col, data, shape):
    """(crow, col, data) of Aᵀ for a CSR A of `shape` (entries of a row of Aᵀ
    in ascending column order)."""
    M, N = shape
    rows = torch.repeat_interleave(
        torch.arange(M, dtype=col.dtype, device=crow.device), crow[1:] - crow[:-1])
    order = torch.argsort(col * M + rows)
    t_crow = torch.zeros(N + 1, dtype=crow.dtype, device=crow.device)
    t_crow[1:] = torch.cumsum(torch.bincount(col, minlength=N), 0)
    return t_crow, rows[order], data[order]


def solve_pdhg_sparse(
    A: torch.Tensor,
    b: torch.Tensor,
    c: torch.Tensor,
    lo: torch.Tensor,
    hi: torch.Tensor,
    opts: SolverOptions,
    state0: "PdhgState | None" = None,
    stop_at=None,
) -> PdhgState:
    """Sparse-path PDHG over a torch sparse CSR constraint matrix.

    The loop only needs `A @ x` and `Aᵀ @ y`; as CSR products the device
    holds O(nnz) instead of O(M·N) — the path for very large sparse
    instances.  The driver picks it by density.
    """
    dr, dc = _ruiz_sparse(A, opts.pdhg_ruiz_iters)
    crow, col = A.crow_indices(), A.col_indices()
    data_s = A.values() * dr[_csr_rows(A)] * dc[col]
    As = torch.sparse_csr_tensor(crow, col, data_s, size=A.shape)
    t_crow, t_col, t_data = csr_transpose(crow, col, data_s, A.shape)
    ATs = torch.sparse_csr_tensor(t_crow, t_col, t_data,
                                  size=(A.shape[1], A.shape[0]))
    bs = b * dr
    cs = c * dc
    los = lo / dc
    his = hi / dc
    om0 = _omega0(bs, cs, dr, dc, opts)
    return _run_pdhg(As, ATs, bs, cs, los, his, dr, dc, opts, om0,
                     state0=state0, stop_at=stop_at)
