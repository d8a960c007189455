"""The plain reference solver: a primal-dual interior-point method
(Mehrotra's predictor-corrector) over the normal equations, in plain torch,
dense, batched over LPs of one standard shape.

It solves min c·x s.t. A x = b, 0 <= x <= u (u may be inf).  First each
LP loses the rows of A that depend on the others, since they would make
A Θ Aᵀ singular: only equality rows can (an inequality's slack column is
a unit vector), so a Householder QR of those rows with column pivoting
(geqp3's rule, in the dtype) finds them, as the pivots whose |R_ii| is at
most max(n, k) · eps of the largest.  A dependent row whose rhs agrees with
the combination of the others, within eps^(1/3) of 1 + their magnitudes,
is dropped; one that does not makes the LP infeasible, and no iteration
runs.  An LP with no dependent row is solved as it stands.  Each LP
keeps the iterate with the smallest merit, the largest of its relative
primal and dual residuals and duality gap; it is done when that merit is
under `tol` (eps^0.6 of the dtype), or when it can go no further: a step
is lost to rounding, the iterates diverge, the merit has not improved for
`STALL` iterations, or `max_iter` passes.  Where the Cholesky factor of
A Θ Aᵀ + eps·diag fails, as it can in a degenerate LP's last iterations,
that LP solves the normal equations through their eigenvectors, with the
eigenvalues under eps of the largest dropped.
An LP it could not finish is put to the elastic phase one, min Σ(t⁺ + t⁻)
s.t. A x + t⁺ − t⁻ = b: an optimum above eps^(1/3) (relative to b) proves
it infeasible, else its best iterate is its answer.  Every tolerance follows from the dtype, so that the same code in a
lower precision is the benchmark's control.  It imports nothing of
minilp_tpu_torch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .lp import EQ, RowLP, StandardLP, standard_form

OPTIMAL, INFEASIBLE = "optimal", "infeasible"
STALL = 8


@dataclasses.dataclass
class RefAnswer:
    status: str
    obj: float | None     # the row LP's objective at the answer
    x: np.ndarray | None  # the row LP's variables


def _eps(dtype) -> float:
    return float(torch.finfo(dtype).eps)


def _max_step(v, dv):
    """Per lane, the largest step in [0, 1] that keeps v + step·dv >= 0."""
    ratio = torch.where(dv < 0, -v / torch.where(dv < 0, dv, -1.0), torch.inf)
    return torch.clamp(ratio.amin(dim=1), max=1.0)


def ipm(A, b, c, u, *, max_iter: int = 100):
    """Batched solve of (B, m, n) standard LPs; returns (x, converged, merit)
    of each LP's best iterate."""
    dt = A.dtype
    eps = _eps(dt)
    tol = eps ** 0.6
    B, m, n = A.shape
    hasu = torch.isfinite(u)
    uf = torch.where(hasu, u, 0.0)
    x = torch.where(hasu, 0.5 * uf, 1.0)
    w = torch.where(hasu, uf - x, 1.0)
    z = torch.ones_like(x)
    v = hasu.to(dt)
    y = torch.zeros_like(b)
    nb = 1.0 + b.abs().amax(dim=1)
    nc = 1.0 + c.abs().amax(dim=1)
    nu = hasu.sum(dim=1).to(dt)
    active = torch.ones(B, dtype=torch.bool, device=A.device)
    converged = torch.zeros_like(active)
    best_x = x.clone()
    best = torch.full((B,), torch.inf, dtype=dt, device=A.device)
    stall = torch.zeros(B, dtype=torch.int64, device=A.device)
    At = A.transpose(1, 2)
    mv = lambda M, vec: torch.bmm(M, vec.unsqueeze(2)).squeeze(2)
    for _ in range(max_iter):
        rp = b - mv(A, x)
        ru = torch.where(hasu, uf - x - w, 0.0)
        rd = c - mv(At, y) - z + v
        xz, wv = x * z, torch.where(hasu, w * v, 0.0)
        mu = (xz.sum(1) + wv.sum(1)) / (n + nu)
        pres = torch.maximum(rp.abs().amax(1), ru.abs().amax(1)) / nb
        dres = rd.abs().amax(1) / nc
        pobj = (c * x).sum(1)
        dobj = (b * y).sum(1) - (uf * v).sum(1)
        gap = (pobj - dobj).abs() / (1.0 + pobj.abs())
        merit = torch.maximum(torch.maximum(pres, dres), gap)
        better = active & (merit < best)
        best_x = torch.where(better[:, None], x, best_x)
        best = torch.where(better, merit, best)
        stall = torch.where(better, 0, stall + 1)
        done = best < tol
        converged |= done & active
        active &= ~done & (stall < STALL)
        diverged = (x.abs().amax(1) > 1.0 / eps) | (y.abs().amax(1) > 1.0 / eps)
        active &= ~diverged & torch.isfinite(mu)
        if not bool(active.any()):
            break
        D = z / x + torch.where(hasu, v / w, 0.0)
        theta = 1.0 / D
        M = torch.bmm(A * theta.unsqueeze(1), At)
        M = M + torch.diag_embed(eps * M.diagonal(dim1=1, dim2=2))
        L, info = torch.linalg.cholesky_ex(M)
        # an LP whose factor fails (a degenerate LP's last iterations) solves
        # through M's eigenvectors instead, dropping eigenvalues under eps·max
        bad = torch.nonzero(active & (info != 0)).squeeze(1)
        if bad.numel():
            ev, V = torch.linalg.eigh(M[bad])
            inv = torch.where(ev > eps * ev.amax(1, keepdim=True), 1.0 / ev, 0.0)

        def solve_normal(r):
            out = torch.cholesky_solve(r.unsqueeze(2), L).squeeze(2)
            if bad.numel():
                out[bad] = mv(V, inv * mv(V.transpose(1, 2), r[bad]))
            return out

        def direction(r_xz, r_wv):
            rt = rd - r_xz / x + torch.where(hasu, (r_wv - v * ru) / w, 0.0)
            rhs = rp + mv(A, theta * rt)
            dy = torch.zeros_like(rhs)
            for _ref in range(3):  # the solve, then two steps of refinement
                dy = dy + solve_normal(rhs)
                dx = theta * (mv(At, dy) - rt)
                rhs = rp - mv(A, dx)
            dw = torch.where(hasu, ru - dx, 0.0)
            dz = (r_xz - z * dx) / x
            dv = torch.where(hasu, (r_wv - v * dw) / w, 0.0)
            return dx, dw, dy, dz, dv

        def steps(dx, dw, dz, dv):
            big_w = torch.where(hasu, w, 1.0)
            ap = torch.minimum(_max_step(x, dx), _max_step(big_w, dw))
            ad = torch.minimum(_max_step(z, dz), _max_step(torch.where(hasu, v, 1.0), dv))
            return ap, ad

        dx, dw, dy, dz, dv = direction(-xz, -wv)
        ap, ad = steps(dx, dw, dz, dv)
        mu_aff = (((x + ap[:, None] * dx) * (z + ad[:, None] * dz)).sum(1)
                  + torch.where(hasu, (w + ap[:, None] * dw) * (v + ad[:, None] * dv),
                                0.0).sum(1)) / (n + nu)
        sigma = (mu_aff / mu).clamp(0.0, 1.0) ** 3
        smu = (sigma * mu)[:, None]
        dx, dw, dy, dz, dv = direction(smu - xz - dx * dz,
                                       torch.where(hasu, smu - wv - dw * dv, 0.0))
        ap, ad = steps(dx, dw, dz, dv)
        ap = torch.where(active, 0.9995 * ap, 0.0)[:, None]
        ad = torch.where(active, 0.9995 * ad, 0.0)[:, None]
        nxt = [x + ap * dx, torch.where(hasu, w + ap * dw, w), y + ad * dy, z + ad * dz,
               torch.where(hasu, v + ad * dv, v)]
        ok = torch.stack([t.isfinite().all(1) for t in nxt]).all(0)
        active &= ok
        keep = ok[:, None]
        x, w, y, z, v = (torch.where(keep, new, old)
                         for new, old in zip(nxt, (x, w, y, z, v)))
    return best_x, converged, best


def _to(arrays, dtype, device):
    return [torch.as_tensor(np.stack(a), dtype=dtype, device=device) for a in arrays]


def _phase_one(group, dtype, device, max_iter):
    """The elastic phase one of each standard LP; returns its optimum over
    1 + |b|."""
    ext = []
    for s in group:
        m = s.A.shape[0]
        I = np.eye(m)
        ext.append((np.hstack([s.A, I, -I]), s.b,
                    np.concatenate([np.zeros_like(s.c), np.ones(2 * m)]),
                    np.concatenate([s.u, np.full(2 * m, np.inf)])))
    A, b, c, u = _to(list(zip(*ext)), dtype, device)
    x, _conv, _merit = ipm(A, b, c, u, max_iter=max_iter)
    p = (c * x).sum(1) / (1.0 + b.abs().amax(1))
    return p.double().cpu().numpy()


def _back(lp: RowLP, s: StandardLP, x: np.ndarray) -> np.ndarray:
    """The row LP's variables from the standard form's (the column order of
    `standard_form`)."""
    out = np.empty(lp.A.shape[1])
    k = 0
    for j in range(lp.A.shape[1]):
        lo, hi = lp.lo[j], lp.hi[j]
        if np.isfinite(lo) and lo == hi:
            out[j] = lo
        elif np.isfinite(lo):
            out[j] = lo + x[k]; k += 1
        elif np.isfinite(hi):
            out[j] = hi - x[k]; k += 1
        else:
            out[j] = x[k] - x[k + 1]; k += 2
    return out


def _pivoted_qr(M: np.ndarray):
    """R and the column order of M (n × k) by Householder QR with column
    pivoting, LAPACK geqp3's rule: each step takes the column of largest
    remaining norm.  |R|'s diagonal does not increase."""
    M = M.copy()
    n, k = M.shape
    piv = np.arange(k)
    for j in range(min(n, k)):
        p = j + int(np.argmax(np.einsum("ij,ij->j", M[j:, j:], M[j:, j:])))
        M[:, [j, p]] = M[:, [p, j]]
        piv[[j, p]] = piv[[p, j]]
        x = M[j:, j]
        nx = np.sqrt(x @ x)
        if nx == 0:  # every remaining column is zero
            break
        v = x.copy()
        v[0] += np.copysign(nx, x[0])
        v /= np.sqrt(v @ v)
        M[j:, j:] -= 2 * np.outer(v, v @ M[j:, j:])
    return np.triu(M[:min(n, k)]), piv


def independent_rows(s: StandardLP, eq: np.ndarray, dtype) -> StandardLP | None:
    """`s` without the rows `eq` marks (its equality rows) that depend on
    the others, computed in `dtype`; None where the rhs of such a row
    contradicts them (the LP is infeasible); `s` itself where no row
    depends on another."""
    rows = np.flatnonzero(eq)
    if rows.size == 0:
        return s
    eps = _eps(dtype)
    npdt = torch.empty(0, dtype=dtype).numpy().dtype
    E = s.A[rows].T
    E = E[E.any(axis=1)].astype(npdt)  # the columns these rows touch
    # E's R has E's column norms and pivots, and is small enough that the
    # pivoting loop costs little
    R, piv = _pivoted_qr(np.linalg.qr(E, mode="r"))
    d = np.abs(np.diag(R))
    r = int(np.sum(d > max(E.shape) * eps * (d[0] if d.size else 0.0)))
    if r == rows.size:
        return s
    # each dependent row is lam's combination of the independent ones
    lam = np.linalg.solve(R[:r, :r], R[:r, r:]) if r else np.zeros((0, rows.size), npdt)
    b = s.b[rows].astype(npdt)
    bi, bd = b[piv[:r]], b[piv[r:]]
    miss = np.abs(bd - lam.T @ bi)
    if np.any(miss > eps ** (1.0 / 3.0) * (1.0 + np.abs(bd) + np.abs(lam).T @ np.abs(bi))):
        return None
    keep = np.ones(s.A.shape[0], dtype=bool)
    keep[rows[piv[r:]]] = False
    return dataclasses.replace(s, A=s.A[keep], b=s.b[keep])


def solve(lps, *, dtype=torch.float64, device="cpu", max_iter: int = 100):
    """Reference answers (`RefAnswer`) of the row LPs `lps`, in `dtype` on
    `device`; LPs of one standard shape, once their dependent rows are
    dropped (`independent_rows`), are solved as one batch."""
    if dtype == torch.float32 and torch.device(device).type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    out: list[RefAnswer | None] = [None] * len(lps)
    std: list[StandardLP | None] = []
    groups: dict[tuple, list[int]] = {}
    for i, lp in enumerate(lps):
        s = independent_rows(standard_form(lp), lp.sense == EQ, dtype)
        std.append(s)
        if s is None:
            out[i] = RefAnswer(INFEASIBLE, None, None)
        else:
            groups.setdefault((s.A.shape, tuple(np.isfinite(s.u))), []).append(i)
    for idx in groups.values():
        group = [std[i] for i in idx]
        A, b, c, u = _to([[s.A for s in group], [s.b for s in group],
                          [s.c for s in group], [s.u for s in group]], dtype, device)
        x, conv, _merit = ipm(A, b, c, u, max_iter=max_iter)
        xs = x.double().cpu().numpy()
        conv = conv.cpu().numpy()
        unsure = [k for k in range(len(idx)) if not conv[k]]
        infeasible = set()
        if unsure:
            p = _phase_one([group[k] for k in unsure], dtype, device, max_iter)
            infeasible = {k for k, pk in zip(unsure, p) if pk > _eps(dtype) ** (1.0 / 3.0)}
        for k, i in enumerate(idx):
            if k in infeasible:
                out[i] = RefAnswer(INFEASIBLE, None, None)
                continue
            xr = _back(lps[i], group[k], xs[k])
            out[i] = RefAnswer(OPTIMAL, float(lps[i].c @ xr), xr)
    return out
