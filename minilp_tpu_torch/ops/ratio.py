"""Ratio test: choose the leaving row (or a bound flip, or detect unboundedness).

PyTorch port of `minilp_tpu.ops.ratio`; the semantics are the JAX package's,
line for line (reference analog: `choose_leaving_row`, `src/solver.rs` [CODE];
SURVEY.md §3.2 "Ratio test"):
  * Bounded-variable rules: the entering variable moving by t ≥ 0 in direction
    s changes basic values by t·δ with δ = −s·w (w = FTRAN'd column).  A basic
    row blocks at the bound it approaches; the entering variable itself blocks
    at its opposite bound (a *bound flip*).
  * Phase-1 extension: a basic variable that is currently infeasible blocks at
    the violated bound it is moving *toward*, plus the long-step walk over the
    sorted breakpoints of the piecewise-linear phase-1 objective.
  * Pivot-magnitude guard: rows with |δ| ≤ pivot_tol never block.
  * Harris two-pass tie-breaking: among rows admissible under the relaxed
    step, the largest |w_r|; under Bland's rule, the lowest basic index.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class RatioResult(NamedTuple):
    flip: bool        # entering variable flips to opposite bound
    unbounded: bool   # nothing blocks: ray of descent
    r: int            # leaving row (valid when not flip/unbounded)
    t: torch.Tensor   # () f — step length
    tgt_r: torch.Tensor  # () f — bound value the leaving variable lands on


def ratio_test(
    w: torch.Tensor,
    s: float,
    xB: torch.Tensor,
    loB: torch.Tensor,
    hiB: torch.Tensor,
    rng_q: torch.Tensor,
    basis: torch.Tensor,
    bland: bool,
    *,
    phase1: bool,
    pivot_tol: float,
    feas_tol: float,
    tie_rel: float,
    tie_abs: float,
) -> RatioResult:
    M = w.shape[0]
    dtype, dev = w.dtype, w.device
    inf = torch.tensor(torch.inf, dtype=dtype, device=dev)
    delta = -s * w
    up = delta > pivot_tol
    dn = delta < -pivot_tol

    if phase1:
        below = xB < loB - feas_tol
        above = xB > hiB + feas_tol
        up_tgt = torch.where(below, loB, hiB)
        dn_tgt = torch.where(above, hiB, loB)
        up_ok = ~above
        dn_ok = ~below
    else:
        up_tgt = hiB
        dn_tgt = loB
        up_ok = dn_ok = torch.ones_like(up)

    tgt = torch.where(up, up_tgt, torch.where(dn, dn_tgt, 0.0))
    blockable = ((up & up_ok) | (dn & dn_ok)) & torch.isfinite(tgt)
    safe_delta = torch.where(up | dn, delta, 1.0)
    ratio = torch.where(blockable, (tgt - xB) / safe_delta, inf)
    ratio = torch.clamp(ratio, min=0.0)  # drift guard: degenerate rather than negative

    t_rows = ratio.min()

    if phase1:
        # long-step extension (inert when the basis is feasible); see the JAX
        # package's ops/ratio.py for the derivation
        sigma = torch.where(below, -1.0, torch.where(above, 1.0, 0.0)).to(dtype)
        slope0 = (sigma * delta).sum()
        e1_ok = (up & below) | (dn & above)
        e1_tgt = torch.where(up, loB, hiB)
        e1_w = torch.abs(torch.where(e1_ok, delta, 0.0))
        e1_t = torch.where(
            e1_ok, torch.clamp((e1_tgt - xB) / safe_delta, min=0.0), inf
        )
        e2_ok = ((up & ~above & torch.isfinite(hiB))
                 | (dn & ~below & torch.isfinite(loB)))
        e2_tgt = torch.where(up, hiB, loB)
        e2_w = torch.abs(torch.where(e2_ok, delta, 0.0))
        e2_t = torch.where(
            e2_ok, torch.clamp((e2_tgt - xB) / safe_delta, min=0.0), inf
        )
        ev_t = torch.cat([e1_t, e2_t])
        ev_w = torch.cat([e1_w, e2_w])
        ev_tgt = torch.cat([e1_tgt, e2_tgt])
        rows = torch.arange(M, device=dev)
        ev_row = torch.cat([rows, rows])
        order = torch.argsort(ev_t, stable=True)
        csl = slope0 + torch.cumsum(ev_w[order], 0)
        crossed = (csl >= 0.0) & torch.isfinite(ev_t[order])
        k = int(torch.argmax(crossed.to(torch.int8)))
        neg_slope = bool(slope0 < 0.0)
        has_cross = neg_slope and bool(crossed.any())
        sel = order[k]
        use_ls = has_cross and not bland
        t_ls = ev_t[sel]
        r_ls = int(ev_row[sel])
        tgt_ls = ev_tgt[sel]
        if neg_slope and not bland:
            t_rows = t_ls if has_cross else inf

    # Harris two-pass: pass 1 the maximal step under bounds relaxed by the
    # feasibility tolerance, pass 2 the largest |pivot| among rows whose
    # strict ratio fits under it.
    relaxed = torch.where(
        blockable, (tgt - xB + torch.sign(delta) * feas_tol) / safe_delta, inf
    )
    t_relaxed = torch.clamp(relaxed.min(), min=0.0)

    tie = (ratio <= t_relaxed) | (ratio <= t_rows * (1.0 + tie_rel) + tie_abs)
    if bland:
        big = torch.iinfo(torch.int32).max
        r = int(torch.argmin(torch.where(tie, basis, big)))
    else:
        r = int(torch.argmax(torch.where(tie, torch.abs(w), -inf)))

    flip = bool(rng_q <= t_rows)  # prefer the (cheaper) flip on exact ties
    unbounded = not bool(torch.isfinite(torch.minimum(t_rows, rng_q)))
    t = rng_q if flip else ratio[r]
    tgt_r = tgt[r]
    if phase1 and use_ls:
        # long-step override: the leaving row/step/landing bound come from
        # the slope-crossing event (a below-row can cross THROUGH lo and
        # leave at hi, which tgt[r] cannot express)
        r = r_ls
        t = rng_q if flip else t_ls
        tgt_r = tgt_ls
    return RatioResult(flip=flip and not unbounded, unbounded=unbounded, r=r,
                       t=t, tgt_r=tgt_r)
