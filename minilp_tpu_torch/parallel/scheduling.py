"""Heterogeneous-batch scheduling: size bucketing + difficulty-sorted packing.

PyTorch port of `minilp_tpu/parallel/scheduling.py` (numpy and scipy,
carried over); the packed batches go through the port's K3
(`ops/kernels/packed_simplex.solve_batch_packed`) on an explicit `device`.

This is the EP-analog row of SURVEY.md §3.3 ("heterogeneous batch scheduling —
group scenario LPs by size/iteration count across chips to avoid stragglers").
The reference (`ztlpn/minilp`) has no batching at all; these are build-only
components shaped by how the pack-k megakernel executes:

* **Lockstep stragglers.** `ops/kernels/packed_simplex.py` runs k LPs per
  thread block; a pack costs max(iter over its k members).  With random packing the
  expected pack cost is E[max of k] ≈ 1.3–1.6× E[iter]; packing LPs of
  *similar* expected iteration count pushes that toward 1× (the classic
  longest-processing-time batching argument).  `sort_for_packing` orders the
  batch by a cheap a-priori difficulty score so consecutive pack-mates are
  similar; results are un-permuted before returning.
* **Shape buckets.** The kernels are fixed-shape; a workload of LPs with
  different (m, nv) must be padded.  Padding every LP to the global max wastes
  fast memory and iteration work quadratically (each basis inverse is M²), so
  `solve_heterogeneous` groups LPs into (M, NV) *tier buckets* (rows and
  columns to caller-set granules), pads only within the
  bucket using the inert-padding scheme of `canonical.py` (padding rows carry
  a fixed [0,0] slack basic at 0; padding columns are fixed [0,0] — provably
  never active), and solves each bucket as one packed batch.

Both entry points keep the certification contract of the batched drivers
(`parallel.batched.resolve_unverified_host`): f32 kernel iterate, exact f64
verification of every lane on the kernel's device (`ops/kernels/certify.py`),
scipy-HiGHS re-solve on the host of the rare uncertified lanes — callers
always get exact, certified answers in the ORIGINAL input order and column
layout.
"""

from __future__ import annotations

from typing import List, NamedTuple, Sequence, Tuple

import numpy as np


class LPResult(NamedTuple):
    """Per-LP certified answer in the LP's own column layout."""

    obj: float
    x: np.ndarray        # (n,) f64
    status: int
    niter: int
    verified: bool


def _split_slack(A, b, c, lo, hi, slack0):
    """Structural column count for layout [structural | identity slack | pad].

    Padding columns beyond slack0+m (inert FIXED [0,0] columns, e.g. from
    `batched._assemble`'s padding to n) are accepted when `slack0` is given
    explicitly; with slack0=None the layout must be exactly [structural |
    slack] (nothing to infer the pad width from).
    """
    m, n = A.shape
    if slack0 is None:
        slack0 = n - m
    if n < slack0 + m:
        raise ValueError(
            f"expected layout [structural | identity slack | pad]: n={n}, "
            f"slack0={slack0}, m={m}"
        )
    return int(slack0)


def difficulty_scores(A, b, c, lo, hi, *, slack0=None, tol: float = 1e-9):
    """Cheap a-priori per-LP difficulty proxy for a batch (B, m, n).

    Iteration count of the two-phase simplex correlates with (a) how many
    initial basic (slack) values violate their bounds — each costs phase-1
    pivots — and (b) how many nonbasic columns price attractively at the
    initial point — an upper envelope on distinct phase-2 entering columns.
    Both are one vectorized pass over the batch (no solves):

      score = 2·#infeasible_rows + #attractive_cols

    The constant 2 reflects that phase-1 pivots also re-lengthen phase 2.
    Any monotone proxy works — the scheduler only needs *similar* LPs to sort
    near each other; exactness is irrelevant to correctness (tests assert the
    sorted solve is lane-for-lane identical to the unsorted one).
    """
    A = np.asarray(A, dtype=np.float64)
    b = np.asarray(b, dtype=np.float64)
    c = np.asarray(c, dtype=np.float64)
    lo = np.asarray(lo, dtype=np.float64)
    hi = np.asarray(hi, dtype=np.float64)
    B, m, n = A.shape
    s0 = _split_slack(A[0], b[0], c[0], lo[0], hi[0], slack0)

    loS, hiS = lo[:, :s0], hi[:, :s0]
    # initial nonbasic values: nearest finite bound (AT_LOWER preferred), the
    # same rule the engine uses (status.initial_vstat)
    xN = np.where(np.isfinite(loS), loS, np.where(np.isfinite(hiS), hiS, 0.0))
    xB = b - np.einsum("bmn,bn->bm", A[:, :, :s0], xN)
    loB, hiB = lo[:, s0:s0 + m], hi[:, s0:s0 + m]
    infeas = ((xB < loB - tol) | (xB > hiB + tol)).sum(axis=1)

    # reduced costs at the all-slack basis with zero slack costs are just the
    # structural objective; count columns that price attractively
    cS = c[:, :s0]
    at_lo = np.isfinite(loS)
    at_hi = ~at_lo & np.isfinite(hiS)
    free = ~at_lo & ~at_hi
    attractive = (
        (at_lo & (cS < -tol)) | (at_hi & (cS > tol)) | (free & (np.abs(cS) > tol))
    ).sum(axis=1)
    return (2 * infeas + attractive).astype(np.int64)


def sort_for_packing(scores) -> np.ndarray:
    """Stable order grouping similar-difficulty LPs into adjacent pack slots."""
    return np.argsort(np.asarray(scores), kind="stable")


def solve_batch_packed_sorted(
    A, b, c, lo, hi, *, device="cuda", pack: int = 8, slack0=None,
    scores=None, **kernel_kwargs,
):
    """`solve_batch_packed` with difficulty-sorted pack assignment.

    Sorts the batch by `difficulty_scores` (or a caller-supplied `scores`
    array), solves packs of similar LPs (so no pack idles on one straggler),
    and returns results un-permuted — the output is positionally identical
    to the unsorted call.

    Measured with the JAX package (random dense LPs, m=16, nv=32, pack=8;
    iteration counts, not times): the static proxy cuts
    total pack cost Σ max(niter) by ~3–4% vs arrival order; a perfect
    predictor would cut ~16%.  Simplex iteration counts are only weakly
    predictable a priori (corr ≈ 0.5–0.6 for every static feature tried), so
    for RE-SOLVE workloads pass last round's measured `res.niter` as
    `scores` — measured counts are the strongest predictor available.
    """
    from ..ops.kernels.packed_simplex import solve_batch_packed
    from .batched import resolve_unverified_host

    if scores is None:
        scores = difficulty_scores(A, b, c, lo, hi, slack0=slack0)
    order = sort_for_packing(scores)
    inv = np.empty_like(order)
    inv[order] = np.arange(order.size)
    take = lambda arr: np.asarray(arr)[order]
    res = solve_batch_packed(
        take(A), take(b), take(c), take(lo), take(hi),
        device=device, pack=pack, slack0=slack0, **kernel_kwargs,
    )
    back = lambda arr: np.asarray(arr)[inv]
    res = res._replace(
        basis=back(res.basis), vstat=back(res.vstat), status=back(res.status),
        niter=back(res.niter), obj=back(res.obj),
        verified=back(res.verified), x=back(res.x),
    )
    # same certification contract as the other batched drivers: exact host
    # re-solve of any lane whose f32 basis failed f64 certification
    return resolve_unverified_host(res, A, b, c, lo, hi)


# ---------------------------------------------------------------------------
# Size bucketing (heterogeneous batches)
# ---------------------------------------------------------------------------

def _align_up(x: int, a: int) -> int:
    return ((x + a - 1) // a) * a if a > 1 else x


def pad_lp(A, b, c, lo, hi, slack0, M: int, NV: int):
    """Pad one LP (m, nv+m) → the bucket shape (M, NV+M), inert-padding scheme.

    Layout preserved: [structural | identity slack]; structural padding columns
    are FIXED [0,0]; padding rows have b=0 and a FIXED [0,0] slack that starts
    basic at 0 (feasible and provably inert — `canonical.py` docstring).
    """
    A = np.asarray(A, dtype=np.float64)
    m, n = A.shape
    nv = slack0
    Np = NV + M
    # the kernel initializes the basis inverse to I, i.e. the slack block must
    # be an exact +1 identity (canonical.py encodes row direction in the slack
    # BOUNDS, not the coefficient sign)
    if not np.array_equal(A[:, nv:nv + m], np.eye(m)):
        raise ValueError("slack block A[:, slack0:slack0+m] must be identity")
    A_p = np.zeros((M, Np))
    A_p[:m, :nv] = A[:, :nv]
    A_p[np.arange(M), NV + np.arange(M)] = 1.0

    pad_vec = lambda v, fill_sv, fill_row: np.concatenate([
        np.asarray(v, dtype=np.float64)[:nv],
        np.full(NV - nv, fill_sv, dtype=np.float64),
        np.asarray(v, dtype=np.float64)[nv:],
        np.full(M - m, fill_row, dtype=np.float64),
    ])
    b_p = np.concatenate([np.asarray(b, dtype=np.float64), np.zeros(M - m)])
    c_p = pad_vec(c, 0.0, 0.0)
    lo_p = pad_vec(lo, 0.0, 0.0)
    hi_p = pad_vec(hi, 0.0, 0.0)
    return A_p, b_p, c_p, lo_p, hi_p


def _unpad_x(x_p, nv: int, m: int, NV: int) -> np.ndarray:
    return np.concatenate([x_p[:nv], x_p[NV:NV + m]])


class Bucket(NamedTuple):
    """One tier bucket of `solve_heterogeneous`: the packed batch it solves."""

    M: int                # rows of the bucket's shape (M, NV + M)
    NV: int               # structural columns; the slack block starts here
    idxs: List[int]       # input positions of the bucket's LPs
    order: np.ndarray     # lane -> position in `idxs` (difficulty order)
    batch: Tuple          # (A, b, c, lo, hi), padded, lanes padded to the pack


def bucket_lps(lps: Sequence[Tuple], *, pack: int = 8, row_granule: int = 8,
               col_granule: int = 32, sort_packs: bool = True):
    """Parse `lps` (see `solve_heterogeneous`) and group them into tier
    buckets; returns ``(parsed, buckets)`` with `parsed[i] = (A, b, c, lo,
    hi, slack0)` in f64 and one `Bucket` per tier, whose batch is what K3
    receives for it."""
    parsed = []
    for lp in lps:
        if len(lp) == 6:
            A, b, c, lo, hi, s0 = lp
        else:
            A, b, c, lo, hi = lp
            s0 = None
        s0 = _split_slack(A, b, c, lo, hi, s0)
        parsed.append((np.asarray(A, dtype=np.float64), np.asarray(b, np.float64),
                       np.asarray(c, np.float64), np.asarray(lo, np.float64),
                       np.asarray(hi, np.float64), s0))

    tiers: dict[Tuple[int, int], List[int]] = {}
    for i, (A, *_rest, s0) in enumerate(parsed):
        m = A.shape[0]
        tier = (_align_up(m, row_granule), _align_up(s0, col_granule))
        tiers.setdefault(tier, []).append(i)

    buckets = []
    for (M, NV), idxs in tiers.items():
        padded = [pad_lp(*parsed[i][:5], parsed[i][5], M, NV) for i in idxs]
        Ab, bb, cb, lob, hib = (np.stack([p[f] for p in padded]) for f in range(5))
        order = (sort_for_packing(difficulty_scores(Ab, bb, cb, lob, hib,
                                                    slack0=NV))
                 if sort_packs else np.arange(len(idxs)))
        # pad lane count to a multiple of pack by replicating lane order[0]
        # (a replica shares its pack's refresh decisions, so the same replica
        # keeps the answers of its pack-mates the same as the JAX package's)
        B = len(idxs)
        Bp = _align_up(B, pack)
        lanes = np.concatenate([order, np.full(Bp - B, order[0], np.int64)])
        buckets.append(Bucket(M, NV, idxs, order,
                              (Ab[lanes], bb[lanes], cb[lanes], lob[lanes], hib[lanes])))
    return parsed, buckets


def solve_heterogeneous(
    lps: Sequence[Tuple],
    *,
    pack: int = 8,
    row_granule: int = 8,
    col_granule: int = 32,
    sort_packs: bool = True,
    device="cuda",
    max_iter: int = 2000,
    **kernel_kwargs,
) -> List[LPResult]:
    """Solve a heterogeneous list of LPs with size bucketing + sorted packing.

    `lps` is a sequence of `(A, b, c, lo, hi)` (equality form, layout
    [structural | identity slack], minimize) or `(A, b, c, lo, hi, slack0)`.
    LPs are grouped into (rows→`row_granule`, structural cols→`col_granule`)
    tier buckets, padded only to their bucket's shape, difficulty-sorted
    within the bucket, solved as packed batches on `device` (lane count
    padded to `pack` by replicating the first LP — replica lanes are
    dropped), and returned as `LPResult`s in the ORIGINAL order and each LP's
    own column layout.

    Every result is certified: f64 verification of the kernel basis on
    `device`, exact scipy-HiGHS re-solve of any uncertified lane.
    """
    from scipy.optimize import linprog

    from ..ops.kernels.packed_simplex import solve_batch_packed
    from ..status import Status

    parsed, buckets = bucket_lps(lps, pack=pack, row_granule=row_granule,
                                 col_granule=col_granule, sort_packs=sort_packs)
    results: List[LPResult] = [None] * len(parsed)  # type: ignore[list-item]
    for M, NV, idxs, order, batch in buckets:
        res = solve_batch_packed(
            *batch, device=device, pack=pack, slack0=NV, max_iter=max_iter,
            **kernel_kwargs,
        )
        B = len(idxs)
        obj = np.asarray(res.obj).copy()
        x = np.asarray(res.x).copy()
        status = np.asarray(res.status).copy()
        niter = np.asarray(res.niter)
        verified = np.asarray(res.verified).copy()
        for lane in np.flatnonzero(~verified[:B]):
            i = idxs[int(order[lane])]
            A, b, c, lo, hi, s0 = parsed[i]
            bounds = [
                (lo[j] if np.isfinite(lo[j]) else None,
                 hi[j] if np.isfinite(hi[j]) else None)
                for j in range(c.size)
            ]
            r = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
            if r.status == 0:
                xp = np.zeros(NV + M)
                xp[:s0] = r.x[:s0]
                xp[NV:NV + A.shape[0]] = r.x[s0:]
                obj[lane], x[lane] = r.fun, xp
                status[lane], verified[lane] = int(Status.OPTIMAL), True
            elif r.status == 2:
                status[lane], verified[lane] = int(Status.INFEASIBLE), True
            elif r.status == 3:
                status[lane], verified[lane] = int(Status.UNBOUNDED), True
        for lane in range(B):
            i = idxs[int(order[lane])]
            A, b, c, lo, hi, s0 = parsed[i]
            results[i] = LPResult(
                obj=float(obj[lane]),
                x=_unpad_x(x[lane], s0, A.shape[0], NV),
                status=int(status[lane]),
                niter=int(niter[lane]),
                verified=bool(verified[lane]),
            )
    return results
