"""Synthetic Netlib-shaped sparse LP instances.

The reference's correctness gate runs the real Netlib suite (`tests/` +
vendored `*.mps.gz` [CODE]; BASELINE.md §1 full-suite objectives).  Netlib
data is not on this machine, so these generators produce instances at the
same SHAPES and SPARSITIES as the headline Netlib problems — 25fv47
(821×1571, ~1% dense) and maros-r7 (3136×9408, ~0.1% dense) — with the
properties that make them honest stand-ins:

* sparse structural block (k nonzeros per row, k ≈ density·nv, min 2),
  N(0,1)-ish magnitudes after light column scaling spread (conditioning is
  non-trivial but not adversarial, like Netlib);
* guaranteed feasible (an interior x₀ is planted) and bounded (every
  structural variable is boxed), so the oracle comparison is always
  "optimal objective to 1e-6 relative", never a skip;
* mixed row senses (≤ / ≥ / =) and non-degenerate rhs slackness.

The exact optimum is NOT planted — gates compare against the scipy-HiGHS
oracle (tests/oracle.py), which is stronger than a fixed objective table.
"""

from __future__ import annotations

import numpy as np

from ..api import ComparisonOp, LinearExpr, OptimizationDirection, Problem


def netlib_shaped_problem(
    m: int,
    nv: int,
    density: float,
    seed: int = 0,
    frac_eq: float = 0.15,
    frac_ge: float = 0.25,
) -> Problem:
    """A feasible, bounded, sparse LP at the given (rows, vars, density).

    Row i has ``max(2, round(density*nv))`` structural nonzeros at random
    columns.  Every variable is boxed in [0, u_j] with u_j ∈ [0.5, 2.5];
    the planted interior point x₀ ∈ (0.1·u, 0.9·u) makes ≤/=/≥ rows with
    rhs = (Ax₀) + slackness all simultaneously satisfiable.
    """
    rng = np.random.default_rng(seed)
    k = max(2, int(round(density * nv)))

    prob = Problem(OptimizationDirection.Minimize)
    u = rng.uniform(0.5, 2.5, size=nv)
    obj = rng.normal(size=nv)
    variables = [
        prob.add_var(float(obj[j]), (0.0, float(u[j]))) for j in range(nv)
    ]
    x0 = u * rng.uniform(0.1, 0.9, size=nv)

    # per-row sparse patterns: k distinct columns each, values with a light
    # per-column scale spread (~Netlib-ish conditioning, far from identity)
    col_scale = np.exp(rng.normal(scale=0.7, size=nv))
    cols = np.stack([rng.choice(nv, size=k, replace=False) for _ in range(m)])
    vals = rng.normal(size=(m, k)) * col_scale[cols]
    ax0 = np.einsum("mk,mk->m", vals, x0[cols])

    senses = rng.random(m)
    for i in range(m):
        expr = LinearExpr(
            (float(vals[i, t]), variables[cols[i, t]]) for t in range(k)
        )
        if senses[i] < frac_eq:
            prob.add_constraint(expr, ComparisonOp.Eq, float(ax0[i]))
        elif senses[i] < frac_eq + frac_ge:
            prob.add_constraint(
                expr, ComparisonOp.Ge, float(ax0[i] - rng.uniform(0.05, 1.0))
            )
        else:
            prob.add_constraint(
                expr, ComparisonOp.Le, float(ax0[i] + rng.uniform(0.05, 1.0))
            )
    return prob


#: (name, rows, structural vars, density) for the headline Netlib shapes
NETLIB_SHAPES = {
    "25fv47": (821, 1571, 0.0080),   # real 25fv47: 821×1571, nnz≈10400
    "maros-r7": (3136, 9408, 0.0049),  # real maros-r7: 3136×9408, nnz≈145k
    "fit1p": (627, 1677, 0.0095),    # real fit1p: 627×1677, nnz≈9868
}


# ---------------------------------------------------------------------------
# Adversarial generators (VERDICT r3 #5).  The plain netlib_shaped_problem
# plants an interior point with positive slackness — structurally KINDER
# than real Netlib, so the anti-cycling and drift machinery (Bland, Harris
# ties, surrender, refresh guards) rarely fires under the default gates.
# These generators manufacture exactly the structures that stress it.
# ---------------------------------------------------------------------------


def _emit_problem(A, obj, lo, hi, senses, rhs):
    """Build a Problem from dense arrays; senses ∈ {'eq','ge','le'}."""
    m, nv = A.shape
    prob = Problem(OptimizationDirection.Minimize)
    variables = [
        prob.add_var(
            float(obj[j]),
            (None if lo[j] == -np.inf else float(lo[j]),
             None if hi[j] == np.inf else float(hi[j])),
        )
        for j in range(nv)
    ]
    op = {"eq": ComparisonOp.Eq, "ge": ComparisonOp.Ge, "le": ComparisonOp.Le}
    for i in range(m):
        nz = np.nonzero(A[i])[0]
        expr = LinearExpr((float(A[i, j]), variables[j]) for j in nz)
        prob.add_constraint(expr, op[senses[i]], float(rhs[i]))
    return prob


def _sparse_rows(rng, m, nv, density, col_scale):
    k = max(2, int(round(density * nv)))
    A = np.zeros((m, nv))
    for i in range(m):
        cols = rng.choice(nv, size=k, replace=False)
        A[i, cols] = rng.normal(size=k) * col_scale[cols]
    return A


def degenerate_problem(
    m: int, nv: int, density: float, seed: int = 0,
    frac_eq: float = 0.3, frac_dup_row: float = 0.15,
    frac_dup_col: float = 0.1, frac_zero_obj: float = 0.3,
) -> Problem:
    """Primal- and dual-degenerate instance: every rhs sits EXACTLY on the
    planted point (zero slackness ⇒ many tight rows at the optimum ⇒
    massive ratio-test ties), a slice of rows are exact duplicates of
    earlier rows (tied blocking rows), a slice of columns duplicate earlier
    columns with identical objective (tied pricing scores), and a fraction
    of objective entries are zero (dual degeneracy).  This is the structure
    that makes naive simplex cycle — the Bland/Harris machinery must carry
    it (real Netlib's degeneracy class, e.g. degen2/degen3)."""
    rng = np.random.default_rng(seed)
    col_scale = np.exp(rng.normal(scale=0.5, size=nv))
    A = _sparse_rows(rng, m, nv, density, col_scale)
    u = rng.uniform(0.5, 2.5, size=nv)
    obj = rng.normal(size=nv)
    obj[rng.random(nv) < frac_zero_obj] = 0.0

    # duplicate columns (identical A column, objective, bounds)
    n_dc = int(frac_dup_col * nv)
    if n_dc:
        src = rng.choice(nv - n_dc, size=n_dc, replace=False)
        dst = np.arange(nv - n_dc, nv)
        A[:, dst] = A[:, src]
        obj[dst] = obj[src]
        u[dst] = u[src]

    # duplicate rows (identical coefficients AND rhs)
    n_dr = int(frac_dup_row * m)
    if n_dr:
        src_r = rng.choice(m - n_dr, size=n_dr, replace=False)
        A[m - n_dr:] = A[src_r]

    x0 = u * rng.uniform(0.1, 0.9, size=nv)
    rhs = A @ x0
    if n_dr:
        rhs[m - n_dr:] = rhs[src_r]
    senses = np.where(
        rng.random(m) < frac_eq, "eq",
        np.where(rng.random(m) < 0.5, "ge", "le"),
    )
    if n_dr:
        senses[m - n_dr:] = senses[src_r]
    lo = np.zeros(nv)
    return _emit_problem(A, obj, lo, u, senses, rhs)


def ill_conditioned_problem(
    m: int, nv: int, density: float, seed: int = 0,
    scale_span: float = 6.0, frac_parallel: float = 0.1,
    parallel_eps: float = 1e-7,
) -> Problem:
    """Numerically hostile instance: column scales span 10^±scale_span
    (basis condition numbers far beyond f32), plus near-parallel row pairs
    (rank-adjacent bases; tiny pivot elements when both enter).  Bounds
    counter-scale so the planted point keeps O(1) row activity — the
    coefficients are wild, the geometry is not, exactly the maros-r7-grade
    conditioning class.  f32 iterate paths must detect drift (Newton
    telltale / surrender) and hand off; exact paths must survive."""
    rng = np.random.default_rng(seed)
    col_scale = 10.0 ** rng.uniform(-scale_span, scale_span, size=nv)
    A = _sparse_rows(rng, m, nv, density, col_scale)
    u = rng.uniform(0.5, 2.5, size=nv) / col_scale
    obj = rng.normal(size=nv) * col_scale

    n_par = int(frac_parallel * m)
    if n_par:
        src_r = rng.choice(m - n_par, size=n_par, replace=False)
        scale = rng.uniform(0.5, 2.0, size=n_par)
        A[m - n_par:] = A[src_r] * scale[:, None]
        # perturb a few entries by parallel_eps relative: nearly-dependent,
        # not exactly dependent
        mask = A[m - n_par:] != 0.0
        A[m - n_par:] += (mask * parallel_eps
                          * rng.normal(size=(n_par, nv)) * A[m - n_par:])

    x0 = u * rng.uniform(0.1, 0.9, size=nv)
    ax0 = A @ x0
    senses = np.where(rng.random(m) < 0.15, "eq",
                      np.where(rng.random(m) < 0.5, "ge", "le"))
    slack = rng.uniform(0.05, 1.0, size=m) * np.maximum(np.abs(ax0), 1.0)
    rhs = np.where(senses == "eq", ax0,
                   np.where(senses == "ge", ax0 - slack, ax0 + slack))
    lo = np.zeros(nv)
    return _emit_problem(A, obj, lo, u, senses, rhs)


def staircase_problem(
    n_stages: int,
    stage_rows: int,
    stage_vars: int,
    seed: int = 0,
    coupling: int = 2,
    frac_eq: float = 0.3,
) -> Problem:
    """Multi-stage (staircase) LP: the block structure of dynamic planning
    models that dominates real Netlib (scsd/sctap/stair/grow families) and
    that the iid-sparse generators cannot produce.  Stage t's rows touch
    stage t's variables plus `coupling` variables of stage t−1 (inventory
    carry-over), so the constraint matrix is block lower-bidiagonal — long
    chains of dependency that stress eta-file growth and make pricing
    locality matter (VERDICT r4 weak #7)."""
    rng = np.random.default_rng(seed)
    nv = n_stages * stage_vars
    m = n_stages * stage_rows
    u = rng.uniform(0.5, 2.5, size=nv)
    obj = rng.normal(size=nv)
    x0 = u * rng.uniform(0.1, 0.9, size=nv)
    A = np.zeros((m, nv))
    for t in range(n_stages):
        r0 = t * stage_rows
        own = np.arange(t * stage_vars, (t + 1) * stage_vars)
        prev = (np.arange((t - 1) * stage_vars, t * stage_vars)
                if t > 0 else np.empty(0, dtype=int))
        k_own = max(2, stage_vars // 2)
        for r in range(stage_rows):
            cols = rng.choice(own, size=k_own, replace=False)
            A[r0 + r, cols] = rng.normal(size=k_own)
            if prev.size:
                link = rng.choice(prev, size=min(coupling, prev.size),
                                  replace=False)
                A[r0 + r, link] = rng.normal(size=link.size)
    ax0 = A @ x0
    senses = np.where(rng.random(m) < frac_eq, "eq",
                      np.where(rng.random(m) < 0.5, "ge", "le"))
    slack = rng.uniform(0.05, 1.0, size=m)
    rhs = np.where(senses == "eq", ax0,
                   np.where(senses == "ge", ax0 - slack, ax0 + slack))
    return _emit_problem(A, obj, np.zeros(nv), u, senses, rhs)


def network_flow_problem(
    n_nodes: int,
    n_arcs: int,
    seed: int = 0,
) -> Problem:
    """Min-cost network flow: node-balance EQUALITY rows over a ±1 incidence
    matrix, capacitated arcs.  Totally unimodular and massively degenerate —
    every basis is a spanning tree, ratio-test ties are the norm, and
    integral optima sit on many alternate vertices: the exact structure
    (netlib's ship/fffff/nesm class) where anti-cycling machinery earns its
    keep (VERDICT r4 weak #7).  Feasibility is guaranteed by construction:
    demands are the node imbalance of a planted feasible flow."""
    rng = np.random.default_rng(seed)
    # connected base: random spanning tree + extra random arcs
    tails = np.empty(n_arcs, dtype=int)
    heads = np.empty(n_arcs, dtype=int)
    perm = rng.permutation(n_nodes)
    for k in range(1, n_nodes):
        tails[k - 1] = perm[rng.integers(0, k)]
        heads[k - 1] = perm[k]
    extra = n_arcs - (n_nodes - 1)
    if extra < 0:
        raise ValueError("n_arcs must be >= n_nodes - 1")
    t_x = rng.integers(0, n_nodes, size=extra)
    h_x = (t_x + 1 + rng.integers(0, n_nodes - 1, size=extra)) % n_nodes
    tails[n_nodes - 1:] = t_x
    heads[n_nodes - 1:] = h_x
    cap = rng.uniform(1.0, 10.0, size=n_arcs)
    cost = rng.normal(size=n_arcs) + 1.5  # mostly-positive arc costs
    flow0 = cap * rng.uniform(0.1, 0.9, size=n_arcs)  # planted feasible flow
    A = np.zeros((n_nodes, n_arcs))
    A[tails, np.arange(n_arcs)] += 1.0   # flow leaves the tail
    A[heads, np.arange(n_arcs)] -= 1.0   # and enters the head
    rhs = A @ flow0                       # node imbalances of the planted flow
    senses = np.array(["eq"] * n_nodes)
    return _emit_problem(A, cost, np.zeros(n_arcs), cap, senses, rhs)


def mixed_bounds_problem(
    m: int, nv: int, density: float, seed: int = 0,
    frac_free: float = 0.1, frac_fixed: float = 0.1,
    frac_one_sided: float = 0.2,
) -> Problem:
    """Netlib-shaped instance with the bound-type mix the plain generator
    omits: FREE variables, FIXED variables (never eligible to enter), and
    one-sided bounds, alongside boxed ones.  Each free variable is tied
    into one dedicated EQUALITY row against boxed variables — the standard
    way real instances keep free variables bounded (the row determines
    them), so the instance stays optimal-solvable while every vstat branch
    (FREE entering both directions, FIXED exclusion, one-sided ratio
    bounds) is exercised."""
    rng = np.random.default_rng(seed)
    col_scale = np.exp(rng.normal(scale=0.7, size=nv))
    A = _sparse_rows(rng, m, nv, density, col_scale)
    u_cat = rng.random(nv)
    base_u = rng.uniform(0.5, 2.5, size=nv)
    x0 = base_u * rng.uniform(0.1, 0.9, size=nv)
    lo = np.zeros(nv)
    hi = base_u.copy()
    obj = rng.normal(size=nv)

    n_free = min(int(frac_free * nv), m // 3)
    free_idx = rng.choice(nv, size=n_free, replace=False)
    rest = np.setdiff1d(np.arange(nv), free_idx)
    n_fix = int(frac_fixed * rest.size)
    fixed_idx = rest[:n_fix]
    os_idx = rest[n_fix:n_fix + int(frac_one_sided * rest.size)]

    lo[free_idx] = -np.inf
    hi[free_idx] = np.inf
    lo[fixed_idx] = x0[fixed_idx]
    hi[fixed_idx] = x0[fixed_idx]
    side = rng.random(os_idx.size) < 0.5
    lo[os_idx[side]] = 0.0
    hi[os_idx[side]] = np.inf
    lo[os_idx[~side]] = -np.inf
    hi[os_idx[~side]] = base_u[os_idx[~side]]
    # a one-sided variable costed toward its open side is trivially
    # unbounded; cost it toward the closed side (the oracle still decides
    # the overall status)
    obj[os_idx[side]] = np.abs(obj[os_idx[side]])
    obj[os_idx[~side]] = -np.abs(obj[os_idx[~side]])

    # the first n_free rows are equality ties: x_free + Σ a_j·x_boxed = rhs
    # (the row determines the free variable from bounded ones)
    boxed = np.setdiff1d(rest, np.concatenate([fixed_idx, os_idx]))
    for t, j in enumerate(free_idx):
        A[t] = 0.0
        picks = rng.choice(boxed, size=min(4, boxed.size), replace=False)
        A[t, picks] = rng.normal(size=picks.size)
        A[t, j] = 1.0
        x0[j] = rng.normal() - A[t, picks] @ x0[picks]

    ax0 = A @ x0
    senses = np.where(rng.random(m) < 0.15, "eq",
                      np.where(rng.random(m) < 0.5, "ge", "le"))
    senses[:n_free] = "eq"
    slack = rng.uniform(0.05, 1.0, size=m)
    rhs = np.where(senses == "eq", ax0,
                   np.where(senses == "ge", ax0 - slack, ax0 + slack))
    return _emit_problem(A, obj, lo, hi, senses, rhs)


def random_batch(seed: int, batch: int, m: int, nv: int):
    """A batch of random dense canonical LPs as host f64 arrays
    ``(A (B, m, nv+m), b (B, m), c, lo, hi (B, nv+m))`` — the JAX package's
    `parallel.batched.make_random_batch_host`, same generator and layout:
    minimize c·x s.t. [A_s | I]·x = b, structural x in [0, 1] (bounded),
    slacks >= 0 with b = A_s·x₀ + u for an interior x₀ and u > 0 (feasible).
    The slack block is the last m columns (`slack0 = nv`)."""
    rng = np.random.default_rng(seed)
    n = nv + m
    A_s = rng.normal(size=(batch, m, nv))
    c_s = rng.normal(size=(batch, nv))
    x0 = rng.uniform(0.2, 0.8, size=(batch, nv))
    u = rng.uniform(0.1, 1.0, size=(batch, m))
    b = np.einsum("bmn,bn->bm", A_s, x0) + u
    eye = np.broadcast_to(np.eye(m), (batch, m, m))
    A = np.concatenate([A_s, eye], axis=2)
    c = np.concatenate([c_s, np.zeros((batch, m))], axis=1)
    lo = np.zeros((batch, n))
    hi = np.concatenate([np.ones((batch, nv)), np.full((batch, m), np.inf)], axis=1)
    return A, b, c, lo, hi
