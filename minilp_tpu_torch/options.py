"""Solver options — the single frozen configuration object (PyTorch port).

The reference has *no* runtime configuration: all numerics are hardcoded consts
(feasibility/pricing epsilon ~1e-8, LU stability coefficient ~0.1, refactorization
threshold) per SURVEY.md §6.6 (`src/solver.rs`, `src/lu.rs` consts [CODE]).  We keep
that spirit: one frozen dataclass whose defaults mirror the reference's constants,
no global flag system.  The dataclass is frozen and hashable, as in the JAX
package, so option sets can key caches.  The port adds one field, `device`.
"""

from __future__ import annotations

import dataclasses
from typing import Optional


@dataclasses.dataclass(frozen=True)
class SolverOptions:
    """Numeric and engine options for the LP solver.

    Defaults follow the reference's hardcoded constants where known
    (SURVEY.md §6.6: pricing/feasibility epsilon ~1e-8) and standard
    revised-simplex practice elsewhere.
    """

    # --- tolerances -----------------------------------------------------------
    #: Primal feasibility tolerance: a basic value within this of its bound is
    #: considered feasible (reference: ~1e-8, src/solver.rs consts [CODE]).
    feas_tol: float = 1e-8
    #: Dual feasibility / optimality tolerance on reduced costs.
    opt_tol: float = 1e-8
    #: Minimum acceptable pivot magnitude in the ratio test / basis update.
    pivot_tol: float = 1e-8
    #: Relative window for the ratio-test tie set (stability tie-break picks the
    #: largest |pivot| among ratios within this window of the minimum).
    ratio_tie_rel: float = 1e-7
    #: Absolute slack added to the ratio tie window.
    ratio_tie_abs: float = 1e-9

    # --- iteration control ----------------------------------------------------
    #: Hard cap on simplex iterations per phase; None → 32 * (m + n) + 1000.
    max_iter: Optional[int] = None
    #: Refactorize (rebuild the basis inverse from scratch) every this many pivots.
    #: The reference refactorizes on eta-file blowup (SURVEY.md §3.2 [BASELINE]);
    #: a fixed period is the fixed-shape XLA-friendly equivalent.  None = auto
    #: (64; 128 at M ≥ 1024 where the host SuperLU refactorization dominates).
    #: An explicit value — including 64 — is always respected verbatim, so a
    #: user fighting an ill-conditioned instance can tighten the eta-file
    #: window (ADVICE r4: the old sentinel-by-default-comparison made an
    #: explicit 64 indistinguishable from unset).
    refactor_period: Optional[int] = None
    #: Switch to Bland's anti-cycling rule after this many iterations without
    #: objective (or phase-1 infeasibility) improvement.
    bland_after: int = 50

    # --- numerics -------------------------------------------------------------
    #: Working dtype of the general engine: "float64" (default) or "float32".
    dtype: str = "float64"
    #: Newton refinement sweeps of the engine's basis-inverse refresh.
    newton_refine_iters: int = 3
    #: Engine: "simplex" (revised primal/dual simplex) or "pdhg" (first-order).
    engine: str = "simplex"
    #: Host-side presolve before canonicalization (singleton/empty/redundant row
    #: elimination + bound tightening; build-only — the reference has none).
    presolve: bool = True
    #: Single-LP megakernel routing: "auto" solves padded LPs up to
    #: (512, 2048) through the hand-written CUDA kernel when `device` is a
    #: CUDA device (f64 certification on the host; an uncertified OPTIMAL
    #: claim is polished exactly, any other claim goes to the f64 engine),
    #: "always" forces it (the kernel's plain torch version on the CPU),
    #: "never" disables.
    use_megakernel: str = "auto"
    #: Netlib-scale path through the HBM-streaming kernel (the JAX package's
    #: K2).  Not ported yet (ROADMAP.md Queue 1 item 7): the port routes as
    #: if it were "never", whatever the value.
    use_streaming: str = "auto"
    #: Mid-size f32-iterate + f64-certify pass through the general engine.
    #: A TPU workaround in the JAX package (which enables it only there);
    #: the port routes as if it were "never", whatever the value.
    f32_midsize: str = "auto"
    #: Phase-2 pricing rule: "devex" (approximate steepest-edge reference
    #: weights, the reference's "Dantzig + steepest-edge" scheme — fresh
    #: weights make early iterations Dantzig-like) or "dantzig".
    pricing: str = "devex"
    #: Reset Devex weights to 1 when the entering weight exceeds this.
    devex_reset: float = 1e8

    # --- shape padding (XLA static-shape friendliness) ------------------------
    #: Round padded row count up to a multiple of this (TPU sublane = 8).
    row_align: int = 8
    #: Round padded column count up to a multiple of this (TPU lane = 128).
    col_align: int = 128
    #: Extra row capacity for incremental `add_constraint` without recompiling.
    row_capacity_slack: int = 0

    # --- PDHG engine ----------------------------------------------------------
    pdhg_max_iter: int = 200_000
    pdhg_check_every: int = 64
    pdhg_restart_beta: float = 0.9
    #: Initial primal weight ω (τ = ω/‖A‖, σ = 1/(ω‖A‖)); None → ‖c‖/‖b‖.
    pdhg_omega: Optional[float] = None
    #: Geometric smoothing exponent for the adaptive primal-weight update at
    #: restarts (PDLP's θ; 0 disables adaptation).
    pdhg_weight_theta: float = 0.5
    #: Ruiz row/column equilibration sweeps applied before iterating.
    pdhg_ruiz_iters: int = 10
    #: Tolerance for the Farkas/recession-ray infeasibility certificates
    #: (cone residuals; the certificate margin must clear 100× this).
    pdhg_infeas_tol: float = 1e-9
    #: Constraint-matrix storage for the PDHG path: "auto" picks sparse BCOO
    #: matvecs when the instance is large and sparse, "dense"/"sparse" force.
    pdhg_matrix: str = "auto"
    #: Iteration scheme: "vanilla" (the PDLP restarted-average scheme —
    #: the default: robust ω adaptation across scalings) or "halpern"
    #: (reflected PDHG + Halpern anchoring, the cuPDLP-class accelerated
    #: variant with fixed-point-residual restarts; measured up to ~1.6×
    #: fewer iterations on well-conditioned instances, but it runs with a
    #: FROZEN primal weight — PDLP's displacement-ratio ω heuristics
    #: measurably diverge under anchored dynamics — so badly-scaled
    #: instances can stall where vanilla adapts through).
    pdhg_variant: str = "vanilla"

    # --- PDHG → simplex crossover (cold solves beyond the kernel envelope) ----
    #: "auto": cold simplex solves above the device-kernel envelope start
    #: from a PDHG-identified basis instead of the slack basis (replaces
    #: ~10⁵ cold pivots with a few hundred warm exact ones at maros scale);
    #: "never" disables.
    crossover: str = "auto"
    #: KKT tolerance the PDHG stage runs to before basis identification —
    #: the basis is combinatorial; moderate accuracy identifies it and the
    #: exact polish absorbs the residual.  Measured at the maros shape:
    #: 1e-4 → 42k PDHG iters + 710 exact pivots (56 s total); 1e-5 → 96k +
    #: 61 (100 s) — the polish absorbs looser identification far cheaper
    #: than the PDHG tail costs.
    crossover_tol: float = 1e-4

    # --- device ---------------------------------------------------------------
    #: torch device of the solve: "cuda" (the default; a solve raises when no
    #: card is present rather than running quietly on the CPU) or "cpu".
    device: str = "cuda"

    def effective_max_iter(self, m: int, n: int) -> int:
        if self.max_iter is not None:
            return int(self.max_iter)
        return 32 * (m + n) + 1000

    def effective_refactor_period(self, m: int = 0) -> int:
        """Resolved refactorization period (None → size-scaled auto default)."""
        if self.refactor_period is not None:
            return max(int(self.refactor_period), 1)
        # SuperLU refactorization dominates at scale (measured ~115 ms at
        # m=1600 on a filled basis vs ~0.5 ms per eta-file solve): amortize
        # over a longer eta file — 128 f64 etas are numerically benign (the
        # reference's eta-file threshold is of the same order).
        return 128 if m >= 1024 else 64

    def streaming_refactor_period(self, m: int = 0) -> int:
        """Period for the HBM-streaming kernel (auto floor 128: its Newton
        refresh is the costliest block; exact candidate updates between
        refreshes absorb the extra f32 drift)."""
        if self.refactor_period is not None:
            return max(int(self.refactor_period), 1)
        return max(self.effective_refactor_period(m), 128)


DEFAULT_OPTIONS = SolverOptions()
