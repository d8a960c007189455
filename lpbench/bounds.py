"""The yardstick of the roofline metrics: the table of peaks and the work a
kernel's inputs need, counted from shapes and pivots.

The arithmetic is `chip_smoke.py`'s (`streaming_bound`, `dense_simplex_bound`),
copied; K2's refreshes and majors are counted from the pivots over fixed
periods, not from K2's own counters, so a kernel that refreshed less could
not lower its own yardstick.
"""

from __future__ import annotations

import math

import numpy as np

#: Published peaks (NVIDIA's data sheet, SXM part at 700 W): f32 outside
#: the tensor cores, and HBM bandwidth.  Keyed by `torch.cuda.get_device_name()`.
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"f32_flops": 67e12, "hbm_bytes": 3.35e12},
}

#: K2's period between Newton refreshes at these sizes (the floor of
#: `SolverOptions.streaming_refactor_period`) and its minor pivots per major
K2_PERIOD, K2_MINOR_K = 128, 16
#: K3's refactorization period in `solve_batches_pipelined`
K3_PERIOD = 32


def seconds(flops: float, nbytes: float, peaks: dict) -> tuple[float, str]:
    """(least seconds, "operations" or "bytes"): the larger of the operations
    over the f32 peak and the bytes over the memory rate."""
    t_ops, t_bytes = flops / peaks["f32_flops"], nbytes / peaks["hbm_bytes"]
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def streaming_work(m: int, n: int, pivots: int) -> tuple[float, float]:
    """(flops, bytes) K2 needs for `pivots` pivots on an m x n LP: a refresh
    every `K2_PERIOD` pivots and one before the claim, two Newton sweeps
    (8m³) and the steepest-edge weights (2nm²) each; a major every
    `K2_MINOR_K` pivots, its pricing over Aᵀ (2mn), y and the candidates'
    block W = B⁻¹·A_cand (2m²(1 + minor_k)); Aᵀ and the vectors read once,
    basis, vstat and B⁻¹ written once, in f32."""
    refreshes = 1 + pivots // K2_PERIOD
    majors = math.ceil(pivots / K2_MINOR_K)
    flops = (refreshes * (8 * m ** 3 + 2 * n * m * m)
             + majors * (2 * m * n + 2 * m * m * (1 + K2_MINOR_K)))
    nbytes = 4 * ((n * m + m + 3 * n) + (m + n + m * m))
    return float(flops), float(nbytes)


def dense_simplex_work(niter, m: int, n: int) -> tuple[float, float]:
    """(flops, bytes) K3 needs for LPs of m x n that took `niter` pivots: per
    pivot the pivot row (2mn), FTRAN and the rank-1 update (4m²); a Newton
    refresh per `K3_PERIOD` pivots (8m³ + 4mn); the f32 inputs read once,
    the int32 rows written once."""
    niter = np.asarray(niter, dtype=np.float64)
    flops = float((niter * (2 * m * n + 4 * m * m)
                   + np.floor(niter / K3_PERIOD) * (8 * m ** 3 + 4 * m * n)).sum())
    nbytes = float(niter.size * 4 * ((m * n + m + 3 * n) + (m + n + 2)))
    return flops, nbytes
