"""Solve status codes and variable-state encoding.

The reference's only "failure surface" is `Error::{Infeasible,Unbounded}`
(`src/lib.rs (enum Error)` [API], SURVEY.md §6.3).  Inside a kernel we cannot
raise, so every solve returns an integer status; the Python API layer converts
non-OPTIMAL statuses into exceptions (see `minilp_tpu_torch.api`).
"""

from __future__ import annotations

import enum


class Status(enum.IntEnum):
    """Terminal status of a solve (int32 on the device)."""

    RUNNING = 0
    OPTIMAL = 1
    INFEASIBLE = 2
    UNBOUNDED = 3
    MAX_ITER = 4
    NUMERICAL = 5


class VarStat(enum.IntEnum):
    """Per-variable simplex state (int8; int32 inside the CUDA kernel).

    Mirrors the reference's non-basic variable state tracking
    (`src/solver.rs (non-basic var state)` [CODE], SURVEY.md §3.2): non-basic
    variables rest *at a bound* — at-min / at-max; fixed variables are both; free
    variables rest at zero.
    """

    AT_LOWER = 0
    AT_UPPER = 1
    FREE = 2      # non-basic free variable, valued at 0
    FIXED = 3     # lo == hi (also used for padding columns)
    BASIC = 4
