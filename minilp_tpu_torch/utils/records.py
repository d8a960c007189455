"""Structured per-solve records (SURVEY.md §6.5).

The reference's observability is `log` crate debug lines in the solver loop
(iteration counts, objective progress, refactorization events — SURVEY.md
§6.1).  The TPU build's equivalent is a structured record per solve — engine,
shapes, status, iterations, wall-clock, backend — emitted as one JSON line to
the file named by `MINILP_TPU_LOG` (or stderr with `MINILP_TPU_LOG=-`).
Disabled (zero overhead beyond a getenv) when the variable is unset.  These
records are exactly the rows the BASELINE.md measurement protocol consumes.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Optional


@dataclasses.dataclass
class SolveRecord:
    event: str            # "cold_solve" | "dual_resolve" | "primal_resolve" | "pdhg_solve"
    engine: str
    status: str
    rows: int             # active constraints m
    cols: int             # structural variables nv
    padded_rows: int
    padded_cols: int
    iterations: int
    objective: Optional[float]
    wall_s: float
    backend: str
    dtype: str
    #: free-form event payload (e.g. the scaling-harness numbers)
    extra: Optional[dict] = None

    def iters_per_sec(self) -> float:
        return self.iterations / self.wall_s if self.wall_s > 0 else 0.0


def enabled() -> bool:
    return bool(os.environ.get("MINILP_TPU_LOG"))


def emit(record: SolveRecord) -> None:
    if not enabled():
        return
    payload = dataclasses.asdict(record)
    payload["iters_per_sec"] = round(record.iters_per_sec(), 2)
    line = json.dumps(payload)
    target = os.environ["MINILP_TPU_LOG"]
    if target == "-":
        print(line, file=sys.stderr)
    else:
        with open(target, "a") as f:
            f.write(line + "\n")
