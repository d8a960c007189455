"""The comparison that decides `correct`.

Each LP judged is solved again by the plain reference (`reference/ipm.py`,
f64, on the host's CPU, LAPACK's Cholesky), once however often the window
answered it.  The reference first drops the equality rows that depend on
the others (a pivoted QR), or answers "infeasible" where one contradicts
them, so an LP with redundant rows is judged against its true optimum.
The numbers compared, each against the cell's limit in
`lpbench/workloads/<cell>.json`:

* `status_mismatch`: answers whose status (optimal / infeasible / failed)
  is not the reference's;
* `obj_gap`: over the answers both sides call optimal, the largest of
  |objective − reference| and |c·x − reference|, over 1 + |reference|;
* `primal_viol`: over the optimal answers, the largest violation of a row
  or a bound by the answer's x (`reference.lp.violation`);
* `unverified` (scenario cells): lanes of the window whose certificate
  flag is false;
* `gomory_kept` (branch-and-cut cells): Gomory rows that do not cut off the
  vertex they were derived from.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference import ipm
from .reference.lp import violation


def numbers(run, dtype=torch.float64) -> dict:
    unique = {}
    for lp in run.lps:
        unique.setdefault(id(lp), lp)
    keys = list(unique)
    refs = dict(zip(keys, ipm.solve([unique[k] for k in keys], dtype=dtype, device="cpu")))
    mismatch, gap, viol = 0, 0.0, 0.0
    for lp, ans in zip(run.lps, run.answers):
        ref = refs[id(lp)]
        if ans.status != ref.status:
            mismatch += 1
            continue
        if ans.status != "optimal":
            continue
        cx = float(lp.c @ ans.x)
        gap = max(gap, max(abs(ans.obj - ref.obj), abs(cx - ref.obj)) / (1.0 + abs(ref.obj)))
        viol = max(viol, violation(lp, ans.x))
    out = {"status_mismatch": mismatch, "obj_gap": gap, "primal_viol": viol}
    for key in ("unverified", "gomory_kept"):
        if key in run.info:
            out[key] = run.info[key]
    return out


def decide(values: dict, limits: dict) -> tuple[bool, dict]:
    """(correct, {name: {"value", "limit"}}) for every number with a limit;
    a limit without its number is not correct."""
    checks = {}
    correct = True
    for name, limit in limits.items():
        value = values.get(name)
        checks[name] = {"value": value, "limit": limit}
        if value is None or not np.isfinite(value) or value > limit:
            correct = False
    return correct, checks
