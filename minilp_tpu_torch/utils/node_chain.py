"""A branch-and-cut node chain through the incremental API, with its oracle.

`run_chain(sol)` edits a solved LP as a branch-and-cut loop would, one warm
re-solve per node:
  1. bench.py's chain of `add_constraint` cuts (`bench.py:51-70`): each cut
     takes 8 random structural variables (`numpy.random.default_rng(seed)`)
     with normal coefficients, ≤ their current value − `margin`; the chain
     ends at the first cut that makes the LP infeasible;
  2. `fix_var` of the basic structural variable farthest above its lower
     bound, at the midpoint of that bound and its value, then `unfix_var`;
  3. one `add_gomory_cut` on the most fractional basic structural variable.
With `edits=False` the chain stops after the cuts, as bench.py's does
(`minilp_tpu_torch/bench.py`).  An edit that makes the LP infeasible is
kept as a node (its outcome "Infeasible"); any other error propagates.
Each node keeps its wall time (host clock around the edit, after `sync`),
its stage timers (`utils/profiling.py`: `state_rebuild_s` is `ensure_binv`
or a state rebuilt from a certified basis, `host_polish_s`, `certify_s`,
the kernels' stages), the re-solve's pivots, the certificate, the
objective, the solve records
the edit wrote (when `log_path` is the `MINILP_TPU_LOG` file) and the
user-level LP it left (`Node.problem`): the solved problem with the added
rows and fixed bounds, the Gomory row read back from the canonical form.
`highs_outcome` solves that LP with scipy's HiGHS, the check of each node.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import math
import pathlib
import time
from typing import Callable, List, Optional

import numpy as np

from .. import api
from . import profiling


@dataclasses.dataclass
class Node:
    edit: str                   # the Solution method
    outcome: str                # "optimal", or the error's class name
    wall_s: float
    pivots: Optional[int]       # the re-solve's (None when it raised)
    certified: Optional[bool]
    objective: Optional[float]
    events: List[str]           # solve-record events the edit wrote
    stages: dict                # stage timers of the edit
    problem: "api.Problem"      # the user-level LP after the edit


def _copy_problem(prob: "api.Problem") -> "api.Problem":
    twin = api.Problem(prob.direction, prob.options)
    twin._obj, twin._lo, twin._hi = list(prob._obj), list(prob._lo), list(prob._hi)
    twin._constraints = copy.deepcopy(prob._constraints)
    return twin


def run_chain(sol: "api.Solution", *, cuts: int = 6, seed: int = 5, margin: float = 0.05,
              edits: bool = True,
              log_path: Optional[pathlib.Path] = None,
              sync: Callable[[], None] = lambda: None) -> List[Node]:
    """The chain of nodes above, from the solved `sol`; returns its nodes.
    Every Solution of the chain shares `sol`'s handle."""
    handle = sol._engine
    mirror = _copy_problem(handle.problem)  # the LP the handle solves
    nv = mirror.num_vars
    nodes: List[Node] = []
    seen = (len(log_path.read_text().splitlines())
            if log_path is not None and log_path.exists() else 0)

    def events():
        """The events of the records written since the last call."""
        nonlocal seen
        if log_path is None:
            return []
        lines = log_path.read_text().splitlines()
        new, seen = lines[seen:], len(lines)
        return [json.loads(line)["event"] for line in new]

    def node(edit, call):
        """Run one edit; returns its Solution (None when it raised)."""
        profiling.reset_stages()
        t0 = time.perf_counter()
        try:
            out = call()
        except api.Infeasible as exc:
            sync()
            nodes.append(Node(edit, type(exc).__name__, time.perf_counter() - t0,
                              None, None, None, events(), profiling.stages(),
                              _copy_problem(mirror)))
            return None
        sync()
        wall = time.perf_counter() - t0
        new = out[1] if edit == "unfix_var" else out
        nodes.append(Node(edit, "optimal", wall, new._engine.iterations(),
                          bool(new._engine.certified), new.objective(), events(),
                          profiling.stages(), _copy_problem(mirror)))
        return new

    rng = np.random.default_rng(seed)
    cur = sol
    for _k in range(cuts):
        js = rng.choice(nv, size=8, replace=False)
        coeffs = rng.normal(size=8)
        val = sum(float(cf) * cur[api.Variable(int(j))] for cf, j in zip(coeffs, js))
        terms = [(int(j), float(cf)) for j, cf in zip(js, coeffs)]
        expr = api.LinearExpr((cf, api.Variable(j)) for j, cf in terms)
        mirror._constraints.append((sorted(terms), api.ComparisonOp.Le, val - margin))
        nxt = node("add_constraint",
                   lambda: cur.add_constraint(expr, api.ComparisonOp.Le, val - margin))
        if nxt is None:
            return nodes  # the cut made the node infeasible: the chain ends
        cur = nxt
    if not edits:
        return nodes

    can = cur._engine.can
    x = np.array([cur[api.Variable(j)] for j in range(nv)])
    basic = [int(j) for j in np.asarray(cur._engine._state.basis) if j < nv]
    j = max((k for k in basic if math.isfinite(can.lo[k])), key=lambda k: x[k] - can.lo[k])
    val = 0.5 * (float(can.lo[j]) + float(x[j]))
    saved = (mirror._lo[j], mirror._hi[j])
    mirror._lo[j] = mirror._hi[j] = val
    fixed = node("fix_var", lambda: cur.fix_var(api.Variable(j), val))
    cur = fixed if fixed is not None else cur
    mirror._lo[j], mirror._hi[j] = saved
    cur = node("unfix_var", lambda: cur.unfix_var(api.Variable(j)))
    if cur is None:
        return nodes

    x = np.array([cur[api.Variable(k)] for k in range(nv)])
    basic = [int(k) for k in np.asarray(cur._engine._state.basis) if k < nv]
    frac = [k for k in basic if 1e-6 < x[k] - math.floor(x[k]) < 1.0 - 1e-6]
    if frac:
        g = min(frac, key=lambda k: (abs(x[k] - math.floor(x[k]) - 0.5), k))

        def gomory():
            m0 = handle.can.m
            try:
                return cur.add_gomory_cut(api.Variable(g))
            finally:
                can = handle.can
                if can.m > m0:  # the cut's row, also when the re-solve raised
                    row = can.A[can.m - 1, :nv]
                    mirror._constraints.append(
                        ([(int(k), float(row[k])) for k in np.flatnonzero(row)],
                         can.row_ops[-1], float(can.b[can.m - 1])))

        node("add_gomory_cut", gomory)
    return nodes


def highs_outcome(prob: "api.Problem"):
    """("optimal", objective) or ("infeasible", None) of the user-level LP
    by scipy's HiGHS; any other outcome raises."""
    from scipy.optimize import linprog

    nv = prob.num_vars
    sign = 1.0 if prob.direction == api.OptimizationDirection.Minimize else -1.0
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for terms, op, rhs in prob._constraints:
        row = np.zeros(nv)
        for j, coeff in terms:
            row[j] += coeff
        if op == api.ComparisonOp.Le:
            A_ub.append(row)
            b_ub.append(rhs)
        elif op == api.ComparisonOp.Ge:
            A_ub.append(-row)
            b_ub.append(-rhs)
        else:
            A_eq.append(row)
            b_eq.append(rhs)
    bounds = [(None if lo == -math.inf else lo, None if hi == math.inf else hi)
              for lo, hi in zip(prob._lo, prob._hi)]
    res = linprog(
        sign * np.asarray(prob._obj),
        A_ub=np.asarray(A_ub) if A_ub else None, b_ub=b_ub or None,
        A_eq=np.asarray(A_eq) if A_eq else None, b_eq=b_eq or None,
        bounds=bounds, method="highs",
    )
    if res.status == 2:
        return "infeasible", None
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed: {res.message}")
    return "optimal", sign * float(res.fun)
