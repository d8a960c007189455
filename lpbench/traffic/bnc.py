"""Traffic kind "bnc": branch-and-cut episodes, a closed loop with one
client.  Each episode solves a distinct Netlib-shaped LP cold (its root, in
the window but not a node), then edits the solution as a branch-and-cut
code does, one warm re-solve a node:

  1. `cuts` cuts by the rule of `minilp_tpu_torch.utils.node_chain.run_chain`
     (8 random structural columns with normal coefficients, <= their value
     less `margin`; the generator from the seed and the episode); the
     episode ends at the first cut that makes the LP infeasible;
  2. `fixes` pairs of `fix_var` and `unfix_var`: the structural variables
     strictly inside their bounds (so basic) farthest above their lower
     bound after the cuts, each fixed at the midpoint of that bound and its
     value, then unfixed;
  3. one `add_gomory_cut` on the most fractional variable strictly inside
     its bounds.

An edit that makes the LP infeasible is a node, and its answer is judged.
The harness keeps each episode's LP as rows beside the program (its edit
log); the Gomory row is the one the program appended, read back from its
canonical form, since only the program's basis defines it.
"""

from __future__ import annotations

import time

import numpy as np

from ..core import Answer, Request, Run, Window, sample, seeded
from ..reference.lp import GE, LE
from . import cold

INSIDE = 1e-7   # a value this far inside both bounds counts as inside
FRACTIONAL = 1e-3  # a Gomory variable's fractional part lies in (this, 1 - this)


def instance(config, seed, e):
    shape = config["shape"]
    return cold.netlib_arrays(shape["rows"], shape["cols"], shape["density"],
                              [int(seed) % (1 << 64), e % (1 << 64), 2 if e >= 0 else 3])


class Program(cold.Program):
    """The program's incremental API on the solution of `Problem.solve()`."""

    def __init__(self, device, sync, config=None, params=None):
        super().__init__(device, sync)
        from minilp_tpu_torch import ComparisonOp, Infeasible, LinearExpr, Variable

        self._api = (ComparisonOp, Infeasible, LinearExpr, Variable)

    def _call(self, fn):
        Infeasible = self._api[1]
        try:
            out = fn()
        except Infeasible:
            out = "infeasible"
        self.sync()
        return out

    def add_cut(self, sol, js, coeffs, rhs):
        ComparisonOp, _, LinearExpr, Variable = self._api
        expr = LinearExpr((float(c), Variable(int(j))) for j, c in zip(js, coeffs))
        return self._call(lambda: sol.add_constraint(expr, ComparisonOp.Le, float(rhs)))

    def fix(self, sol, j, val):
        return self._call(lambda: sol.fix_var(self._api[3](int(j)), float(val)))

    def unfix(self, sol, j):
        out = self._call(lambda: sol.unfix_var(self._api[3](int(j))))
        return out if isinstance(out, str) else out[1]

    def gomory(self, sol, j, nv):
        """The solution after the cut, and the cut (row, rhs) the program
        appended: row · x >= rhs."""
        handle = sol._engine
        m0 = handle.can.m
        out = self._call(lambda: sol.add_gomory_cut(self._api[3](int(j))))
        can = handle.can
        if can.m <= m0:
            raise RuntimeError("add_gomory_cut appended no row")
        row = np.array(can.A[can.m - 1, :nv], dtype=np.float64)
        if can.row_ops[-1] != self._api[0].Ge:
            raise RuntimeError(f"the Gomory row's sense is {can.row_ops[-1]}")
        return out, (row, float(can.b[can.m - 1]))


def _node(system, window, stages, records, spans, kind, call):
    """One timed request; returns (its outcome, its request)."""
    stages.reset()
    t0 = time.perf_counter()
    failed = False
    with spans(f"lpbench.{kind}"):
        try:
            out = call()
        except Exception as exc:  # an error other than infeasibility fails the node
            out, failed = exc, True
    req = Request(kind, time.perf_counter() - t0, stages.snapshot(), failed=failed,
                  records=records.take())
    window.requests.append(req)
    return out, req


def _inside(x, lo, hi):
    return (x > lo + INSIDE) & (x < hi - INSIDE)


def episode(e, config, params, seed, system, window, stages, records, spans, judged):
    """Run episode e while the window is open; append (episode, instance,
    edit log, answer) of each request to `judged`.  Returns 1 when the
    program's Gomory row does not cut off the vertex it was derived from,
    else 0."""
    inst = instance(config, seed, e)
    nv = len(inst.obj)
    lo, hi = np.zeros(nv), inst.hi.copy()
    log = []   # the edits, in order: ("cut", row, sense, rhs) / ("bounds", j, lo, hi)

    def keep(out, req):
        if req.failed:
            ans = Answer("failed")
        else:
            ans = system.answer(out, nv)
        req.n_certified = int(ans.status != "failed")
        judged.append((e, inst, list(log), ans))
        return ans

    def build_and_solve():
        with spans("lpbench.build"):
            prob = system.build(inst)
        return system.solve(prob)

    sol, req = _node(system, window, stages, records, spans, "root", build_and_solve)
    ans = keep(sol, req)
    if ans.status != "optimal":
        return 0
    rng = seeded(seed, e, 4)
    x = ans.x
    for _k in range(params["cuts"]):
        if not window.open():
            return 0
        js = rng.choice(nv, size=8, replace=False)
        coeffs = rng.normal(size=8)
        rhs = float(coeffs @ x[js]) - params["margin"]
        row = np.zeros(nv)
        row[js] = coeffs
        log.append(("cut", row, LE, rhs))
        out, req = _node(system, window, stages, records, spans, "node:add_constraint",
                         lambda: system.add_cut(sol, js, coeffs, rhs))
        ans = keep(out, req)
        if ans.status != "optimal":
            return 0
        sol, x = out, ans.x
    inside = np.flatnonzero(_inside(x, lo, hi))
    chosen = inside[np.argsort(-(x[inside] - lo[inside]), kind="stable")][:params["fixes"]]
    base = x
    for j in chosen:
        if not window.open():
            return 0
        mid = 0.5 * (lo[j] + base[j])
        log.append(("bounds", int(j), mid, mid))
        out, req = _node(system, window, stages, records, spans, "node:fix_var",
                         lambda: system.fix(sol, j, mid))
        ans = keep(out, req)
        if ans.status == "failed":
            return 0
        if ans.status == "optimal":
            sol = out
        if not window.open():
            return 0
        log.append(("bounds", int(j), lo[j], hi[j]))
        out, req = _node(system, window, stages, records, spans, "node:unfix_var",
                         lambda: system.unfix(sol, j))
        ans = keep(out, req)
        if ans.status != "optimal":
            return 0
        sol, x = out, ans.x
    if not params["gomory"] or not hasattr(system, "gomory") or not window.open():
        return 0
    frac = x - np.floor(x)
    cand = np.flatnonzero(_inside(x, lo, hi) & (frac > FRACTIONAL) & (frac < 1 - FRACTIONAL))
    if cand.size == 0:
        return 0
    g = int(cand[np.argmin(np.abs(frac[cand] - 0.5), axis=0)])
    cut = {}

    def gomory():
        out, cut["row"] = system.gomory(sol, g, nv)
        return out

    out, req = _node(system, window, stages, records, spans, "node:add_gomory_cut", gomory)
    kept = 0
    if "row" in cut:
        row, rhs = cut["row"]
        log.append(("cut", row, GE, rhs))
        kept = int(not float(row @ x) < rhs)
    keep(out, req)
    return kept


def row_lp(inst, log):
    lp = inst.row_lp()
    for edit in log:
        if edit[0] == "cut":
            lp = lp.with_row(edit[1], edit[2], edit[3])
        else:
            lp = lp.with_bounds(edit[1], edit[2], edit[3])
    return lp


def prepare(config, params, seed):
    """Nothing: each episode's LP is made from the seed when it starts."""
    return None


def warmup(config, params, seed, system, spans, state) -> None:
    """One short episode at the cell's shape (a root no request gets, one cut,
    one fix and unfix, the Gomory cut), in a window of its own."""
    from ..core import Records

    class _Nothing:
        def reset(self):
            pass

        def snapshot(self):
            return {}

    small = dict(params, cuts=1, fixes=1)
    w = Window(float("inf"))
    w.start()
    with spans("lpbench.warmup"):
        episode(-1, config, small, seed, system, w, _Nothing(), Records(False), spans, [])


def run(config, params, seed, system, window: Window, stages, records, spans, state) -> Run:
    judged = []
    e = kept = 0
    window.start()
    while window.open():
        kept += episode(e, config, params, seed, system, window, stages, records, spans, judged)
        e += 1
    window.close()
    keep = set(sample(seed, len(judged), params["judged"], salt=5))
    # every infeasible answer is judged too
    keep |= {k for k, item in enumerate(judged) if item[3].status == "infeasible"}
    keep = sorted(keep)
    return Run(window, [row_lp(judged[k][1], judged[k][2]) for k in keep],
               [judged[k][3] for k in keep], info={"episodes": e, "shape": config["shape"], "gomory_kept": kept})
