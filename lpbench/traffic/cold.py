"""Traffic kind "cold": a closed loop with one client, each request one
distinct LP of the configuration's shape built through the API from its
arrays and solved cold with `Problem.solve()`.

The LPs come from a pool of `pool` instances made from `pool_seed`, the
same for every run; the run's seed orders the pool, and request i takes the
i-th instance of that order (round the pool).  So every seed gets the same
work in another order, and within a run no LP repeats until `pool`
requests have passed.

The configuration's `generator` names the rule that makes an LP
(`GENERATORS`; `"netlib_shaped"` where it names none), and its `shape`
gives the rule's sizes and, for `"degenerate"`, its fractions.  Each rule
is one of `minilp_tpu_torch.utils.synth`'s, copied draw for draw, so that
the same seed gives the same LP, but as arrays: the harness makes them
before a request's clock starts, and the reference solves the same arrays.
"""

from __future__ import annotations

import dataclasses
import time

import numpy as np

from ..core import Answer, Request, Run, Window, sample, seeded
from ..reference.lp import EQ, GE, LE, RowLP


@dataclasses.dataclass
class Instance:
    obj: np.ndarray      # (nv,)
    hi: np.ndarray       # (nv,), every lower bound 0
    cols: np.ndarray     # (m, k) column of each row's nonzeros, or m arrays of any length
    vals: np.ndarray     # as `cols`
    sense: np.ndarray    # (m,)
    rhs: np.ndarray      # (m,)

    def row_lp(self) -> RowLP:
        m, nv = len(self.cols), self.obj.shape[0]
        A = np.zeros((m, nv))
        rows = np.repeat(np.arange(m), [len(c) for c in self.cols])
        np.add.at(A, (rows, np.concatenate(self.cols)), np.concatenate(self.vals))
        return RowLP(c=self.obj.copy(), A=A, sense=self.sense.copy(), rhs=self.rhs.copy(),
                     lo=np.zeros(nv), hi=self.hi.copy())


def netlib_arrays(m: int, nv: int, density: float, seed, frac_eq: float = 0.15,
                  frac_ge: float = 0.25) -> Instance:
    """`netlib_shaped_problem(m, nv, density, seed)` as arrays: the same
    draws in the same order from `numpy.random.default_rng(seed)`."""
    rng = np.random.default_rng(seed)
    k = max(2, int(round(density * nv)))
    u = rng.uniform(0.5, 2.5, size=nv)
    obj = rng.normal(size=nv)
    x0 = u * rng.uniform(0.1, 0.9, size=nv)
    col_scale = np.exp(rng.normal(scale=0.7, size=nv))
    cols = np.stack([rng.choice(nv, size=k, replace=False) for _ in range(m)])
    vals = rng.normal(size=(m, k)) * col_scale[cols]
    ax0 = np.einsum("mk,mk->m", vals, x0[cols])
    senses = rng.random(m)
    sense = np.empty(m, dtype=np.int64)
    rhs = np.empty(m)
    for i in range(m):
        if senses[i] < frac_eq:
            sense[i], rhs[i] = EQ, ax0[i]
        elif senses[i] < frac_eq + frac_ge:
            sense[i], rhs[i] = GE, ax0[i] - rng.uniform(0.05, 1.0)
        else:
            sense[i], rhs[i] = LE, ax0[i] + rng.uniform(0.05, 1.0)
    return Instance(obj=obj, hi=u, cols=cols, vals=vals, sense=sense, rhs=rhs)


def degenerate_arrays(m: int, nv: int, density: float, seed, frac_eq: float = 0.3,
                      frac_dup_row: float = 0.15, frac_dup_col: float = 0.1,
                      frac_zero_obj: float = 0.3) -> Instance:
    """`degenerate_problem(m, nv, density, seed, ...)` as arrays: the same
    draws in the same order from `numpy.random.default_rng(seed)`.  Every
    rhs lies on the planted point, the last `frac_dup_row` of the rows copy
    earlier rows with their sense and rhs, the last `frac_dup_col` of the
    columns copy earlier columns with their cost and bound, and a share
    `frac_zero_obj` of the costs is 0.  A row keeps its nonzeros in column
    order."""
    rng = np.random.default_rng(seed)
    col_scale = np.exp(rng.normal(scale=0.5, size=nv))
    k = max(2, int(round(density * nv)))
    A = np.zeros((m, nv))
    for i in range(m):
        cols = rng.choice(nv, size=k, replace=False)
        A[i, cols] = rng.normal(size=k) * col_scale[cols]
    u = rng.uniform(0.5, 2.5, size=nv)
    obj = rng.normal(size=nv)
    obj[rng.random(nv) < frac_zero_obj] = 0.0
    n_dc = int(frac_dup_col * nv)
    if n_dc:
        src = rng.choice(nv - n_dc, size=n_dc, replace=False)
        dst = np.arange(nv - n_dc, nv)
        A[:, dst] = A[:, src]
        obj[dst] = obj[src]
        u[dst] = u[src]
    n_dr = int(frac_dup_row * m)
    if n_dr:
        src_r = rng.choice(m - n_dr, size=n_dr, replace=False)
        A[m - n_dr:] = A[src_r]
    x0 = u * rng.uniform(0.1, 0.9, size=nv)
    rhs = A @ x0
    if n_dr:
        rhs[m - n_dr:] = rhs[src_r]
    eq = rng.random(m) < frac_eq       # both draws are made, as in np.where
    ge = rng.random(m) < 0.5
    sense = np.where(eq, EQ, np.where(ge, GE, LE)).astype(np.int64)
    if n_dr:
        sense[m - n_dr:] = sense[src_r]
    cols = [np.flatnonzero(row) for row in A]
    return Instance(obj=obj, hi=u, cols=cols, vals=[row[c] for row, c in zip(A, cols)],
                    sense=sense, rhs=rhs)


#: each rule by its name in a configuration's `generator`, with the keys of
#: its `shape` that it reads beyond rows, cols and density (each optional)
GENERATORS = {
    "netlib_shaped": (netlib_arrays, ()),
    "degenerate": (degenerate_arrays,
                   ("frac_eq", "frac_dup_row", "frac_dup_col", "frac_zero_obj")),
}


def instance(config: dict, params: dict, order, i: int) -> Instance:
    """Request i's LP, given the run's order of the pool (i < 0: the
    warm-up's, which no request gets)."""
    shape = config["shape"]
    key = [params["pool_seed"], order[i % len(order)], 0] if i >= 0 else [params["pool_seed"], 0, 1]
    rule, keys = GENERATORS[config.get("generator", "netlib_shaped")]
    return rule(shape["rows"], shape["cols"], shape["density"], key,
                **{k: shape[k] for k in keys if k in shape})


class Program:
    """The program: the LP built through `minilp_tpu_torch`'s API, solved by
    `Problem.solve()` on `device` with the default options."""

    def __init__(self, device: str, sync, config=None, params=None):
        from minilp_tpu_torch import SolverOptions

        self.opts = SolverOptions(device=device)
        self.sync = sync

    def build(self, inst: Instance):
        from minilp_tpu_torch import ComparisonOp, LinearExpr, OptimizationDirection, Problem

        prob = Problem(OptimizationDirection.Minimize, self.opts)
        xs = [prob.add_var(float(c), (0.0, float(h))) for c, h in zip(inst.obj, inst.hi)]
        ops = {LE: ComparisonOp.Le, EQ: ComparisonOp.Eq, GE: ComparisonOp.Ge}
        for cols, vals, s, r in zip(inst.cols, inst.vals, inst.sense, inst.rhs):
            expr = LinearExpr((float(v), xs[j]) for j, v in zip(cols, vals))
            prob.add_constraint(expr, ops[int(s)], float(r))
        return prob

    def solve(self, prob):
        """The solution; an `Infeasible` is its answer, any other error fails."""
        from minilp_tpu_torch import Infeasible

        try:
            sol = prob.solve()
        except Infeasible:
            sol = "infeasible"
        self.sync()
        return sol

    @staticmethod
    def answer(sol, n: int) -> Answer:
        """The answer in a solution of an LP of n variables."""
        if isinstance(sol, str):
            return Answer(sol)
        from minilp_tpu_torch import Variable

        x = np.array([sol[Variable(j)] for j in range(n)])
        return Answer("optimal", float(sol.objective()), x)


def prepare(config, params, seed):
    """The run's order of the pool; each request's LP is made from it
    before the request's clock starts."""
    return [int(k) for k in seeded(seed, 9).permutation(params["pool"])]


def warmup(config, params, seed, system, spans, order) -> None:
    """One solve at the cell's shape, of an LP no request gets."""
    with spans("lpbench.warmup"):
        inst = instance(config, params, order, -1)
        system.answer(system.solve(system.build(inst)), len(inst.obj))


def run(config, params, seed, system, window: Window, stages, records, spans, order) -> Run:
    lps, answers = [], []
    i = 0
    window.start()
    while window.open():
        with spans("lpbench.generate"):
            inst = instance(config, params, order, i)
        stages.reset()
        failed = False
        t0 = time.perf_counter()
        with spans("lpbench.request"):
            try:
                with spans("lpbench.build"):
                    prob = system.build(inst)
                build_s = time.perf_counter() - t0
                sol = system.solve(prob)
            except Exception as exc:  # an error other than infeasibility fails the request
                sol, failed, build_s = exc, True, float("nan")
        wall = time.perf_counter() - t0
        req = Request("solve", wall, stages.snapshot(), failed=failed,
                      records=records.take(), extra={"build_s": build_s})
        ans = Answer("failed") if failed else system.answer(sol, len(inst.obj))
        req.n_certified = int(ans.status != "failed")
        window.requests.append(req)
        lps.append(inst)
        answers.append(ans)
        i += 1
    window.close()
    keep = sample(seed, len(lps), params["judged"], salt=1)
    return Run(window, [lps[k].row_lp() for k in keep], [answers[k] for k in keep],
               info={"shape": config["shape"]})
