"""Branch-and-cut TSP solver — the reference's flagship example (C10),
PyTorch port of `examples/tsp.py`.

This is the reason the incremental API exists (SURVEY.md §4.3): an LP-relaxation
loop that adds subtour-elimination cuts with `Solution.add_constraint`, branches
on fractional edges with `fix_var`/`unfix_var`, and never re-solves from scratch
— every node of the search tree is a warm-started dual-simplex re-solve.

Model: symmetric TSP on n cities.  Variables x_e ∈ [0,1] per edge e of the
complete graph, minimize Σ d_e·x_e, degree-2 equality per city, subtour cuts
Σ_{e ∈ δ(S)} x_e ≥ 2 added lazily for each fractional-support component S.

The model, the cut loop and the branch rule are the JAX example's line for
line; the only addition is the device of the solves (`device`, "cuda" by
default).  Run: ``python -m minilp_tpu_torch.examples.tsp [n] [seed] [device]``.
"""

from __future__ import annotations

import itertools
import math
import sys
from typing import Dict, List, Sequence, Tuple

import numpy as np

from minilp_tpu_torch import (
    ComparisonOp,
    Infeasible,
    LinearExpr,
    OptimizationDirection,
    Problem,
    Solution,
    SolverOptions,
    Variable,
)


def _edges(n: int) -> List[Tuple[int, int]]:
    return list(itertools.combinations(range(n), 2))


def _components(n: int, active: Sequence[Tuple[int, int]]) -> List[List[int]]:
    parent = list(range(n))

    def find(a):
        while parent[a] != a:
            parent[a] = parent[parent[a]]
            a = parent[a]
        return a

    for u, v in active:
        ru, rv = find(u), find(v)
        if ru != rv:
            parent[ru] = rv
    comps: Dict[int, List[int]] = {}
    for v in range(n):
        comps.setdefault(find(v), []).append(v)
    return list(comps.values())


class TspSolver:
    def __init__(self, dist: np.ndarray, device: str = "cuda"):
        self.n = dist.shape[0]
        self.edges = _edges(self.n)
        self.prob = Problem(OptimizationDirection.Minimize, SolverOptions(device=device))
        self.x: Dict[Tuple[int, int], Variable] = {}
        for (u, v) in self.edges:
            self.x[(u, v)] = self.prob.add_var(float(dist[u, v]), (0.0, 1.0))
        for v in range(self.n):
            expr = LinearExpr()
            for e in self.edges:
                if v in e:
                    expr.add(1.0, self.x[e])
            self.prob.add_constraint(expr, ComparisonOp.Eq, 2.0)
        self.best_obj = math.inf
        self.best_tour: List[Tuple[int, int]] | None = None
        self.nodes = 0

    # -- cutting planes ---------------------------------------------------------
    def _add_subtour_cuts(self, sol: Solution) -> Tuple[Solution, bool]:
        """Add one round of subtour-elimination cuts; returns (sol, added)."""
        vals = {e: sol[self.x[e]] for e in self.edges}
        active = [e for e, v in vals.items() if v > 1e-6]
        comps = _components(self.n, active)
        if len(comps) <= 1:
            return sol, False
        added = False
        for comp in comps:
            if len(comp) >= self.n:
                continue
            inside = set(comp)
            expr = LinearExpr()
            for (u, v) in self.edges:
                if (u in inside) != (v in inside):
                    expr.add(1.0, self.x[(u, v)])
            sol = sol.add_constraint(expr, ComparisonOp.Ge, 2.0)
            added = True
        return sol, added

    def _cut_loop(self, sol: Solution) -> Solution:
        for _ in range(self.n * 4):
            sol, added = self._add_subtour_cuts(sol)
            if not added:
                return sol
        return sol

    # -- branch & bound ---------------------------------------------------------
    def _branch(self, sol: Solution) -> Solution:
        self.nodes += 1
        sol = self._cut_loop(sol)
        if sol.objective() >= self.best_obj - 1e-9:
            return sol  # pruned by bound
        vals = {e: sol[self.x[e]] for e in self.edges}
        frac = [e for e, v in vals.items() if 1e-6 < v < 1.0 - 1e-6]
        if not frac:
            # integral and subtour-free → a tour
            self.best_obj = sol.objective()
            self.best_tour = [e for e, v in vals.items() if v > 0.5]
            return sol
        e = max(frac, key=lambda e: min(vals[e], 1.0 - vals[e]))
        var = self.x[e]
        for val in (1.0, 0.0):
            try:
                child = sol.fix_var(var, val)
            except Infeasible:
                continue
            child = self._branch(child)
            _, sol = child.unfix_var(var)
        return sol

    def solve(self) -> Tuple[float, List[Tuple[int, int]]]:
        sol = self.prob.solve()
        self._branch(sol)
        assert self.best_tour is not None, "no tour found"
        return self.best_obj, self.best_tour


def tour_length_brute_force(dist: np.ndarray) -> float:
    """Exact optimum by enumeration (for small n, used by tests)."""
    n = dist.shape[0]
    best = math.inf
    for perm in itertools.permutations(range(1, n)):
        tour = (0,) + perm
        length = sum(
            dist[tour[i], tour[(i + 1) % n]] for i in range(n)
        )
        best = min(best, length)
    return best


def main(n: int = 8, seed: int = 0, device: str = "cuda") -> None:
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    dist = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
    solver = TspSolver(dist, device=device)
    obj, tour = solver.solve()
    print(f"n={n} optimal tour length {obj:.6f} ({solver.nodes} B&B nodes)")
    print("tour edges:", sorted(tour))
    if n <= 9:
        exact = tour_length_brute_force(dist)
        assert abs(obj - exact) < 1e-6, (obj, exact)
        print(f"verified against brute force ({exact:.6f})")


if __name__ == "__main__":
    argv = sys.argv[1:4]
    main(*[int(a) for a in argv[:2]], *argv[2:])
