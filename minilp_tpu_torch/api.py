"""Public modeling API — parity surface with the reference crate.

This is the PyTorch port's copy of the JAX package's `api.py`, the equivalent
of `src/lib.rs` (C1 in SURVEY.md §3.1 [API]):
`Problem` (`new`/`add_var`/`add_constraint`/`solve`), `Variable`, `LinearExpr`,
`ComparisonOp{Eq,Le,Ge}`, `OptimizationDirection{Minimize,Maximize}`, `Solution`
(`objective`, `var_value`, indexing, iteration, and the incremental re-solve
surface `add_constraint` / `fix_var` / `unfix_var` / `add_gomory_cut`), and the
`Error{Infeasible,Unbounded}` type.  Rust's `Result` becomes Python exceptions.

Example (the API spec, as in the reference's lib.rs doc-tests):

    >>> from minilp_tpu_torch import Problem, OptimizationDirection, ComparisonOp
    >>> from minilp_tpu_torch import SolverOptions
    >>> prob = Problem(OptimizationDirection.Maximize, SolverOptions(device="cpu"))
    >>> x = prob.add_var(1.0, (0.0, None))
    >>> y = prob.add_var(2.0, (0.0, 3.0))
    >>> prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    >>> sol = prob.solve()
    >>> round(sol.objective(), 6)
    7.0
    >>> round(sol[x], 6), round(sol[y], 6)
    (1.0, 3.0)

The incremental re-solve surface (`Solution.add_constraint`, `fix_var`,
`unfix_var`, `add_gomory_cut`) re-solves warm from the solution's basis
(`engine/incremental.py`): on the host first, or through K1 or K2 restarted
warm when the options force a kernel.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass
from typing import Dict, Iterable, Iterator, List, Optional, Sequence, Tuple, Union

from .options import DEFAULT_OPTIONS, SolverOptions


# --------------------------------------------------------------------------------------
# Errors — `src/lib.rs (enum Error { Infeasible, Unbounded })` [API]
# --------------------------------------------------------------------------------------


class Error(Exception):
    """Base class for solver errors (reference: `enum Error` [API])."""


class Infeasible(Error):
    """The problem is infeasible."""

    def __str__(self) -> str:  # pragma: no cover - trivial
        return "problem is infeasible"


class Unbounded(Error):
    """The objective is unbounded in the optimization direction."""

    def __str__(self) -> str:  # pragma: no cover - trivial
        return "problem is unbounded"


class SolverFailure(Error):
    """Numerical failure or iteration limit (no reference analog; defensive)."""


# --------------------------------------------------------------------------------------
# Enums — `src/lib.rs (ComparisonOp, OptimizationDirection)` [API]
# --------------------------------------------------------------------------------------


class ComparisonOp(enum.Enum):
    """Constraint sense: ``Le`` (≤), ``Ge`` (≥), ``Eq`` (=)."""

    Le = "<="
    Ge = ">="
    Eq = "="


class OptimizationDirection(enum.Enum):
    Minimize = "min"
    Maximize = "max"


# --------------------------------------------------------------------------------------
# Variable / LinearExpr — `src/lib.rs (struct Variable, struct LinearExpr)` [API]
# --------------------------------------------------------------------------------------


@dataclass(frozen=True)
class Variable:
    """An opaque handle to a problem variable (index into the problem)."""

    idx: int

    # Operator sugar so `2 * x + y - 3 * z` builds a LinearExpr, mirroring the
    # reference's `impl Add/Mul for Variable` family [API].
    def __add__(self, other: "ExprLike") -> "LinearExpr":
        return LinearExpr.from_term(1.0, self) + other

    def __radd__(self, other: "ExprLike") -> "LinearExpr":
        return LinearExpr.from_term(1.0, self) + other

    def __sub__(self, other: "ExprLike") -> "LinearExpr":
        return LinearExpr.from_term(1.0, self) - other

    def __rsub__(self, other: "ExprLike") -> "LinearExpr":
        return (-1.0) * self + other

    def __mul__(self, coeff: float) -> "LinearExpr":
        return LinearExpr.from_term(float(coeff), self)

    def __rmul__(self, coeff: float) -> "LinearExpr":
        return LinearExpr.from_term(float(coeff), self)

    def __neg__(self) -> "LinearExpr":
        return LinearExpr.from_term(-1.0, self)


class LinearExpr:
    """A linear combination of variables (`struct LinearExpr` [API]).

    Buildable from operator sugar, from pair iterables in either order —
    ``(coeff, var)`` or the reference's ``(var, coeff)`` (`FromIterator
    <(Variable, f64)>` [API]) — or incrementally via `add`.  Duplicate
    variables accumulate.
    """

    __slots__ = ("_coeffs",)

    def __init__(self, terms=None):
        self._coeffs: Dict[int, float] = {}
        if terms is not None:
            for a, b in terms:
                if isinstance(a, Variable):
                    self.add(float(b), a)
                else:
                    self.add(float(a), b)

    @staticmethod
    def empty() -> "LinearExpr":
        return LinearExpr()

    @staticmethod
    def from_term(coeff: float, var: Variable) -> "LinearExpr":
        e = LinearExpr()
        e.add(coeff, var)
        return e

    def add(self, coeff: float, var: Variable) -> "LinearExpr":
        """Accumulate ``coeff * var`` into the expression (returns self)."""
        self._coeffs[var.idx] = self._coeffs.get(var.idx, 0.0) + float(coeff)
        return self

    def terms(self) -> List[Tuple[int, float]]:
        """Sorted (var_index, coeff) pairs, zero coefficients dropped."""
        return sorted((i, c) for i, c in self._coeffs.items() if c != 0.0)

    # -- operators ---------------------------------------------------------------
    def _coerce(self, other: "ExprLike") -> "LinearExpr":
        if isinstance(other, LinearExpr):
            return other
        if isinstance(other, Variable):
            return LinearExpr.from_term(1.0, other)
        raise TypeError(f"cannot combine LinearExpr with {type(other)!r}")

    def __add__(self, other: "ExprLike") -> "LinearExpr":
        out = LinearExpr()
        out._coeffs = dict(self._coeffs)
        for i, c in self._coerce(other)._coeffs.items():
            out._coeffs[i] = out._coeffs.get(i, 0.0) + c
        return out

    __radd__ = __add__

    def __sub__(self, other: "ExprLike") -> "LinearExpr":
        return self + (-1.0) * self._coerce(other)

    def __rsub__(self, other: "ExprLike") -> "LinearExpr":
        return self._coerce(other) + (-1.0) * self

    def __mul__(self, coeff: float) -> "LinearExpr":
        out = LinearExpr()
        out._coeffs = {i: c * float(coeff) for i, c in self._coeffs.items()}
        return out

    __rmul__ = __mul__

    def __neg__(self) -> "LinearExpr":
        return self * -1.0

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        parts = [f"{c:+g}*x{i}" for i, c in self.terms()]
        return "LinearExpr(" + " ".join(parts) + ")"


ExprLike = Union[LinearExpr, Variable]


def _check_bounds(lo: Optional[float], hi: Optional[float]) -> Tuple[float, float]:
    lo_f = -math.inf if lo is None else float(lo)
    hi_f = math.inf if hi is None else float(hi)
    if math.isnan(lo_f) or math.isnan(hi_f):
        raise ValueError("variable bounds must not be NaN")
    if lo_f == math.inf or hi_f == -math.inf:
        raise ValueError("lower bound must be < +inf and upper bound > -inf")
    if lo_f > hi_f:
        raise ValueError(f"invalid bounds: lower {lo_f} > upper {hi_f}")
    return lo_f, hi_f


# --------------------------------------------------------------------------------------
# Problem — `src/lib.rs (struct Problem)` [API]
# --------------------------------------------------------------------------------------


class Problem:
    """An LP under construction: variables with objective coefficients and bounds,
    plus linear constraints.  `solve()` hands off to the engine and returns a
    `Solution` owning the warm-startable solver state (the reference's `Solution`
    owns its `Solver` — `src/lib.rs (struct Solution)` [API][CODE]).
    """

    def __init__(
        self,
        direction: OptimizationDirection = OptimizationDirection.Minimize,
        options: SolverOptions = DEFAULT_OPTIONS,
    ):
        self.direction = direction
        self.options = options
        self._obj: List[float] = []
        self._lo: List[float] = []
        self._hi: List[float] = []
        # Constraints as (terms, op, rhs) with terms = [(var_idx, coeff), ...]
        self._constraints: List[Tuple[List[Tuple[int, float]], ComparisonOp, float]] = []

    # -- construction ------------------------------------------------------------
    def add_var(
        self,
        obj_coeff: float,
        bounds: Tuple[Optional[float], Optional[float]] = (None, None),
    ) -> Variable:
        """Add a variable with the given objective coefficient and ``(min, max)``
        bounds; ``None`` means unbounded on that side.  Mirrors
        ``Problem::add_var(obj_coeff, (min, max))`` [API]."""
        lo, hi = _check_bounds(bounds[0], bounds[1])
        v = Variable(len(self._obj))
        self._obj.append(float(obj_coeff))
        self._lo.append(lo)
        self._hi.append(hi)
        return v

    def add_constraint(self, expr, op: ComparisonOp, rhs: float) -> None:
        """Add the constraint ``expr op rhs`` (`Problem::add_constraint` [API]).

        ``expr`` may be a LinearExpr, a Variable, or an iterable of pairs in
        either ``(var, coeff)`` or ``(coeff, var)`` order (the reference
        accepts `&[(Variable, f64)]` slices [API])."""
        if isinstance(expr, Variable):
            expr = LinearExpr.from_term(1.0, expr)
        elif not isinstance(expr, LinearExpr):
            expr = LinearExpr(expr)
        terms = expr.terms()
        for i, _ in terms:
            if not (0 <= i < len(self._obj)):
                raise ValueError(f"constraint references unknown variable index {i}")
        if math.isnan(rhs):
            raise ValueError("constraint rhs must not be NaN")
        self._constraints.append((terms, op, float(rhs)))

    @property
    def num_vars(self) -> int:
        return len(self._obj)

    @property
    def num_constraints(self) -> int:
        return len(self._constraints)

    # -- solving -----------------------------------------------------------------
    def solve(self) -> "Solution":
        """Solve the problem; raises `Infeasible` / `Unbounded` on those outcomes.

        Equivalent of `Problem::solve` → `Solver::try_new` + `optimize`
        (SURVEY.md §4.1 call stack).
        """
        from .engine import driver  # local import: engine pulls in torch

        return driver.solve_problem(self)


# --------------------------------------------------------------------------------------
# Solution — `src/lib.rs (struct Solution)` [API]
# --------------------------------------------------------------------------------------


class Solution:
    """An optimal solution which *owns* the warm-started solver state, enabling the
    incremental re-solve API (`Solution` owning `Solver`, SURVEY.md §6.4 [API]).

    Constructed only by the engine driver; use `Problem.solve()`.
    """

    def __init__(self, engine_state, problem: Problem):
        # engine_state is a minilp_tpu_torch.engine.driver.EngineHandle; kept loosely
        # typed here so the API layer stays import-light.
        self._engine = engine_state
        self._problem = problem

    # -- accessors ---------------------------------------------------------------
    def objective(self) -> float:
        """Objective value in the user's optimization direction
        (`Solution::objective` [API]; undoes the internal Maximize negation)."""
        return self._engine.user_objective()

    def var_value(self, var: Variable) -> float:
        """Value of ``var`` at the optimum (`Solution::var_value` [API])."""
        return self._engine.var_value(var.idx)

    def __getitem__(self, var: Variable) -> float:
        return self.var_value(var)

    def iter(self) -> Iterator[Tuple[Variable, float]]:
        """Iterate ``(Variable, value)`` in variable-index order
        (`impl Index<Variable> for Solution`, `Solution::iter` [API])."""
        for i in range(self._problem.num_vars):
            yield Variable(i), self._engine.var_value(i)

    __iter__ = iter

    # -- incremental API ---------------------------------------------------------
    def add_constraint(self, expr: ExprLike, op: ComparisonOp, rhs: float) -> "Solution":
        """Add a constraint to the solved problem and re-optimize from the current
        basis via dual simplex (`Solution::add_constraint` [API], SURVEY.md §4.2).
        Consumes self (further use of this object is undefined), returns the new
        Solution.  Raises `Infeasible` if the new constraint makes the LP infeasible.
        """
        if isinstance(expr, Variable):
            expr = LinearExpr.from_term(1.0, expr)
        elif not isinstance(expr, LinearExpr):
            expr = LinearExpr(expr)
        return self._engine.add_constraint(self, expr.terms(), op, float(rhs))

    def fix_var(self, var: Variable, val: float) -> "Solution":
        """Temporarily fix ``var`` to ``val`` and re-optimize (warm-started).
        (`Solution::fix_var` [API]).  Raises `Infeasible` when no feasible point
        has ``var == val``."""
        return self._engine.fix_var(self, var.idx, float(val))

    def unfix_var(self, var: Variable) -> Tuple[bool, "Solution"]:
        """Undo `fix_var`: restore the variable's original bounds and re-optimize.
        Returns ``(changed, solution)`` where ``changed`` says whether the optimal
        objective moved (`Solution::unfix_var` returning a flag [API])."""
        return self._engine.unfix_var(self, var.idx)

    def add_gomory_cut(self, var: Variable) -> "Solution":
        """Derive a Gomory mixed-integer cut from the basic row of ``var``
        (which must be basic with a fractional value), append it, and re-optimize
        via dual simplex (`Solution::add_gomory_cut` [API], SURVEY.md §3.2)."""
        return self._engine.add_gomory_cut(self, var.idx)
