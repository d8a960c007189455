"""Shared setup of the PyTorch-port parity tests (`test_torch_*.py`).

The port (`minilp_tpu_torch`) is held against the JAX package on the same
inputs: numpy data from a seed, or the same `Problem` built in both packages.
Importing this module pins torch to one CPU thread, so that the parallel
test workers do not oversubscribe the machine.
"""

from __future__ import annotations

import numpy as np
import torch

import minilp_tpu
import minilp_tpu_torch

torch.set_num_threads(1)

#: the port's options for CPU runs (the package default is device="cuda")
CPU = minilp_tpu_torch.SolverOptions(device="cpu")


def rel_err(a: float, b: float) -> float:
    return abs(a - b) / (1.0 + abs(b))


def as_torch_problem(prob: minilp_tpu.Problem, **torch_opts) -> minilp_tpu_torch.Problem:
    """The same user-level LP as a `minilp_tpu_torch.Problem`, with
    `device="cpu"` plus any further port options."""
    opts = minilp_tpu_torch.SolverOptions(device="cpu", **torch_opts)
    twin = minilp_tpu_torch.Problem(
        minilp_tpu_torch.OptimizationDirection(prob.direction.value), opts
    )
    twin._obj = list(prob._obj)
    twin._lo = list(prob._lo)
    twin._hi = list(prob._hi)
    twin._constraints = [
        (list(terms), minilp_tpu_torch.ComparisonOp(op.value), rhs)
        for terms, op, rhs in prob._constraints
    ]
    return twin


def f64(*arrays):
    return tuple(torch.as_tensor(np.asarray(a, dtype=np.float64)) for a in arrays)


# -- the hand-built LPs of tests/test_simplex.py, as reference Problems -------

def _lp(direction, vars_, rows):
    """vars_: [(obj, (lo, hi))]; rows: [({var_idx: coeff}, op, rhs)]."""
    prob = minilp_tpu.Problem(direction)
    xs = [prob.add_var(obj, bounds) for obj, bounds in vars_]
    for coeffs, op, rhs in rows:
        prob.add_constraint([(xs[j], a) for j, a in coeffs.items()], op, rhs)
    return prob


_MAX = minilp_tpu.OptimizationDirection.Maximize
_MIN = minilp_tpu.OptimizationDirection.Minimize
_LE, _GE, _EQ = (minilp_tpu.ComparisonOp.Le, minilp_tpu.ComparisonOp.Ge,
                 minilp_tpu.ComparisonOp.Eq)
_POS = (0.0, None)

#: name -> (make, expected outcome: an objective, "infeasible" or "unbounded")
HAND_CASES = {
    "doc_example_maximize": (lambda: _lp(_MAX, [(1.0, _POS), (2.0, (0.0, 3.0))],
                                         [({0: 1, 1: 1}, _LE, 4.0)]), 7.0),
    "simple_minimize_with_ge": (lambda: _lp(_MIN, [(1.0, _POS), (1.0, _POS)],
                                            [({0: 1, 1: 2}, _GE, 4.0),
                                             ({0: 3, 1: 1}, _GE, 6.0)]), 2.8),
    "equality_constraints": (lambda: _lp(_MIN, [(2.0, (None, None)), (3.0, (None, None))],
                                         [({0: 1, 1: 1}, _EQ, 10.0),
                                          ({0: 1, 1: -1}, _EQ, 2.0)]), 24.0),
    "bound_flip_and_boxed_vars": (lambda: _lp(_MAX, [(1.0, (0.0, 1.0)), (1.0, (0.0, 1.0))],
                                              [({0: 1, 1: 1}, _LE, 10.0)]), 2.0),
    "negative_lower_bounds": (lambda: _lp(_MIN, [(1.0, (-5.0, 5.0))],
                                          [({0: 1}, _GE, -3.0)]), -3.0),
    "fixed_var": (lambda: _lp(_MIN, [(1.0, (2.5, 2.5)), (1.0, _POS)],
                              [({0: 1, 1: 1}, _GE, 4.0)]), 4.0),
    "no_constraints": (lambda: _lp(_MIN, [(1.0, (-1.0, 8.0))], []), -1.0),
    "infeasible": (lambda: _lp(_MIN, [(1.0, _POS)],
                               [({0: 1}, _LE, 1.0), ({0: 1}, _GE, 2.0)]), "infeasible"),
    "infeasible_bounds_vs_equality": (lambda: _lp(_MIN, [(0.0, (0.0, 1.0)), (0.0, (0.0, 1.0))],
                                                  [({0: 1, 1: 1}, _EQ, 3.0)]), "infeasible"),
    "unbounded": (lambda: _lp(_MAX, [(1.0, _POS), (0.0, _POS)],
                              [({0: 1, 1: -1}, _LE, 1.0)]), "unbounded"),
    "unbounded_free_var": (lambda: _lp(_MIN, [(1.0, (None, None))],
                                       [({0: 1}, _LE, 5.0)]), "unbounded"),
    "degenerate_lp": (lambda: _lp(_MIN, [(-1.0, _POS), (-1.0, _POS)],
                                  [({0: 1, 1: 1}, _LE, 1.0), ({0: 1}, _LE, 1.0),
                                   ({1: 1}, _LE, 1.0), ({0: 2, 1: 1}, _LE, 2.0)]), -1.0),
    "solution_iteration_order": (lambda: _lp(_MIN, [(float(i + 1), (0.0, 1.0)) for i in range(5)],
                                             [({j: 1 for j in range(5)}, _GE, 2.0)]), 3.0),
}
