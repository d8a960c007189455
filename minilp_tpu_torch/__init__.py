"""minilp_tpu_torch — the PyTorch/CUDA port of minilp_tpu.

The same modeling API as `minilp_tpu` (the JAX package, which stays the
reference), solved with PyTorch on an explicit device.  On a CUDA device the
single-LP path runs through a hand-written CUDA megakernel
(`ops/kernels/batched_simplex.py`, source in `csrc/`); on the CPU every
kernel runs as its plain torch version::

    from minilp_tpu_torch import Problem, OptimizationDirection, ComparisonOp

    prob = Problem(OptimizationDirection.Maximize)   # device="cuda" by default
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert abs(sol.objective() - 7.0) < 1e-6

The package imports torch, numpy and scipy, never jax.
"""

from .api import (
    ComparisonOp,
    Error,
    Infeasible,
    LinearExpr,
    OptimizationDirection,
    Problem,
    Solution,
    SolverFailure,
    Unbounded,
    Variable,
)
from .options import DEFAULT_OPTIONS, SolverOptions
from .status import Status, VarStat

__version__ = "0.1.0"

__all__ = [
    "ComparisonOp",
    "DEFAULT_OPTIONS",
    "Error",
    "Infeasible",
    "LinearExpr",
    "OptimizationDirection",
    "Problem",
    "Solution",
    "SolverFailure",
    "SolverOptions",
    "Status",
    "Unbounded",
    "VarStat",
    "Variable",
    "__version__",
]
