"""Compute-path operations of the simplex engine, in torch.

Each op has a reference analog in `src/solver.rs` (SURVEY.md §3.1 C2) and is
the port of the JAX package's op of the same name; `kernels/` holds the
hand-written CUDA kernels with their plain torch versions.
"""

from .pricing import choose_entering, phase1_sigma, phase1_reduced_costs
from .ratio import ratio_test

__all__ = [
    "choose_entering",
    "phase1_sigma",
    "phase1_reduced_costs",
    "ratio_test",
]
