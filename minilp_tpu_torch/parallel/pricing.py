"""Column-partitioned (tensor-parallel) pricing across the mesh's 'model'
axis, PyTorch port of `minilp_tpu/parallel/pricing.py`.

Each rank of the model group prices its own columns of the reduced-cost
vector, and the global entering column comes from one deterministic
argmax-with-index reduction (`collectives.argmax_with_index`).  Ties go to
the lowest global index, so the choice is the single-device
`ops.pricing.choose_entering`'s (the determinism gate).
"""

from __future__ import annotations

import torch

from ..ops.pricing import EnteringChoice, entering_scores
from .collectives import argmax_with_index, exact_sum
from .mesh import COL_AXIS, column_block


def global_choice(score: torch.Tensor, bland_elig, offset: int, group):
    """(best score, global column) over the group: this rank's argmax of
    `score` (−inf where not a candidate), or under Bland the lowest index
    of the mask `bland_elig` (scored −index, so that the same reduction
    picks the lowest), then `argmax_with_index` across the ranks."""
    if bland_elig is not None:
        idx = torch.arange(score.shape[0], device=score.device)
        j = torch.argmin(torch.where(bland_elig, idx, score.shape[0]))
        local = torch.where(bland_elig.any(), -(offset + j).to(score.dtype),
                            torch.tensor(-torch.inf, dtype=score.dtype, device=score.device))
    else:
        j = torch.argmax(score)
        local = score[j]
    return argmax_with_index(local, offset + j, group)


def choose_entering_sharded(mesh, d, vstat, opt_tol: float,
                            bland: bool = False) -> EnteringChoice:
    """Entering-column choice with `d`/`vstat` (global, length N) sharded
    over the columns.

    Dantzig scoring (|d|² masked by eligibility); `bland=True` switches to
    the lowest-global-index rule.  Every rank of the model group returns the
    same EnteringChoice as the single-device op.
    """
    group = mesh.groups[COL_AXIS]
    d_loc, vstat_loc = column_block(mesh, d), column_block(mesh, vstat)
    n_loc = d_loc.shape[0]
    offset = mesh.coords[COL_AXIS] * n_loc
    score, elig = entering_scores(d_loc, vstat_loc, opt_tol)
    best, q = global_choice(score, elig if bland else None, offset, group)
    found = bool(best > -torch.inf)
    q = int(q)
    # fetch d[q] to fix the direction: the owning rank contributes, others 0
    owns = offset <= q < offset + n_loc
    dq = exact_sum(d_loc[q - offset] if owns else d_loc.new_zeros(()), group)
    return EnteringChoice(q=q, direction=1.0 if float(dq) < 0 else -1.0, found=found)
