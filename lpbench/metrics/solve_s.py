"""solve_s: the mean wall of a cold request (build the LP through the API,
`Problem.solve()`, a device synchronise), over every request of the window."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.requests if r.kind == "solve"]
    return float(np.mean(walls)) if walls else None
