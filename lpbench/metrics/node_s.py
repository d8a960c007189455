"""node_s: the mean wall of a branch-and-cut node (one `Solution` edit and
its warm re-solve, a device synchronise), over every node of the window."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.requests if r.kind.startswith("node:")]
    return float(np.mean(walls)) if walls else None
