"""node_p95_s: the 95th percentile of the node walls, over every node of the
window (numpy's linear interpolation between order statistics)."""

import numpy as np


def read(ctx):
    walls = [r.wall_s for r in ctx.requests if r.kind.startswith("node:")]
    return float(np.percentile(walls, 95)) if walls else None
