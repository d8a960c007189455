"""k1_pivots.cold: K1's pivots in a cold solve: the program's counter
`megakernel_pivots` (each launch's `niter`); mean over the window's solves."""

import numpy as np

from lpbench.readers import of_kind


def read(ctx):
    reqs = of_kind(ctx, "solve")
    if not any("megakernel_pivots" in r.stages for r in reqs):
        return None
    return float(np.mean([r.stages.get("megakernel_pivots", 0) for r in reqs]))
