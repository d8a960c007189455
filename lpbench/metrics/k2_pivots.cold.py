"""k2_pivots.cold: K2's pivots in a cold solve: the program's counter
`stream_pivots` (each launch's pivots, from K2's monitor, summed over the
chunks); mean over the window's solves."""

import numpy as np

from lpbench.readers import of_kind


def read(ctx):
    reqs = of_kind(ctx, "solve")
    if not any("stream_pivots" in r.stages for r in reqs):
        return None
    return float(np.mean([r.stages.get("stream_pivots", 0) for r in reqs]))
