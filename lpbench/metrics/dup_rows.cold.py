"""dup_rows.cold: the rows that presolve merged into an equal row in a cold
solve: the program's counter `presolve_parallel_rows`; mean over the
window's solves."""

import numpy as np

from lpbench.readers import of_kind


def read(ctx):
    reqs = of_kind(ctx, "solve")
    if not any("presolve_parallel_rows" in r.stages for r in reqs):
        return None
    return float(np.mean([r.stages.get("presolve_parallel_rows", 0) for r in reqs]))
