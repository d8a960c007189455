"""prep_ms.cold: the API, presolve and canonicalize of a cold solve, in ms:
the harness's clock around building the Problem, plus the program's stages
`presolve_s` and `canonicalize_s`; mean over the window's solves."""

import numpy as np


def read(ctx):
    reqs = [r for r in ctx.requests if r.kind == "solve" and not r.failed]
    if not reqs:
        return None
    return 1e3 * float(np.mean([r.extra["build_s"] + r.stages.get("presolve_s", 0.0)
                                + r.stages.get("canonicalize_s", 0.0) for r in reqs]))
