"""host_resolve_ms.node: the host's exact re-solve of a node, in ms: the
`wall_s` of the `*_host` solve records (`MINILP_TPU_LOG`, traced runs) a
node wrote; mean over the nodes that the host route finished."""

import numpy as np


def read(ctx):
    walls = [sum(rec["wall_s"] for rec in r.records if rec["event"].endswith("_host"))
             for r in ctx.requests if r.kind.startswith("node:")
             and any(rec["event"].endswith("_host") for rec in r.records)]
    return 1e3 * float(np.mean(walls)) if walls else None
