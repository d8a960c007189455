"""k2_fallback_pct.cold: the share of K2's routes whose basis failed its
f64 check, in %: the program's counters `route.streaming.polished` (the
host polished it) and `route.streaming.declined` (a host engine solved
again) over `route.streaming` (the routes entered), summed over the
window's solves."""

from lpbench.readers import of_kind


def read(ctx):
    reqs = of_kind(ctx, "solve")
    entered = sum(r.stages.get("route.streaming", 0) for r in reqs)
    if entered == 0:
        return None
    failed = sum(r.stages.get("route.streaming.polished", 0)
                 + r.stages.get("route.streaming.declined", 0) for r in reqs)
    return 100.0 * failed / entered
