"""k1_fallback_pct.cold: the share of K1's routes whose claim failed its
f64 check, in %: the program's counters `route.megakernel.polished` (the
host polished K1's basis) and `route.megakernel.declined` (a claim other
than optimal, handed on to the f64 engine) over `route.megakernel` (the
routes entered), summed over the window's solves."""

from lpbench.readers import of_kind


def read(ctx):
    reqs = of_kind(ctx, "solve")
    if not any("megakernel_pivots" in r.stages for r in reqs):
        return None  # a program that does not count K1's claims
    entered = sum(r.stages.get("route.megakernel", 0) for r in reqs)
    if entered == 0:
        return None
    failed = sum(r.stages.get("route.megakernel.polished", 0)
                 + r.stages.get("route.megakernel.declined", 0) for r in reqs)
    return 100.0 * failed / entered
