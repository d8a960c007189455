"""unspanned_ms.cold: the time of a cold solve that no span inside it
names, in ms: the self time of the program's root span `solve`
(`solve_self_s`: its wall less what its direct children cover); mean over
the window's solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "solve_self_s")
