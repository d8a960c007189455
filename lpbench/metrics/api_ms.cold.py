"""api_ms.cold: the API's calls that build a cold request's LP, in ms: the
program's stage `api_s` (the walls of `Problem.add_var` and
`Problem.add_constraint`, summed while tracing); mean over the window's
solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "api_s")
