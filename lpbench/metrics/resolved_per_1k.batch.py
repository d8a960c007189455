"""resolved_per_1k.batch: the lanes that failed the certificate and HiGHS
re-solved (the program's counter `batch_resolved`), per 1000 LPs attempted."""


def read(ctx):
    calls = [r for r in ctx.requests if r.kind == "call" and not r.failed]
    n = sum(r.n_lps for r in calls)
    if n == 0:
        return None
    return 1e3 * sum(r.stages.get("batch_resolved", 0) for r in calls) / n
