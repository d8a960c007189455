"""lps_per_s: LPs answered optimal and certified (a lane that HiGHS re-solved
counts once it is), over the whole window's wall."""


def read(ctx):
    calls = [r for r in ctx.requests if r.kind == "call"]
    return sum(r.n_certified for r in calls) / ctx.window_s if calls else None
