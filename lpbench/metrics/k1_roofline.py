"""k1_roofline: K1's least time over its time in the device trace, in %.

The least time is `bounds.dense_simplex_work` on each cold solve's pivots
(the `cold_solve_megakernel` record's iterations) at the configuration's
shape (m rows, m + nv columns: one slack a row), not the shape presolve
leaves, so that the yardstick does not move with the program; summed over
the window, over the card's peaks.  Its refresh period, `bounds.K3_PERIOD`
(32), is K1's default `refactor_period` too.  K1's time is the device ops
whose name holds `simplex_kernel`, K1's kernel alone."""

from lpbench import bounds
from lpbench.readers import roofline_pct


def read(ctx):
    if ctx.peaks is None:
        return None
    shape = ctx.info["shape"]
    m, n = shape["rows"], shape["rows"] + shape["cols"]
    niter = [rec["iterations"] for r in ctx.requests for rec in r.records
             if rec["event"] == "cold_solve_megakernel"]
    if not niter:
        return None
    least = bounds.seconds(*bounds.dense_simplex_work(niter, m, n), ctx.peaks)[0]
    return roofline_pct(ctx, "simplex_kernel", least)
