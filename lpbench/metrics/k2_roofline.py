"""k2_roofline: K2's least time over its time in the device trace, in %.

The least time is `bounds.streaming_work` on each cold solve's pivots (the
`cold_solve_streaming` record's iterations) at the instance's own shape (m
rows, m + nv columns: one slack a row), summed over the window, each solve's
work over the card's peaks; K2's time is the device ops named
`stream_kernel`.  The operations set it at 25fv47's shape (K2's refreshes,
8m³ + 2nm² each)."""

from lpbench import bounds
from lpbench.readers import roofline_pct


def read(ctx):
    if ctx.peaks is None:
        return None
    shape = ctx.info["shape"]
    m, n = shape["rows"], shape["rows"] + shape["cols"]
    least = 0.0
    for r in ctx.requests:
        for rec in r.records:
            if rec["event"] == "cold_solve_streaming":
                least += bounds.seconds(*bounds.streaming_work(m, n, rec["iterations"]),
                                        ctx.peaks)[0]
    return roofline_pct(ctx, "stream_kernel", least)
