"""k3_roofline: K3's least time over its time in the device trace, in %.

The least time is `bounds.dense_simplex_work` on every lane's pivots in the
window (each batch's `niter`) at the configuration's shape (m rows, m + nv
columns), over the card's peaks; K3's time is the device ops named
`packed_kernel`.  The operations set it (2mn + 4m² a pivot)."""

from lpbench import bounds
from lpbench.readers import roofline_pct


def read(ctx):
    if ctx.peaks is None or not ctx.info.get("niter"):
        return None
    shape = ctx.info["shape"]
    m, n = shape["rows"], shape["rows"] + shape["cols"]
    flops = nbytes = 0.0
    for it in ctx.info["niter"]:
        f, b = bounds.dense_simplex_work(it, m, n)
        flops, nbytes = flops + f, nbytes + b
    return roofline_pct(ctx, "packed_kernel", bounds.seconds(flops, nbytes, ctx.peaks)[0])
