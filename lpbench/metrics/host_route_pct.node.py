"""host_route_pct.node: the share of the window's nodes that the host route
finished (a `*_host` solve record, `MINILP_TPU_LOG`, traced runs), against
the nodes attempted, in %; the rest fell to K1, K2 or the f64 engines."""


def read(ctx):
    nodes = [r for r in ctx.requests if r.kind.startswith("node:")]
    if not nodes or not any(r.records for r in ctx.requests):
        return None
    host = sum(any(rec["event"].endswith("_host") for rec in r.records) for r in nodes)
    return 100.0 * host / len(nodes)
