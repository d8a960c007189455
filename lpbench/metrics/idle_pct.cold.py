"""idle_pct: the share of the traced window in which no kernel, copy or set
ran on the card (`torch.profiler`), in %."""

from lpbench.readers import idle_pct


def read(ctx):
    return idle_pct(ctx)
