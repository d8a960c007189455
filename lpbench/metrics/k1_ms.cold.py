"""k1_ms.cold: K1's launch in a cold solve, in ms: the program's stage
`megakernel_launch_s` (the launch and the copy of its result rows, the card
synchronised at both ends while tracing); mean over the window's solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "megakernel_launch_s")
