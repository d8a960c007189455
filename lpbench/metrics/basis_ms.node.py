"""basis_ms.node: the final-basis certificate of a node on the card, in ms:
the program's stage `basis_dev_s`; mean over the window's nodes."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "node:"), "basis_dev_s")
