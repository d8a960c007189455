"""basis_ms.cold: the final-basis certificate of a cold solve on the card, in
ms: the program's stage `basis_dev_s` (CUDA events around the basis
kernel's launches); mean over the window's solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "basis_dev_s")
