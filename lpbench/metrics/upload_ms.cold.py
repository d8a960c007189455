"""upload_ms.cold: the host-to-device copies of a cold solve's inputs, in
ms: the program's span `upload_s` (K2's Aᵀ and vectors, the basis kernel's
f64 A and vectors; the device synchronised at both ends while tracing);
mean over the window's solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "upload_s")
