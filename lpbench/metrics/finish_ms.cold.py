"""finish_ms.cold: a cold solve from the return of K2's last launch to the
`Solution`, in ms: the program's span `finish_s` (the basis kernel's launch
and copy back, the state rebuild, `EngineHandle.certify`, the `Solution`);
mean over the window's solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "finish_s")
