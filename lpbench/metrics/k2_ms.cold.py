"""k2_ms.cold: K2's launches in a cold solve, in ms: the program's stages
`stream_first_launch_s` + `stream_chunks_s`; mean over the window's solves."""

from lpbench.readers import mean_ms, of_kind


def read(ctx):
    return mean_ms(of_kind(ctx, "solve"), "stream_first_launch_s", "stream_chunks_s")
