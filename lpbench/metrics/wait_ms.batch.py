"""wait_ms.batch: the host blocked on a batch's results, in ms: the
program's stage `batch_wait_s` over the window's batches."""

from lpbench.readers import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, "batch_wait_s")
