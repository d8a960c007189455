"""prep_ms.batch: the prefetch thread's copy of a batch into pinned memory
and its enqueue, in ms: the program's stage `batch_prep_s` over the
window's batches."""

from lpbench.readers import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, "batch_prep_s")
