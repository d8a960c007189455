"""certify_ms.batch: the batch certificate on the card, in ms: the program's
stage `batch_verify_dev_s` (CUDA events) over the window's batches."""

from lpbench.readers import per_batch_ms


def read(ctx):
    return per_batch_ms(ctx, "batch_verify_dev_s")
