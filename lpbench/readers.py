"""Helpers of the metric readers in `lpbench/metrics/`.

A reader gets a `Context`: the window's requests (`core.Request`), the
window's wall, what the traffic kind handed back (`Run.info`), the device
trace (`trace.Trace`, in a traced run on a card only) and the card's peaks
(`bounds.PEAKS`, None for another device).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class Context:
    requests: list
    window_s: float
    info: dict
    trace: object = None
    peaks: dict | None = None


def of_kind(ctx, prefix: str) -> list:
    return [r for r in ctx.requests if r.kind.startswith(prefix)]


def mean_ms(reqs, *stages) -> float | None:
    """Mean over `reqs` of the sum of `stages` in each, in ms; None when no
    request has any of them."""
    if not any(s in r.stages for r in reqs for s in stages):
        return None
    return 1e3 * float(np.mean([sum(r.stages.get(s, 0.0) for s in stages) for r in reqs]))


def per_batch_ms(ctx, stage: str) -> float | None:
    """A batched stage's seconds over the window's batches, in ms."""
    calls = of_kind(ctx, "call")
    n = len(ctx.info.get("niter", ()))  # one entry per batch solved
    if n == 0 or not any(stage in r.stages for r in calls):
        return None
    return 1e3 * sum(r.stages.get(stage, 0.0) for r in calls) / n


def idle_pct(ctx) -> float | None:
    if ctx.trace is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s / ctx.trace.window_s)


def roofline_pct(ctx, kernel: str, least_s: float) -> float | None:
    """The least seconds over the kernel's seconds in the trace, in %."""
    if ctx.trace is None or ctx.peaks is None:
        return None
    spent = ctx.trace.kernel_time(kernel)
    if spent <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / spent
