"""Profiling hooks (SURVEY.md §6.1), PyTorch port.

Stage timers give a coarse host-side wall-clock attribution of one solve
(presolve / canonicalize / kernel / polish / certify), read by a benchmark
through `stages()`.  A stage that launches work on a CUDA device passes that
device: its timer then synchronises the device before reading the clock at
both ends, so the stage owns its own device time and not its predecessor's.
`device_stage` times a device's own work by CUDA events instead
(`basis_dev_s`: the basis kernel's launches of a solve).
`trace()` packages `torch.profiler` for a block of solves.
"""

from __future__ import annotations

import contextlib
import time

import torch

# Not thread-safe by design (one diagnosed solve at a time), as in the JAX
# package.
_stages: dict[str, float] = {}


def reset_stages() -> None:
    _stages.clear()


def record_stage(name: str, seconds: float) -> None:
    _stages[name] = _stages.get(name, 0.0) + float(seconds)


def bump_stage(name: str, count: int = 1) -> None:
    """Add to an integer counter kept beside the stage walls."""
    _stages[name] = _stages.get(name, 0) + count


def stages(ndigits: int | None = 3) -> dict[str, float]:
    """Snapshot of the accumulated stage walls (seconds, rounded to
    `ndigits`, or unrounded for None) and counters."""
    return {k: (round(v, ndigits) if isinstance(v, float) and ndigits is not None else v)
            for k, v in _stages.items()}


def _sync(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


@contextlib.contextmanager
def stage(name: str, device: torch.device | None = None):
    _sync(device)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        _sync(device)
        record_stage(name, time.perf_counter() - t0)


@contextlib.contextmanager
def device_stage(name: str, device: torch.device | None):
    """A stage timed on a CUDA `device` by CUDA events around what the block
    enqueues on the current stream: the device's own time, without the
    host's.  The time is read when the block's work has ended (the exit
    waits for it).  On any other device the block runs untimed."""
    if device is None or torch.device(device).type != "cuda":
        yield
        return
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    yield
    stop.record()
    stop.synchronize()
    record_stage(name, start.elapsed_time(stop) / 1e3)


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile a block of solves on the CPU and every CUDA device:

        with profiling.trace("trace_out") as prof:
            prob.solve()
        print(prof.key_averages().table(sort_by="cuda_time_total"))

    Writes a Chrome trace (`trace.json`) into `log_dir` on exit, for
    chrome://tracing or ui.perfetto.dev.
    """
    import pathlib

    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    out = pathlib.Path(log_dir)
    out.mkdir(parents=True, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
