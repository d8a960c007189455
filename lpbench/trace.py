"""The device trace of a `--trace 1` run: `torch.profiler` over the whole
measured window, reduced to the device's busy time, each kernel's time by
name, and the idle gaps by what the host was doing.

The window is the host span "lpbench.window"; a device event is any event
the profiler puts on the card (kernels, copies, sets) but the copies of the
host spans that it draws there.  The busy time is the
union of their intervals inside the window.  An idle gap is named by the
innermost "lpbench.*" span that covers its middle.
"""

from __future__ import annotations

import contextlib
import dataclasses

import numpy as np

WINDOW_SPAN = "lpbench.window"


@dataclasses.dataclass
class Trace:
    window_s: float
    busy_s: float
    kernel_s: dict        # device op name -> seconds in the window
    idle_gaps: list       # [(host span, seconds)], the largest 10
    device_ops: list      # [(device op name, seconds)], the largest 10

    def kernel_time(self, fragment: str) -> float:
        """Seconds of the device ops whose name holds `fragment`."""
        return sum(s for name, s in self.kernel_s.items() if fragment in name)


@contextlib.contextmanager
def profiled():
    """Profile the CPU and the card; yields a holder whose `prof` is the
    stopped profiler once the block has ended."""
    import torch

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    holder = type("Holder", (), {"prof": None})()
    with torch.profiler.profile(activities=acts) as prof:
        yield holder
    holder.prof = prof


def reduce(prof) -> Trace:
    from torch.autograd import DeviceType

    dev, spans = [], []
    window = None
    for e in prof.events():
        t0, t1 = e.time_range.start, e.time_range.end
        if e.name.startswith("lpbench."):
            # the host spans, and their copies on the card's timeline (user
            # annotations, which are no device work)
            if e.device_type != DeviceType.CUDA:
                if e.name == WINDOW_SPAN:
                    window = (t0, t1)
                else:
                    spans.append((t0, t1, e.name))
        elif e.device_type == DeviceType.CUDA:
            dev.append((t0, t1, e.name))
    if window is None:
        raise RuntimeError(f"the trace has no {WINDOW_SPAN} span")
    w0, w1 = window
    kernel_s: dict[str, float] = {}
    ivals = []
    for t0, t1, name in dev:
        a, b = max(t0, w0), min(t1, w1)
        if b > a:
            kernel_s[name] = kernel_s.get(name, 0.0) + (b - a) * 1e-6
            ivals.append((a, b))
    ivals.sort()
    merged = []
    for a, b in ivals:
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    busy = sum(b - a for a, b in merged) * 1e-6
    # the idle gaps, each named by the innermost lpbench span over its middle
    edges = [w0] + [x for ab in merged for x in ab] + [w1]
    gaps = [(edges[k], edges[k + 1]) for k in range(0, len(edges), 2) if edges[k + 1] > edges[k]]
    by_name: dict[str, float] = {}
    if spans:
        s0 = np.array([s[0] for s in spans])
        s1 = np.array([s[1] for s in spans])
        names = [s[2] for s in spans]
        for a, b in gaps:
            mid = 0.5 * (a + b)
            cover = np.flatnonzero((s0 <= mid) & (s1 >= mid))
            name = names[cover[np.argmin((s1 - s0)[cover])]] if cover.size else "outside spans"
            by_name[name] = by_name.get(name, 0.0) + (b - a) * 1e-6
    else:
        by_name["outside spans"] = sum(b - a for a, b in gaps) * 1e-6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return Trace(window_s=(w1 - w0) * 1e-6, busy_s=busy, kernel_s=kernel_s,
                 idle_gaps=[list(kv) for kv in top(by_name)],
                 device_ops=[list(kv) for kv in top(kernel_s)])
