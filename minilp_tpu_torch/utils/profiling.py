"""Spans and counters of the port (SURVEY.md §6.1): one system from a
public entry point down to the kernels, read by a benchmark through
`stages()` and `spans()`.

**Spans.**  `span(name, device=None, host=False)` times a block and adds
its wall to the stages under `<name>_s`.  `request(name)` is the root span
of a public entry point: `Problem.solve()` opens "solve", each `Solution`
edit's re-solve "resolve", each batch call "batch_call".  It draws a fresh
request id, which every span under it shares, and when it ends it also
adds its self time, its wall less what its direct children cover, under
`<name>_self_s`.  `begin(name)` opens a span that ends with its request
("finish": from K2's last launch to the `Solution`).  `summed(name)` wraps
a function whose calls are too many to be spans (the API's `add_var` and
`add_constraint`): their walls add up under `<name>_s` and their count
under `<name>_calls`.

**Counters.**  `bump_stage(name)` counts beside the walls (`route.<name>`,
`stream_pivots`); `record_stage` adds seconds measured otherwise, as
`device_stage` does from CUDA events (`basis_dev_s`).

**On and off.**  Tracing is on while a `torch.profiler` records, or after
`enable()`.  Then:

* a span keeps a record (`SpanRecord`: name, start, end, parent, request
  id, host) on a stack of its thread; `within` lends an open span to another
  thread (the batched path's prefetch thread).  Finished spans go to a
  ring of the last `RING`, which `spans()` returns and `reset_stages()`
  clears;
* a span given a `device` synchronises it at both ends, so that it owns
  its device time and not its predecessor's;
* a span marked `host`, one that enqueues no device work (no kernel, copy
  or `.cpu()`), is also a profiler range "minilp.<name>" with the args
  "request=<id>", so it lies on the profiler's clock beside the CUDA
  events.  A span that encloses device work is never a profiler range:
  the profiler would draw it on the card's timeline as a user annotation,
  which a reading of that timeline counts as device time.

When tracing is off a span costs one flag check and its `perf_counter`
pair: it synchronises nothing, keeps no record and opens no profiler
range; `begin`, `summed` and `device_stage` do nothing.

`trace()` packages `torch.profiler` for a block of solves.
"""

from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time
from typing import NamedTuple, Optional

import torch
from torch.autograd import profiler as _autograd_profiler

#: finished spans kept while tracing, the oldest dropped first
RING = 1 << 16

# Stage walls and counters: one diagnosed solve at a time, as in the JAX
# package; the batched path's prefetch thread adds its own keys.
_stages: dict[str, float] = {}
_enabled = False
_ring: collections.deque = collections.deque(maxlen=RING)
_span_ids = itertools.count(1)
_request_ids = itertools.count(1)
_local = threading.local()


class SpanRecord(NamedTuple):
    id: int
    name: str
    request: Optional[int]  # the id of the request it ran in
    parent: Optional[int]   # the id of the span it ran under
    start: float            # time.perf_counter() seconds
    end: float
    host: bool              # a host span: a profiler range while one records


def enable(on: bool = True) -> bool:
    """Trace without a profiler (or stop); returns the setting it
    replaced.  A benchmark that publishes a breakdown of synchronised
    stages calls it."""
    global _enabled
    previous, _enabled = _enabled, bool(on)
    return previous


def tracing() -> bool:
    return _enabled or _autograd_profiler._is_profiler_enabled


def reset_stages() -> None:
    _stages.clear()
    _ring.clear()


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


def spans() -> list[SpanRecord]:
    """The finished spans kept since `reset_stages()`, in the order they
    ended."""
    return list(_ring)


def _sync(device: torch.device | None) -> None:
    if device is not None and device.type == "cuda":
        torch.cuda.synchronize(device)


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Frame:
    """A span open while tracing."""

    __slots__ = ("id", "name", "request", "parent", "root", "host", "start", "children",
                 "range")

    def __init__(self, name: str, parent: Optional["_Frame"], root: bool, request=None,
                 host: bool = False):
        self.id = next(_span_ids)
        self.name = name
        self.parent = parent
        self.root = root
        self.host = host
        self.request = request if request is not None else (parent.request if parent else None)
        self.start = 0.0
        self.children: list[tuple[float, float]] = []
        self.range = None


def _covered(intervals, a: float, b: float) -> float:
    """Seconds of [a, b] that the union of `intervals` covers."""
    total, reach = 0.0, a
    for s, e in sorted(intervals):
        s, e = max(s, reach), min(e, b)
        if e > s:
            total += e - s
            reach = e
    return total


def _finish(frame: _Frame, end: float) -> None:
    wall = end - frame.start
    record_stage(frame.name + "_s", wall)
    if frame.range is not None:
        frame.range.__exit__(None, None, None)
    parent = frame.parent
    if parent is not None:
        parent.children.append((frame.start, end))
    if frame.root:
        record_stage(frame.name + "_self_s",
                     wall - _covered(frame.children, frame.start, end))
    _ring.append(SpanRecord(frame.id, frame.name, frame.request,
                            None if parent is None else parent.id, frame.start, end,
                            frame.host))


class span:
    """A timed block (module docstring); after it, `wall_s` holds its
    wall, traced or not."""

    __slots__ = ("name", "device", "host", "wall_s", "_t0", "_frame")
    _root = False

    def __init__(self, name: str, device: torch.device | None = None, *, host: bool = False):
        self.name = name
        self.device = device
        self.host = host
        self.wall_s = None
        self._frame = None

    def __enter__(self) -> "span":
        frame = None
        if _enabled or _autograd_profiler._is_profiler_enabled:
            _sync(self.device)
            stack = _stack()
            parent = stack[-1] if stack else None
            if self._root and parent is None:
                frame = _Frame(self.name, None, True, next(_request_ids))
            else:
                frame = _Frame(self.name, parent, False, host=self.host)
            if self.host and _autograd_profiler._is_profiler_enabled:
                frame.range = torch.profiler.record_function(
                    f"minilp.{self.name}", f"request={frame.request}")
                frame.range.__enter__()
            stack.append(frame)
        self._frame = frame
        self._t0 = time.perf_counter()
        if frame is not None:
            frame.start = self._t0
        return self

    def __exit__(self, *exc) -> bool:
        frame = self._frame
        if frame is None:
            t1 = time.perf_counter()
            self.wall_s = t1 - self._t0
            record_stage(self.name + "_s", self.wall_s)
            return False
        _sync(self.device)
        t1 = time.perf_counter()
        self.wall_s = t1 - self._t0
        stack = _stack()
        if frame.root:  # the spans begun in the request end with it
            while stack and stack[-1] is not frame:
                _finish(stack.pop(), t1)
        if frame in stack:  # on top, or under a span begun in its request
            stack.remove(frame)
        _finish(frame, t1)
        self._frame = None
        return False


class request(span):
    """The root span of a public entry point, with a fresh request id; one
    opened inside another request is an ordinary span of it."""

    __slots__ = ()
    _root = True

    def __init__(self, name: str):
        super().__init__(name)


def begin(name: str) -> None:
    """While tracing: open a span from now to the end of the request that
    this thread is in, a direct child of its root; nothing outside a
    request or while one of that name is open."""
    if not (_enabled or _autograd_profiler._is_profiler_enabled):
        return
    stack = _stack()
    root = next((f for f in stack if f.root), None)
    if root is None or any(f.name == name for f in stack):
        return
    frame = _Frame(name, root, False)
    frame.start = time.perf_counter()
    stack.append(frame)


def current():
    """The innermost span open on this thread while tracing, else None."""
    stack = getattr(_local, "stack", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def within(frame):
    """Run a block on this thread under `frame`, a span open on another
    thread (`current()` there): its spans join that span's request."""
    if frame is None:
        yield
        return
    stack = _stack()
    stack.append(frame)
    try:
        yield
    finally:
        if frame in stack:
            stack.remove(frame)


def summed(name: str):
    """Decorator: while tracing, the walls of the function's calls add up
    under `<name>_s` and their count under `<name>_calls`."""
    key, calls = name + "_s", name + "_calls"

    def wrap(fn):
        @functools.wraps(fn)
        def timed(*args, **kw):
            if not (_enabled or _autograd_profiler._is_profiler_enabled):
                return fn(*args, **kw)
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                record_stage(key, time.perf_counter() - t0)
                bump_stage(calls)

        return timed

    return wrap


@contextlib.contextmanager
def device_stage(name: str, device: torch.device | None):
    """While tracing, a stage timed on a CUDA `device` by CUDA events around
    what the block enqueues on the current stream: the device's own time,
    without the host's.  The time is read when the block's work has ended
    (the exit waits for it).  Untraced, or on any other device, the block
    runs untimed."""
    if not tracing() or device is None or torch.device(device).type != "cuda":
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
