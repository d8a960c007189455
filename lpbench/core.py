"""What every traffic kind shares: the request record, the measured window,
the solve records of the program, the trace spans and the answers.

A traffic kind (`lpbench/traffic/<kind>.py`) drives one "system" through
the window: the program (minilp_tpu_torch) in a benchmark run, or the
reference in a lower precision in a control run (`lpbench/control.py`).
It records one `Request` per request, and the per-layer readers
(`lpbench/metrics/<name>.py`) reduce those records.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pathlib
import tempfile
import time

import numpy as np


@dataclasses.dataclass
class Answer:
    """What a system said about one LP: "optimal" with its objective and
    variables, "infeasible", or "failed" (an error other than infeasibility)."""
    status: str
    obj: float | None = None
    x: np.ndarray | None = None


@dataclasses.dataclass
class Request:
    kind: str                 # "solve", "node:<edit>", "root", "call"
    wall_s: float             # host clock, after a device synchronise
    stages: dict              # the program's stage timers and counters in it
    n_lps: int = 1            # LPs the request asked for
    n_certified: int = 0      # of them answered and certified
    failed: bool = False      # an error other than an LP's own outcome
    records: list = dataclasses.field(default_factory=list)  # solve records in it
    extra: dict = dataclasses.field(default_factory=dict)    # kind-specific readings


class Window:
    """The measured window: requests start while `open()` is true, and the
    window ends when the last of them has ended."""

    def __init__(self, seconds: float):
        self.seconds = float(seconds)
        self.requests: list[Request] = []
        self.t0 = self.t1 = None

    def start(self) -> None:
        self.t0 = time.perf_counter()

    def open(self) -> bool:
        return time.perf_counter() - self.t0 < self.seconds

    def close(self) -> None:
        self.t1 = time.perf_counter()

    @property
    def wall_s(self) -> float:
        return self.t1 - self.t0


class Records:
    """The program's solve records (`MINILP_TPU_LOG`, one JSON line per solve
    or re-solve), read back after each request.  Kept only in a traced run:
    a file under the temporary directory, removed by `close()`."""

    def __init__(self, enabled: bool):
        self.path = None
        self._seen = 0
        if enabled:
            fd, name = tempfile.mkstemp(prefix="lpbench_records_", suffix=".jsonl")
            os.close(fd)
            self.path = pathlib.Path(name)
            os.environ["MINILP_TPU_LOG"] = name
        else:
            os.environ.pop("MINILP_TPU_LOG", None)

    def take(self) -> list[dict]:
        if self.path is None:
            return []
        lines = self.path.read_text().splitlines()
        new, self._seen = lines[self._seen:], len(lines)
        return [json.loads(line) for line in new]

    def close(self) -> None:
        if self.path is not None:
            os.environ.pop("MINILP_TPU_LOG", None)
            self.path.unlink(missing_ok=True)
            self.path = None


class Spans:
    """Named host spans for the device trace (`torch.profiler.record_function`)
    in a traced run; nothing otherwise."""

    def __init__(self, enabled: bool):
        self.enabled = enabled

    def __call__(self, name: str):
        if not self.enabled:
            return contextlib.nullcontext()
        import torch

        return torch.profiler.record_function(name)


@dataclasses.dataclass
class Run:
    """What a traffic kind's `run` hands back: the window, the LPs judged and
    the system's answers to them (index-aligned), and readings for the
    per-layer readers."""
    window: Window
    lps: list
    answers: list
    info: dict = dataclasses.field(default_factory=dict)


def seeded(seed: int, *keys: int) -> np.random.Generator:
    """A numpy generator from the run's seed (any whole number) and keys."""
    return np.random.default_rng([int(seed) % (1 << 64), *(int(k) % (1 << 64) for k in keys)])


def sample(seed: int, n: int, k: int, salt: int) -> list[int]:
    """k indices out of n, drawn from the seed (all of them when k >= n)."""
    if k >= n:
        return list(range(n))
    return sorted(int(i) for i in seeded(seed, salt).choice(n, size=k, replace=False))
