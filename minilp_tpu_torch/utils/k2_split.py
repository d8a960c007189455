"""Where K2's time goes, by parameter variation, on one CUDA card.

    python3 -m minilp_tpu_torch.utils.k2_split [25fv47] [fit1p]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
For each Netlib shape (`netlib_shaped_problem(..., seed=1)`, presolved and
canonicalized) it takes the launch that `Problem.solve()`'s K2 route makes
first (`prepare_launch` with the driver's `streaming_options` under the
default `SolverOptions`, so n is padded as the main path pads it) and times
these launches of the kernel by CUDA events:

* the default run: pivots, majors and refreshes from the kernel's monitor;
* 64 pivots with `refactor_period=1` and 64 with period 10⁹: one refresh
  costs their difference over the difference of their refresh counts;
* one pivot: the start's x_B, d and steepest-edge weights, and the exit.

The default run's time less its refreshes, over its majors, is the cost of
one major.  Changing the period changes the pivot path, so the split is an
estimate; the kernel has no timer of its own.  Every launch is the
wrapper's cooperative grid (`k2_grid_blocks`: one block per SM at these
shapes).  Prints one JSON line per shape (with the grid's blocks and the
card's SM count) and the card's name and power limit as `nvidia-smi` gives
them.
"""

from __future__ import annotations

import json
import subprocess
import sys

SHAPES = {"25fv47": (821, 1571, 0.008), "fit1p": (627, 1677, 0.0095)}


def _timed(torch, fn):
    """(result, ms) of one call by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop)


def split(tag: str) -> dict:
    import torch

    from ..canonical import canonicalize
    from ..engine.driver import streaming_options
    from ..ops.kernels import streaming_simplex as ss
    from ..options import SolverOptions
    from ..presolve import presolve_problem
    from .synth import netlib_shaped_problem

    can = canonicalize(presolve_problem(netlib_shaped_problem(*SHAPES[tag], seed=1))[0])
    launch = ss.prepare_launch(can.A, can.b, can.c, can.lo, can.hi,
                               **streaming_options(can, SolverOptions()))
    m, n = launch.A.shape
    sm_count, per_sm = ss.grid_limits(launch.args[0].device)
    blocks = ss.k2_grid_blocks(m, n, sm_count, per_sm)

    def run(**over):
        out, ms = _timed(torch, lambda: ss.stream_kernel_call(
            *launch.args, launch.warm, blocks=blocks, **dict(launch.kw, **over)))
        status, pivots, _ph, _inf, _obj, majors, refreshes = out.monitor.tolist()
        return dict(ms=ms, status=status, pivots=pivots, majors=majors,
                    refreshes=refreshes)

    run(max_iter=1)  # builds and loads the kernel outside the timings
    full = run()
    every = run(max_iter=64, refactor_period=1)
    never = run(max_iter=64, refactor_period=10**9)
    one = run(max_iter=1)
    refresh_ms = (every["ms"] - never["ms"]) / (every["refreshes"] - never["refreshes"])
    major_ms = (full["ms"] - full["refreshes"] * refresh_ms) / full["majors"]
    return dict(shape=tag, m=m, n=n, blocks=blocks, sm_count=sm_count, default=full,
                refresh_every_pivot_64=every, refresh_never_64=never, one_pivot=one,
                refresh_ms=refresh_ms, major_ms=major_ms)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k2_split: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag in argv or list(SHAPES):
        print(json.dumps(split(tag)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
