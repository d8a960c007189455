"""Where K1's time goes on the single-LP path, by parameter variation, on one
CUDA card.

    python3 -m minilp_tpu_torch.utils.k1_split [256x1024] [512x2048]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
For each `single_lp` shape of `bench.py` (`netlib_shaped_problem(...,
seed=11)`, presolved and canonicalized: padded (256, 1024) and (504, 2048))
it takes the launch that `Problem.solve()` makes through K1 (one LP,
`slack0` = the structural count, `max_iter` from `SolverOptions`, the
kernel's default refresh period of 32) and times these launches of the
kernel by CUDA events:

* the default run: its pivots and status;
* 64 pivots with `refactor_period=1` and 64 with period 10⁹: the first
  refreshes after each of its 63 later pivots, the second only at a phase
  change, so one refresh costs their difference over 63;
* one pivot: the start's recompute, and the exit.

The default run less its refreshes (one per 32 pivots), over its pivots,
is the cost of one pivot.  Changing the period changes the pivot path, so
the split is an estimate; the kernel has no timer of its own.  Every launch
is the wrapper's default: one cooperative grid of `k1_grid_blocks` blocks
(one per SM at these shapes).  Prints one JSON line per shape (with the
grid's blocks and the card's SM count) and the card's name and power limit
as `nvidia-smi` gives them.
"""

from __future__ import annotations

import json
import subprocess
import sys

SHAPES = {"256x1024": (250, 760, 0.05), "512x2048": (500, 1530, 0.03)}
DEVICE = "cuda"
PERIOD = 32  # solve_batch_megakernel's refactor_period
KERNEL_KW = dict(feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6, bland_after=200)


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
    import numpy as np
    import torch

    from ..canonical import canonicalize
    from ..ops.kernels import batched_simplex as bs
    from ..options import SolverOptions
    from ..presolve import presolve_problem
    from .synth import netlib_shaped_problem

    can = canonicalize(presolve_problem(netlib_shaped_problem(*SHAPES[tag], seed=11))[0])
    args = [torch.tensor(np.asarray(x, dtype=np.float32)[None], device=DEVICE)
            for x in (can.A, can.b, can.c, can.lo, can.hi)]
    m, n = can.A.shape
    max_iter = SolverOptions().effective_max_iter(can.M, can.N)
    sm_count, per_sm = bs.grid_limits(args[0].device)
    blocks = bs.k1_grid_blocks(m, n, sm_count, per_sm)

    def run(max_iter=max_iter, refactor_period=PERIOD):
        out, ms = _timed(torch, lambda: bs.simplex_kernel_call(
            *args, slack0=can.nv, max_iter=max_iter, refactor_period=refactor_period,
            **KERNEL_KW))
        status, pivots = out[0, -2:].tolist()
        return dict(ms=ms, status=status, pivots=pivots)

    run(max_iter=1)  # builds and loads the kernel outside the timings
    full = run()
    every = run(max_iter=64, refactor_period=1)
    never = run(max_iter=64, refactor_period=10**9)
    one = run(max_iter=1)
    refresh_ms = (every["ms"] - never["ms"]) / (every["pivots"] - 1)
    refreshes = full["pivots"] // PERIOD
    pivot_ms = (full["ms"] - refreshes * refresh_ms) / full["pivots"]
    return dict(shape=tag, m=m, n=n, blocks=blocks, sm_count=sm_count, default=full,
                refresh_every_pivot_64=every, refresh_never_64=never, one_pivot=one,
                refresh_ms=refresh_ms, refreshes=refreshes, pivot_ms=pivot_ms)


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_split: no CUDA device is available", file=sys.stderr)
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
