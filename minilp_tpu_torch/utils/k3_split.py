"""Where K3's time goes at the bench's batch, by parameter variation and by a
per-phase clock split, on one CUDA card.

    python3 -m minilp_tpu_torch.utils.k3_split [--layout L] [--no-clocks] [--out FILE]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
On `bench.py`'s batched shape (`random_batch(0, 1024, 32, 96)`: 1024 LPs of
32 x 128, pack 8, `slack0` 96, `max_iter` 2000, the refresh period 32) it
times these launches of K3 by CUDA events:

* the default launch (mean of 5): ms, pivots, and the pack iterations as the
  pivots' pack maxima (their sum, and their maximum: the slowest pack, which
  sets the launch's wall, since the 128 packs run in one wave on 132 SMs);
* 64 pivots with `refactor_period=1` and 64 with period 10⁹: the first
  refreshes the pack after each of its 63 later pivots, the second only at
  a phase change or a forced check, so one refresh costs their difference
  over 63;
* `max_iter=1`: the start (A staged, the first recompute) and the exit.

The default launch less the start and the slowest pack's refreshes (one per
32 of its iterations), over that pack's iterations, is the time of one
lockstep iteration.  Changing the period changes the pivot path, so the
split is an estimate.  Unless `--no-clocks`, a second build of the kernel
with `-DK3_CLOCKS` runs the default launch again and sums `clock64()`
cycles per phase of an iteration (pack barrier, the refresh's Newton sweeps
and its recompute, the phase-1 costs and duals, pricing, FTRAN, ratio test,
rank-1 update, pivot row, status) over every running LP's iterations; it
prints their means per iteration and the share of iterations that refresh.  `--layout` forces the
kernel's layout (`packed_simplex.LAYOUTS`); `--out` saves the default
launch's output rows (int32, .npy) for a comparison of two trees.  Prints
one JSON line and the card's name and power limit as `nvidia-smi` gives
them.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

BATCH, M, NV, PACK = 1024, 32, 96, 8  # bench.py's batched line
DEVICE = "cuda"
PERIOD = 32
KERNEL_KW = dict(feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6, bland_after=200)
PHASES = ("barrier", "newton", "recompute", "duals", "pricing", "ftran", "ratio", "update",
          "row", "status")


def _timed(torch, fn, reps=1):
    """(last result, mean ms per call) by CUDA events."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


def split(layout=None, clocks=True, out_path=None) -> dict:
    import ctypes

    import numpy as np
    import torch

    from ..ops.kernels import packed_simplex as ps
    from .synth import random_batch

    args = ps.upload_packed(*random_batch(0, BATCH, M, NV), pack=PACK, device=DEVICE)
    kw = dict(pack=PACK, slack0=NV, **KERNEL_KW)
    if layout is not None:
        kw["layout"] = layout

    def run(max_iter=2000, refactor_period=PERIOD, reps=1):
        out, ms = _timed(torch, lambda: ps.packed_kernel_call(
            *args, max_iter=max_iter, refactor_period=refactor_period, **kw), reps)
        niter = out[..., -1].cpu().numpy()  # (packs, pack)
        return out, dict(ms=ms, pivots=int(niter.sum()),
                         pack_iters_sum=int(niter.max(1).sum()),
                         pack_iters_max=int(niter.max()))

    run(max_iter=1)  # builds and loads the kernel outside the timings
    out, full = run(reps=5)
    every = run(max_iter=64, refactor_period=1)[1]
    never = run(max_iter=64, refactor_period=10**9)[1]
    one = run(max_iter=1)[1]
    refresh_ms = (every["ms"] - never["ms"]) / 63
    refreshes = full["pack_iters_max"] // PERIOD
    iter_us = (full["ms"] - one["ms"] - refreshes * refresh_ms) / full["pack_iters_max"] * 1e3
    res = dict(batch=BATCH, m=M, n=M + NV, pack=PACK, default=full,
               refresh_every_pivot_64=every, refresh_never_64=never, one_pivot=one,
               refresh_ms=refresh_ms, refreshes=refreshes, iter_us=iter_us,
               layout=ps.pick_layout(PACK, M, M + NV, layout))
    res["smem_bytes"] = ps.smem_bytes(PACK, M, M + NV, res["layout"])
    if out_path:
        np.save(out_path, out.cpu().numpy())
    if clocks:
        lib = ps._library(("K3_CLOCKS",))
        sums = (ctypes.c_ulonglong * (len(PHASES) + 2))()
        lib.packed_simplex_clocks.argtypes = [ctypes.c_void_p]
        lib.packed_simplex_clocks.restype = ctypes.c_int
        lib.packed_simplex_clocks(ctypes.addressof(sums))  # zero them
        ps._launch(lib, *args, max_iter=2000, refactor_period=PERIOD,
                   **dict(kw, layout=res["layout"]))
        if lib.packed_simplex_clocks(ctypes.addressof(sums)) != 0:
            raise RuntimeError("reading K3's phase clocks failed")
        iters = max(int(sums[len(PHASES)]), 1)
        res["clock_iterations"] = iters
        res["refresh_share"] = int(sums[len(PHASES) + 1]) / iters
        res["cycles_per_iteration"] = {ph: sums[i] / iters for i, ph in enumerate(PHASES)}
    return res


def main(argv: list[str]) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--layout", default=None)
    ap.add_argument("--no-clocks", action="store_true")
    ap.add_argument("--out", default=None)
    opt = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("k3_split: no CUDA device is available", file=sys.stderr)
        return 3
    print(json.dumps(split(opt.layout, not opt.no_clocks, opt.out)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
