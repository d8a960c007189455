"""Where K2's time goes, by parameter variation and by a per-part clock split
of a major, on one CUDA card.

    python3 -m minilp_tpu_torch.utils.k2_split [--no-clocks] [--against DIR] [SHAPE ...]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
For each Netlib shape (`netlib_shaped_problem(..., seed=1)`, presolved and
canonicalized; 25fv47 and fit1p by default) it takes the launch that
`Problem.solve()`'s K2 route makes first (`prepare_launch` with the
driver's `streaming_options` under the default `SolverOptions`, so n is
padded as the main path pads it) and times these launches of the kernel by
CUDA events, on the wrapper's cooperative grid (`k2_grid_blocks`: one block
per SM at these shapes) and on one block:

* the default run: pivots, majors and refreshes from the kernel's monitor;
* 64 pivots with `refactor_period=1` and 64 with period 10⁹: one refresh
  costs their difference over the difference of their refresh counts;
* one pivot: the start's x_B, d and steepest-edge weights, and the exit.

The default run's time less its refreshes, over its majors, is the cost of
one major.  Changing the period changes the pivot path, so the split is an
estimate.  Unless `--no-clocks`, a second build of the kernel with
`-DK2_CLOCKS` runs the default launch on the grid again and sums the
leader's `clock64()` cycles per part of a major (`PARTS`: the refresh's
steps, its barriers and the rest of it, pricing's y and its barrier, d,
local lists and barrier, the candidate merge, the tableau block W and its
barrier, the minors' parts: phase 1's candidate costs, the lane scan, the
ratio test and its reductions, the leaving row, and the pivot's update and
its accounting; the fold's gather, sums and barriers, and the rest); it
prints their means per major, their share of the launch's ms, that share
summed by group (refresh, pricing, merge, tableau, minors, fold, other),
and the refresh's parts as ms a refresh.
`--against DIR` builds the kernel of another checkout at DIR (one with the
same C interface, such as the parent commit unpacked by `git archive`) and
runs its default launch on the grid against this tree's, in turns (other,
this, this, other), reporting the times and whether every output (basis,
vstat, the bits of B⁻¹, the monitor) is bit for bit the same.  Prints one
JSON line per shape (with the grid's blocks and the card's SM count) and the
card's name and power limit as `nvidia-smi` gives them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

SHAPES = {"25fv47": (821, 1571, 0.008), "fit1p": (627, 1677, 0.0095)}
#: the kernel's clock parts (`Part` in streaming_simplex.cu), in its order;
#: "x.sync" is the grid barrier that ends step x, as the leader waits on it,
#: and "refresh.sync" every grid barrier of the refresh
PARTS = ("refresh.gather", "refresh.newton", "refresh.copy", "refresh.beff", "refresh.y",
         "refresh.matvec", "refresh.se", "refresh.sync", "refresh.other",
         "price.y", "price.y.sync", "price.d", "price.top", "price.sync", "merge",
         "tableau", "tableau.sync", "minors.costs", "minors.scan", "minors.ratio",
         "minors.row", "minors.update", "fold.gather", "fold.sync", "fold.sum",
         "fold.sync2", "other")


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


def _libraries(ss, variants):
    """The kernel's library for each tuple of defines, built together."""
    with ThreadPoolExecutor(max_workers=max(1, len(variants))) as pool:
        return dict(zip(variants, pool.map(ss._library, variants)))


def _other_library(ss, checkout):
    """K2's library built from the sources of another checkout."""
    path = subprocess.run(
        [sys.executable, "-c", "from minilp_tpu_torch.ops.kernels import build; "
         "print(build.load('streaming_simplex').path)"],
        cwd=checkout, capture_output=True, text=True, check=True, timeout=900).stdout.split()[-1]
    return ss._bind(ctypes.CDLL(path))


def split(tag: str, clocks: bool = True, against=None) -> dict:
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
    grid = ss.k2_grid_blocks(m, n, sm_count, per_sm)
    variants = [()] + ([("K2_CLOCKS",)] if clocks else [])
    libs = _libraries(ss, variants)
    other = _other_library(ss, against) if against else None

    def run(blocks, lib=libs[()], outs=None, **over):
        out, ms = _timed(torch, lambda: ss._launch(
            lib, *launch.args, launch.warm, blocks=blocks, **dict(launch.kw, **over)))
        if outs is not None:
            outs.append(out)
        status, pivots, _ph, _inf, _obj, majors, refreshes = out.monitor.tolist()
        return dict(ms=ms, status=status, pivots=pivots, majors=majors,
                    refreshes=refreshes)

    def parts(blocks):
        full = run(blocks)
        every = run(blocks, max_iter=64, refactor_period=1)
        never = run(blocks, max_iter=64, refactor_period=10**9)
        one = run(blocks, max_iter=1)
        refresh_ms = (every["ms"] - never["ms"]) / (every["refreshes"] - never["refreshes"])
        major_ms = (full["ms"] - full["refreshes"] * refresh_ms) / full["majors"]
        return dict(default=full, refresh_every_pivot_64=every, refresh_never_64=never,
                    one_pivot=one, refresh_ms=refresh_ms, major_ms=major_ms)

    run(grid, max_iter=1)  # loads the kernel and its module outside the timings
    res = dict(shape=tag, m=m, n=n, blocks=grid, sm_count=sm_count, grid=parts(grid),
               one_block=parts(1))
    if clocks:
        lib = libs[("K2_CLOCKS",)]
        sums = (ctypes.c_ulonglong * (len(PARTS) + 1))()
        lib.streaming_simplex_clocks.argtypes = [ctypes.c_void_p]
        lib.streaming_simplex_clocks.restype = ctypes.c_int
        lib.streaming_simplex_clocks(ctypes.addressof(sums))  # zero them
        clocked = run(grid, lib)
        if lib.streaming_simplex_clocks(ctypes.addressof(sums)) != 0:
            raise RuntimeError("reading K2's clocks failed")
        majors = max(int(sums[len(PARTS)]), 1)
        total = sum(int(sums[i]) for i in range(len(PARTS))) or 1
        res["clocked"] = clocked
        res["cycles_per_major"] = {pt: sums[i] / majors for i, pt in enumerate(PARTS)}
        res["ms_by_part"] = {pt: clocked["ms"] * sums[i] / total for i, pt in enumerate(PARTS)}
        groups = {}
        for pt, ms in res["ms_by_part"].items():
            key = "pricing" if pt.startswith("price") else pt.split(".")[0]
            groups[key] = groups.get(key, 0.0) + ms
        res["ms_by_group"] = groups
        res["refresh_ms_by_step"] = {
            pt.split(".", 1)[1]: ms / max(clocked["refreshes"], 1)
            for pt, ms in res["ms_by_part"].items() if pt.startswith("refresh.")}
    if other is not None:
        outs = {"this": [], "other": []}
        turns = [run(grid, lib, outs[side]) for side, lib in
                 (("other", other), ("this", libs[()]), ("this", libs[()]), ("other", other))]
        bits = lambda o: [t.view(torch.int32) for t in o]
        res["against"] = dict(
            checkout=str(against), other_ms=[turns[0]["ms"], turns[3]["ms"]],
            this_ms=[turns[1]["ms"], turns[2]["ms"]], other=turns[0], this=turns[1],
            bit_identical=all(torch.equal(a, b) for a, b in
                              zip(bits(outs["this"][0]), bits(outs["other"][0]))))
    return res


def main(argv: list[str]) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", metavar="SHAPE", help=f"of {list(SHAPES)}")
    ap.add_argument("--no-clocks", action="store_true")
    ap.add_argument("--against", metavar="DIR", default=None)
    opt = ap.parse_args(argv)
    if set(opt.shapes) - set(SHAPES):
        ap.error(f"shapes are of {list(SHAPES)}")
    if not torch.cuda.is_available():
        print("k2_split: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag in opt.shapes or list(SHAPES):
        print(json.dumps(split(tag, clocks=not opt.no_clocks, against=opt.against)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
