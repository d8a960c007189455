"""Where K1's time goes on one CUDA card: on the single-LP path, by parameter
variation and by a per-part clock split of a loop iteration; on a batch,
the launch whole.

    python3 -m minilp_tpu_torch.utils.k1_split [--no-clocks] [--against DIR] [SHAPE ...]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
Shapes (`SHAPES`): the `single_lp` shapes of `bench.py`
(`netlib_shaped_problem(..., seed=11)`, padded (256, 1024) and (504, 2048),
at K1's default `opt_tol` of 1e-6) and "degen2", the first `DEGEN2_LPS` LPs
of `degen2-cold`'s pool (`degenerate_problem` at Netlib degen2's 444 × 534,
seeds [`DEGEN2_POOL_SEED`, k, 0], padded (384, 1024), at the driver's
`_k1_opt_tol`).  Each LP is presolved and canonicalized, and launched as
`Problem.solve()` launches it through K1 (one LP, `slack0` = the structural
count, `max_iter` from `SolverOptions`, the refresh period of 32), on the
wrapper's default grid (`default_blocks`); CUDA events time:

* the default run of every LP: its pivots, status and ms (summed over the
  shape's LPs);
* on the first LP, 64 pivots with `refactor_period=1` and 64 with period
  10⁹: the first refreshes after each of its 63 later pivots, the second
  only at a phase change, so one refresh costs their difference over 63;
* one pivot: the start's recompute, and the exit.

The default runs less their refreshes (one per 32 pivots), over their
pivots, are the cost of one pivot.  Changing the period changes the pivot
path, so that split is an estimate.  Where the default grid is more than
one thread-block cluster, the default launches run again in turns on the
leader's cluster alone (`blocks` = the card's cluster size), every output
bit for bit the default grid's ("one_cluster"): what the blocks outside the
cluster give the refresh and the recompute.  Unless `--no-clocks`, a second
build of the kernel with `-DK1_CLOCKS` runs the default launches again and
sums the leader's `clock64()` cycles per part of a loop iteration
(`PARTS`), apart for phase 1 and phase 2; it prints each part's µs per
iteration (the cycles scaled by the clocked launches' ms over their cycles)
and their sums by kind: the serial steps, the refresh, and the hand-offs
(each posted phase's post and barriers).  The batch shapes (`BATCHES`)
time the launch of the whole batch, one block per LP, and nothing else.
`--against DIR` builds the kernel of another checkout at DIR (one with the
same C interface, such as the parent commit unpacked by `git archive`) and
runs every default launch on that checkout's own default grid against this
tree's, in turns (other, this, this, other), reporting the times and
whether every output (each LP's out row and the bits of its final B⁻¹) is
bit for bit the same.  Prints one JSON line per shape (with the grid's
blocks, the cluster's and the card's SM count) and the card's name and
power limit as `nvidia-smi` gives them.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

SHAPES = {"256x1024": (250, 760, 0.05), "512x2048": (500, 1530, 0.03),
          "degen2": (444, 534, 0.016853932584269662)}
#: batches of `random_batch(0, batch, m, nv)`, (batch, m, nv): `chip_smoke.py`
#: phase 3's batch of 64 and the bench's batched line's 1024, at phase 3's
#: `max_iter`
BATCHES = {"batch64": (64, 32, 96), "batch1024": (1024, 32, 96)}
BATCH_MAX_ITER = 2000
#: `degen2-cold`'s pool (`lpbench/workloads/degen2-cold.json`): its seed, and
#: how many of its LPs the "degen2" shape runs
DEGEN2_POOL_SEED, DEGEN2_LPS = 20261021, 8
DEVICE = "cuda"
PERIOD = 32  # solve_batch_megakernel's refactor_period
KERNEL_KW = dict(feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6, bland_after=200)
#: the kernel's clock parts (`Part` in batched_simplex.cu), in its order; a
#: posted phase's ".post" is the leader's hand-off, ".sync" the barriers it
#: waits in, ".work" the rest of it
PARTS = ("feas", "refresh", "sigma", "duals.post", "duals.work", "duals.sync", "price",
         "ftran.post", "ftran.work", "ftran.sync", "ratio", "sweeps.post", "sweeps.work",
         "sweeps.sync", "book")


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


def instances(tag: str) -> list:
    """The shape's canonical LPs, each with its K1 `opt_tol`."""
    from ..canonical import canonicalize
    from ..engine.driver import _k1_opt_tol
    from ..options import SolverOptions
    from ..presolve import presolve_problem
    from .synth import degenerate_problem, netlib_shaped_problem

    if tag == "degen2":
        probs = [degenerate_problem(*SHAPES[tag], seed=[DEGEN2_POOL_SEED, k, 0])
                 for k in range(DEGEN2_LPS)]
    else:
        probs = [netlib_shaped_problem(*SHAPES[tag], seed=11)]
    cans = [canonicalize(presolve_problem(p)[0]) for p in probs]
    tol = (lambda can: _k1_opt_tol(can, SolverOptions())) if tag == "degen2" else \
        (lambda can: KERNEL_KW["opt_tol"])
    return [(can, tol(can)) for can in cans]


def _other(checkout, m: int, n: int):
    """Another checkout's K1 library, built from its sources, and its own
    default grid at (m, n)."""
    code = ("import sys, torch; from minilp_tpu_torch.ops.kernels import build, "
            "batched_simplex as bs; print(build.load('batched_simplex').path); "
            "print(bs.default_blocks(torch.device('cuda'), int(sys.argv[1]), int(sys.argv[2])))")
    path, blocks = subprocess.run([sys.executable, "-c", code, str(m), str(n)], cwd=checkout,
                                  capture_output=True, text=True, check=True,
                                  timeout=900).stdout.split()[-2:]
    return path, int(blocks)


def _launch(torch, bs, lib, args, kw, blocks):
    """One timed launch of the K1 library `lib` (None: this tree's): (its
    out rows, the bits of each LP's final B⁻¹, ms)."""
    lib = lib or bs._library()
    B, m, n = args[0].shape
    (out, ws), ms = _timed(torch, lambda: bs.raw_launch(lib, *args, None, blocks=blocks, **kw))
    stride = (lib.batched_simplex_workspace_floats(B, m, n)
              - lib.batched_simplex_workspace_floats(0, m, n)) // B
    return out, ws[:B * stride].view(B, stride)[:, :m * m].view(torch.int32), ms


def _same(torch, a, b) -> bool:
    """Two launches' outputs are equal bit for bit."""
    return torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def _in_turns(torch, run_all, first, second) -> dict:
    """`first` and `second` (each (lib, blocks)) over every LP in turns
    (first, second, second, first): their ms, and whether every output of
    the two is bit for bit the same and each repeats."""
    outs = ([], [])
    turns = [run_all(*arg, outs=outs[side]) for side, arg in
             ((0, first), (1, second), (1, second), (0, first))]
    k = len(outs[0]) // 2
    return dict(first_ms=[turns[0]["ms"], turns[3]["ms"]],
                second_ms=[turns[1]["ms"], turns[2]["ms"]], first=turns[0], second=turns[1],
                bit_identical=all(_same(torch, outs[0][i], outs[1][i]) for i in range(k)),
                repeatable=all(_same(torch, o[i], o[k + i]) for o in outs for i in range(k)))


def split(tag: str, clocks: bool = False, against=None) -> dict:
    import torch

    from ..ops.kernels import batched_simplex as bs
    from ..options import SolverOptions

    if tag in BATCHES:
        return split_batch(tag, against)
    lps = []
    for can, opt_tol in instances(tag):
        args = [torch.tensor(can_x.astype("float32")[None], device=DEVICE)
                for can_x in (can.A, can.b, can.c, can.lo, can.hi)]
        kw = dict(KERNEL_KW, opt_tol=opt_tol, slack0=can.nv, refactor_period=PERIOD,
                  max_iter=SolverOptions().effective_max_iter(can.M, can.N))
        lps.append((args, kw))
    m, n = lps[0][0][0].shape[1:]
    dev = lps[0][0][0].device
    blocks = bs.default_blocks(dev, m, n)
    cluster = bs.grid_limits(dev)[0]

    def run(lib=None, lp=0, outs=None, grid=blocks, **over):
        args, kw = lps[lp]
        out, binv, ms = _launch(torch, bs, lib, args, dict(kw, **over), grid)
        if outs is not None:
            outs.append((out, binv))
        status, pivots = out[0, -2:].tolist()
        return dict(ms=ms, status=status, pivots=pivots)

    def run_all(lib=None, grid=blocks, outs=None):
        each = [run(lib, k, outs, grid) for k in range(len(lps))]
        return dict(ms=sum(e["ms"] for e in each), pivots=sum(e["pivots"] for e in each),
                    status=[e["status"] for e in each])

    run(max_iter=1)  # builds and loads the kernel outside the timings
    full = run_all()
    every = run(max_iter=64, refactor_period=1)
    never = run(max_iter=64, refactor_period=10**9)
    one = run(max_iter=1)
    refresh_ms = (every["ms"] - never["ms"]) / (every["pivots"] - 1)
    refreshes = full["pivots"] // PERIOD
    res = dict(shape=tag, m=m, n=n, lps=len(lps), blocks=blocks, cluster=cluster,
               sm_count=torch.cuda.get_device_properties(dev).multi_processor_count,
               default=full, refresh_every_pivot_64=every, refresh_never_64=never,
               one_pivot=one, refresh_ms=refresh_ms, refreshes=refreshes,
               pivot_ms=(full["ms"] - refreshes * refresh_ms) / full["pivots"])
    if blocks > cluster:  # the default grid against the leader's cluster alone
        t = _in_turns(torch, run_all, (None, blocks), (None, cluster))
        res["one_cluster"] = dict(blocks=cluster, ms=t["second_ms"], grid_ms=t["first_ms"],
                                  bit_identical=t["bit_identical"], repeatable=t["repeatable"])
    if clocks:
        res.update(_clocks(bs, run, run_all))
    if against is not None:
        path, grid = _other(against, m, n)
        other = bs._bind(ctypes.CDLL(path))
        run(other, max_iter=1, grid=grid)
        t = _in_turns(torch, run_all, (other, grid), (None, blocks))
        res["against"] = dict(checkout=str(against), other_blocks=grid, other_ms=t["first_ms"],
                              this_ms=t["second_ms"], other=t["first"], this=t["second"],
                              bit_identical=t["bit_identical"], repeatable=t["repeatable"])
    return res


def split_batch(tag: str, against=None) -> dict:
    """A batch shape (`BATCHES`): the launch of the whole batch, one block per
    LP, timed by CUDA events, and with `against` in turns with another
    checkout's kernel, every LP's outputs bit for bit."""
    import torch

    from ..ops.kernels import batched_simplex as bs
    from .synth import random_batch

    batch, m, nv = BATCHES[tag]
    args = [torch.tensor(x.astype("float32"), device=DEVICE)
            for x in random_batch(0, batch, m, nv)]
    kw = dict(KERNEL_KW, slack0=nv, refactor_period=PERIOD, max_iter=BATCH_MAX_ITER)

    def run_all(lib=None, grid=1, outs=None):
        out, binv, ms = _launch(torch, bs, lib, args, kw, grid)
        if outs is not None:
            outs.append((out, binv))
        return dict(ms=ms, pivots=int(out[:, -1].sum()),
                    status=out[:, -2].bincount().tolist())

    run_all()  # builds and loads the kernel outside the timings
    res = dict(shape=tag, m=m, n=m + nv, lps=batch, blocks=batch, default=run_all())
    if against is not None:
        other = bs._bind(ctypes.CDLL(_other(against, m, m + nv)[0]))
        run_all(other)
        t = _in_turns(torch, run_all, (other, 1), (None, 1))
        res["against"] = dict(checkout=str(against), other_ms=t["first_ms"],
                              this_ms=t["second_ms"], other=t["first"], this=t["second"],
                              bit_identical=t["bit_identical"], repeatable=t["repeatable"])
    return res


def _clocks(bs, run, run_all) -> dict:
    """The leader's clock split of the default launches, from a `-DK1_CLOCKS`
    build: µs per loop iteration by part and phase, and by kind."""
    lib = bs._library(("K1_CLOCKS",))
    P = len(PARTS)
    sums = (ctypes.c_ulonglong * (2 * (P + 1) + 1))()
    lib.batched_simplex_clocks.argtypes = [ctypes.c_void_p]
    lib.batched_simplex_clocks.restype = ctypes.c_int
    run(lib, max_iter=1)  # loads the module outside the clocked launches
    lib.batched_simplex_clocks(ctypes.addressof(sums))  # zero them
    clocked = run_all(lib)
    if lib.batched_simplex_clocks(ctypes.addressof(sums)) != 0:
        raise RuntimeError("reading K1's clocks failed")
    cyc = [int(v) for v in sums]
    # phase 1's parts, its iterations, phase 2's parts, its iterations, the rest
    total = sum(cyc[:P]) + sum(cyc[P + 1:2 * P + 1]) + cyc[-1]
    per_us = max(total, 1) / (clocked["ms"] * 1e3)  # cycles per µs
    out = dict(clocked=clocked, cycles_per_us=per_us, start_exit_ms=cyc[-1] / per_us / 1e3)
    for ph in (1, 2):
        base = (ph - 1) * (P + 1)
        iters = cyc[base + P]
        us = {pt: cyc[base + i] / per_us / max(iters, 1) for i, pt in enumerate(PARTS)}
        kinds = {"handoff": sum(v for pt, v in us.items() if pt.endswith((".post", ".sync"))),
                 "work": sum(v for pt, v in us.items() if pt.endswith(".work")),
                 "refresh": us["refresh"],
                 "serial": sum(us[pt] for pt in ("feas", "sigma", "price", "ratio", "book"))}
        out[f"phase{ph}"] = dict(iterations=iters, us_per_iteration=us, us_by_kind=kinds,
                                 ms=sum(us.values()) * max(iters, 1) / 1e3)
    return out


def main(argv: list[str]) -> int:
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("shapes", nargs="*", metavar="SHAPE",
                    help=f"of {list(SHAPES) + list(BATCHES)}")
    ap.add_argument("--no-clocks", action="store_true")
    ap.add_argument("--against", metavar="DIR", default=None)
    opt = ap.parse_args(argv)
    if set(opt.shapes) - set(SHAPES) - set(BATCHES):
        ap.error(f"shapes are of {list(SHAPES) + list(BATCHES)}")
    if not torch.cuda.is_available():
        print("k1_split: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag in opt.shapes or list(SHAPES) + list(BATCHES):
        print(json.dumps(split(tag, clocks=not opt.no_clocks, against=opt.against)),
              flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
