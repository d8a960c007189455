"""Headline benchmark of the PyTorch/CUDA port: bench.py's one JSON line.

    python3 -m minilp_tpu_torch.bench [--device cuda|cpu]

The counterpart of the JAX repository's `bench.py`, with its function names
and its lines, each run through the port's own entry points:

* the batched line (`bench.py:414-494`): certified LPs/s of
  `parallel.batched.solve_batches_pipelined` (K3, the packed simplex
  kernel, with the f64 certificate on the same device) over four fresh
  batches of 1024 dense 32×128 LPs at pack 8, median of 3 repetitions with
  the spread, and the pipeline's stages (`batch_stages`) over the median
  repetition; K3 alone on one device-resident batch; scipy-HiGHS on 64 LPs
  of the first batch as the baseline and the check;
* `_single_lp_and_incremental_metrics`: `Problem.solve()` cold at
  bench.py's two `single_lp` shapes (K1), then a chain of 6
  `add_constraint` cuts (`utils/node_chain.run_chain`);
* `_netlib_shape_metric`: the 25fv47 shape cold (K2) with the stage
  breakdown, then a fresh copy;
* `_streaming_pivot_rate`: four K2 solves of the 25fv47 shape on the
  driver's own launch (`streaming_options`), the first a warm-up;
* `_incremental_routing_metric`: 4 cuts re-solved on the host and through
  K1 warm (`use_megakernel="always"`) at 256x1024;
* `_maros_shape_metric`: the maros-r7 shape through `Problem.solve()` (the
  PDHG → simplex crossover above 2048 padded rows);
* `_pdhg_maros_metric`, last: the crossover's f32 device stage for half of
  a 90 s budget, then the sparse f64 PDHG engine in `stop_at` chunks, warm.

On a card the five kernels are built first, all at once (one `nvcc`
each, or loaded from `build/minilp_tpu_torch/` where built before), so no
line's wall carries a build.  It prints exactly one JSON line, whose keys
are a superset of bench.py's: `backend` is the torch device type, `device`
the card's name and power limit as `nvidia-smi` gives them,
`kernel_build_s` the wall of the builds, `launches` the launches of K1, K2,
K3, the batch certificate and the basis kernel (`basis_f64`, the f64
certificate of each single-LP solve's final basis, whose device time is
the breakdowns' `basis_dev_s`) during the run.  Each line takes its sizes as
keyword arguments (bench.py's by default), so the tests run every line
small on the CPU, where each kernel runs as its plain torch version.

Differences from bench.py, named: no chip lock, no `.jax_cache`, no
`jax.default_backend() != "tpu"` guards (every line runs on the device
asked for, and a missing card raises); the pivot-rate line launches K2 on
the driver's own canonical form (824×2432 at 25fv47), not a 128-row
re-layout; no `except Exception` turns a failure into an "error" field or
a skipped line: only an infeasible cut ends a chain, any other error fails
the run; a `single_lp` line's `certified` is the cold solve's (bench.py
reads it after the chain); the PDHG line reports `over_budget_s`, by how
much its wall passed its budget.  Times are on the host's clock around work that ends in
a device synchronisation, unrounded.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .canonical import canonicalize
from .engine import certificate, crossover, driver, pdhg
from .ops.kernels import (basis_f64, batched_simplex, build, certify, packed_simplex,
                          streaming_simplex)
from .options import SolverOptions
from .parallel.batched import make_random_batch_host, solve_batches_pipelined
from .status import Status
from .utils import profiling
from .utils.node_chain import run_chain
from .utils.synth import NETLIB_SHAPES, netlib_shaped_problem

#: bench.py's batched line: batch, rows, structural columns, pack, batches
BATCH, M, NV, PACK, N_BATCHES = 1024, 32, 96, 8, 4
#: bench.py's `single_lp` shapes (`bench.py:41-44`)
SINGLE_LP = {"256x1024": (250, 760, 0.05), "512x2048": (500, 1530, 0.03)}
#: the PDHG line's wall budget (`bench.py:184`)
PDHG_BUDGET_S = 90.0
#: K3's parameters on the batched line, as `solve_batches_pipelined` runs it
K3_KW = dict(max_iter=2000, refactor_period=32, feas_tol=1e-5, opt_tol=1e-6,
             pivot_tol=1e-6, bland_after=200)
KERNELS = {"batched_simplex": batched_simplex, "streaming_simplex": streaming_simplex,
           "packed_simplex": packed_simplex, "certify_f64": certify, "basis_f64": basis_f64}


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _timed_solve(prob, device):
    """(solution, wall seconds) of one `Problem.solve()`."""
    t0 = time.perf_counter()
    sol = prob.solve()
    _sync(device)
    return sol, time.perf_counter() - t0


def _mean(xs):
    return float(np.mean(xs)) if xs else None


def _cuts(sol, device, cuts):
    """bench.py's chain of `add_constraint` cuts (`default_rng(5)`, 8
    columns, margin 0.05) from `sol`: the nodes re-solved, up to the first
    cut that makes the LP infeasible."""
    nodes = run_chain(sol, cuts=cuts, seed=5, margin=0.05, edits=False,
                      sync=lambda: _sync(device))
    return [n for n in nodes if n.outcome == "optimal"]


def _batched_metrics(*, device, batch=BATCH, m=M, nv=NV, pack=PACK, n_batches=N_BATCHES,
                     sample=64) -> dict:
    """The batched line (`bench.py:414-494`): the line's top-level fields."""
    run = lambda bs: solve_batches_pipelined(bs, device=device, pack=pack, max_iter=2000,
                                             structural_cols=nv)
    run([make_random_batch_host(0, batch=batch, m=m, nv=nv)])  # warm-up batch
    batches = [make_random_batch_host(1 + k, batch=batch, m=m, nv=nv)
               for k in range(n_batches)]
    rep_walls, rep_stages = [], []
    for _rep in range(3):
        profiling.reset_stages()
        t0 = time.perf_counter()
        results = run(batches)
        _sync(device)
        rep_walls.append(time.perf_counter() - t0)
        rep_stages.append(profiling.stages(None))
    dt = float(np.median(rep_walls))
    lps_per_sec = n_batches * batch / dt
    statuses = np.concatenate([r.status for r in results])
    verified = np.concatenate([r.verified for r in results])
    niters = np.concatenate([r.niter for r in results])

    # K3 alone on one device-resident f32 batch: the least of 3 launches
    dev_args = packed_simplex.upload_packed(*batches[0], pack=pack, device=device)
    kernel_ts = []
    for _ in range(3):
        _sync(device)
        t0 = time.perf_counter()
        packed_simplex.packed_kernel_call(*dev_args, pack=pack, slack0=nv, **K3_KW)
        _sync(device)
        kernel_ts.append(time.perf_counter() - t0)

    # scipy-HiGHS on the host over a sample of the first batch: the
    # baseline's LPs/s and the check of the certified objectives
    from scipy.optimize import linprog

    A, b, c, lo, hi = batches[0]
    res0 = results[0]
    sample = min(sample, batch)
    max_gap = 0.0
    t0 = time.perf_counter()
    for i in range(sample):
        bounds = [(lo[i, j] if np.isfinite(lo[i, j]) else None,
                   hi[i, j] if np.isfinite(hi[i, j]) else None) for j in range(c.shape[1])]
        r = linprog(c[i], A_eq=A[i], b_eq=b[i], bounds=bounds, method="highs")
        if r.status == 0 and bool(res0.verified[i]):
            max_gap = max(max_gap, abs(float(res0.obj[i]) - r.fun) / (1.0 + abs(r.fun)))
    cpu_lps_per_sec = sample / (time.perf_counter() - t0)
    return {
        "metric": "batched_lp_throughput",
        "value": lps_per_sec,
        "unit": (f"certified LPs/s ({batch}-LP batches of dense {m}x{m + nv}, pack-{pack} K3, "
                 f"pipelined f64 certification; median of 3 reps)"),
        "reps_lps_per_sec": sorted(n_batches * batch / w for w in rep_walls),
        "vs_baseline": lps_per_sec / cpu_lps_per_sec,
        "baseline": "scipy-HiGHS sequential on host CPU (LPs/s)",
        "baseline_value": cpu_lps_per_sec,
        "n_optimal": int((statuses == int(Status.OPTIMAL)).sum()),
        "n_verified": int(verified.sum()),
        "batch": batch,
        "n_batches": n_batches,
        "max_rel_gap_vs_highs": max_gap,
        "mean_simplex_iters": float(niters.mean()),
        "simplex_iters_per_sec": float(niters.sum() / dt),
        "wall_s": dt,
        "device_only_lps_per_sec": batch / min(kernel_ts),
        # the pipeline's stages over the median repetition's batches
        # (`solve_batches_pipelined`; the `_dev_s` ones on a card only)
        "batch_stages": rep_stages[int(np.argsort(rep_walls)[1])],
    }


def _single_lp_and_incremental_metrics(*, device, shapes=SINGLE_LP) -> dict:
    """One cold `Problem.solve()` per shape, then bench.py's chain of cuts:
    the cold wall, pivots and certificate, and the mean wall and pivots of
    a re-solved node (`bench.py:31-81`).  The cold solve's pivots and
    certificate are read before the chain, whose re-solves share and
    update its handle."""
    out = {}
    for tag, (m, nv, dens) in shapes.items():
        prob = netlib_shaped_problem(m, nv, dens, seed=11)
        prob.options = SolverOptions(device=device)
        sol, cold_s = _timed_solve(prob, device)
        cold_iters, certified = int(sol._engine.iterations()), bool(sol._engine.certified)
        nodes = _cuts(sol, device, 6)
        out[tag] = {
            "cold_s": cold_s,
            "cold_iters": cold_iters,
            "certified": certified,
            "resolve_nodes": len(nodes),
            "mean_resolve_s": _mean([n.wall_s for n in nodes]),
            "mean_resolve_pivots": _mean([n.pivots for n in nodes]),
        }
    return out


def _enclosing(key: str) -> bool:
    """Whether a stage key lies inside or around other stages (the
    request's root and its self time, its route, the uploads, `finish`, the
    state rebuild's host part, the device stages): left out of
    `unattributed_s`."""
    return (key.endswith(("_dev_s", "_self_s")) or key.startswith("route.")
            or key in ("solve_s", "upload_s", "finish_s", "state_rebuild_host_s"))


def _shape_solve(shape, device):
    """`Problem.solve()` of `netlib_shaped_problem(*shape, seed=1)`: the
    solution, its wall and the stage breakdown with `unattributed_s` (the
    wall less the host stages; the device stages, `*_dev_s`, lie inside
    them)."""
    prob = netlib_shaped_problem(*shape, seed=1)
    prob.options = SolverOptions(device=device)
    profiling.reset_stages()
    sol, wall = _timed_solve(prob, device)
    stages = profiling.stages()
    stages["unattributed_s"] = wall - sum(v for k, v in stages.items()
                                          if k.endswith("_s") and not _enclosing(k))
    return sol, wall, stages


def _netlib_shape_metric(*, device, shape=NETLIB_SHAPES["25fv47"]) -> dict:
    """The 25fv47 shape cold through the default route (K2 on a card), with
    the stage breakdown, then a fresh copy (`bench.py:84-114`)."""
    sol, wall, stages = _shape_solve(shape, device)
    sol2, warm_wall, _ = _shape_solve(shape, device)
    return {
        "shape": f"{shape[0]}x{shape[1]}",
        "wall_s": wall,
        "warm_wall_s": warm_wall,
        "iters": int(sol._engine.iterations()),
        "certified": bool(sol._engine.certified and sol2._engine.certified),
        "breakdown": stages,
    }


def _maros_shape_metric(*, device, shape=NETLIB_SHAPES["maros-r7"]) -> dict:
    """The maros-r7 shape through the default route (the crossover above
    `driver._CROSSOVER_M` padded rows), with the stage breakdown
    (`bench.py:117-149`)."""
    sol, wall, stages = _shape_solve(shape, device)
    return {
        "shape": f"{shape[0]}x{shape[1]}",
        "wall_s": wall,
        "iters": int(sol._engine.iterations()),
        "certified": bool(sol._engine.certified),
        "objective": float(sol.objective()),
        "breakdown": stages,
    }


def _pdhg_maros_metric(ref_obj, *, device, shape=NETLIB_SHAPES["maros-r7"],
                       budget_s=PDHG_BUDGET_S) -> dict:
    """PDHG at the maros shape within a wall budget (`bench.py:152-274`):
    the crossover's f32 device stage for half of it, then the sparse f64
    engine warm from its iterate in `stop_at` chunks of 1000 iterations
    (the first 256) until the budget has passed.  Reports the f64 KKT reached, the gap to
    the certified objective `ref_obj` and `over_budget_s`."""
    m, nv, dens = shape
    can = canonicalize(netlib_shaped_problem(m, nv, dens, seed=1), dtype=np.float64)
    opts = SolverOptions(engine="pdhg", feas_tol=1e-6, pdhg_matrix="sparse",
                         pdhg_max_iter=400_000, device=device)
    t0 = time.perf_counter()
    # the f32 head gets half the budget, so that the exact f64 tail always
    # gets a turn (bench.py:194-201)
    head = crossover._device_pdhg_stage(can, opts, max(opts.feas_tol, 1e-5), device=device,
                                        budget_s=0.5 * budget_s)
    st, done, f32_iters, f32_err = None, 0, 0, None
    if head is not None:
        x_d, y_d, f32_iters, f32_err, omega = head
        st = crossover.warm_state(x_d, y_d, f32_iters, f32_err, omega, device=device)
        done = f32_iters
    put = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=device)
    A = put(can.A).to_sparse_csr()
    vecs = [put(v) for v in (can.b, can.c, can.lo, can.hi)]
    chunks = 0
    # the first tail chunk runs whatever the head left of the budget
    while done < opts.pdhg_max_iter and (chunks == 0 or time.perf_counter() - t0 <= budget_s):
        cap = min(done + (256 if chunks == 0 else 1000), opts.pdhg_max_iter)
        st = pdhg.solve_pdhg_sparse(A, *vecs, opts=opts, state0=st, stop_at=cap)
        done = int(st.niter)  # waits for the chunk
        chunks += 1
        if int(st.status) != int(Status.MAX_ITER):
            break
    wall = time.perf_counter() - t0
    x, y = st.x.cpu().numpy(), st.y.cpu().numpy()
    obj = float(can.obj_sign * (can.c @ x))
    return {
        "shape": f"{m}x{nv}",
        "wall_s": wall,
        "iters": done,
        "iters_per_sec": done / wall,
        "f32_head_iters": f32_iters,
        "f32_head_kkt": f32_err,
        "kkt_err": crossover.kkt_error_f64(can.csc(), can.b, can.c, can.lo, can.hi, x, y,
                                           float(opts.feas_tol)),
        "status": Status(int(st.status)).name,
        "objective": obj,
        "wall_bounded_s": budget_s,
        "over_budget_s": max(0.0, wall - budget_s),
        "tail_chunks": chunks,
        "rel_gap_vs_certified": abs(obj - ref_obj) / (1 + abs(ref_obj)),
    }


def _incremental_routing_metric(*, device, shape=SINGLE_LP["256x1024"]) -> dict:
    """Warm re-solves of the same cuts on the host route against K1 restarted
    warm (`use_megakernel="always"`), from the same cold solve's instance
    (`bench.py:277-324`)."""
    out = {}
    for label, kw in {"host": {}, "megakernel": {"use_megakernel": "always"}}.items():
        prob = netlib_shaped_problem(*shape, seed=11)
        prob.options = SolverOptions(device=device, **kw)
        nodes = _cuts(prob.solve(), device, 4)
        out[label] = {"nodes": len(nodes), "mean_resolve_s": _mean([n.wall_s for n in nodes])}
    return out


def _streaming_pivot_rate(*, device, shape=NETLIB_SHAPES["25fv47"]) -> dict:
    """K2's pivot rate at the 25fv47 shape on the driver's own launch: the
    LP presolved and canonicalized as `Problem.solve()` does it, through
    `solve_streaming` with the driver's `streaming_options`, then the f64
    check of its basis (`certificate.check`, on a fresh copy of the form
    each time, so that none is served from a kept one); solve 0 is a
    warm-up, 1-3 give the spread (`bench.py:327-387`)."""
    opts = SolverOptions(device=device)
    prob = netlib_shaped_problem(*shape, seed=1)
    prob.options = opts
    can = canonicalize(driver._maybe_presolve(prob), extra_row_capacity=opts.row_capacity_slack,
                       dtype=np.float64)
    options = driver.streaming_options(can, opts)
    walls, iters, dev_walls = [], [], []
    for _rep in range(4):
        profiling.reset_stages()
        fresh = dataclasses.replace(can)
        t0 = time.perf_counter()
        res = streaming_simplex.solve_streaming(can.A, can.b, can.c, can.lo, can.hi, **options)
        certificate.check(fresh, res.basis, res.vstat, opts)
        walls.append(time.perf_counter() - t0)
        iters.append(int(res.niter))
        st = profiling.stages()
        dev_walls.append(st.get("stream_first_launch_s", 0.0) + st.get("stream_chunks_s", 0.0))
    dev_rates = sorted(it / w for it, w in zip(iters[1:], dev_walls[1:]) if w > 0)
    wm = int(np.argmin(walls[1:])) + 1
    return {
        "shape": f"{can.M}x{can.N}",
        "pivots": iters[wm],
        "warm_wall_s": walls[wm],
        "warm_wall_reps_s": walls[1:],
        # end to end: the host's upload and f64 verification included
        "pivots_per_sec": iters[wm] / walls[wm],
        # the launches alone, median of the warm solves
        "device_pivots_per_sec": dev_rates[len(dev_rates) // 2] if dev_rates else None,
        "device_pivots_per_sec_reps": dev_rates,
        "status_optimal": bool(int(res.status) == int(Status.OPTIMAL)),
    }


def _device_name(device) -> str:
    """The card's name and power limit as `nvidia-smi` gives them, or the
    device type off a card."""
    if torch.device(device).type != "cuda":
        return torch.device(device).type
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def main(device: str = "cuda", sizes: dict | None = None) -> dict:
    """Run every line on `device` and print the one JSON line; returns it.
    `sizes` maps a line's function name to keyword arguments that replace
    its default sizes."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass --device cpu to run on the CPU")
    sizes = sizes or {}
    args = lambda fn: dict(sizes.get(fn.__name__, {}), device=device)
    t0 = time.perf_counter()
    if dev.type == "cuda":
        with ThreadPoolExecutor(len(KERNELS)) as pool:
            list(pool.map(build.load, KERNELS))
    build_s = time.perf_counter() - t0
    before = {name: mod.launches for name, mod in KERNELS.items()}

    # the breakdowns are of synchronised spans, the device stages included
    tracing = profiling.enable()
    try:
        line = _batched_metrics(**args(_batched_metrics))
        single_lp = _single_lp_and_incremental_metrics(
            **args(_single_lp_and_incremental_metrics))
        netlib_shape = _netlib_shape_metric(**args(_netlib_shape_metric))
        stream_rate = _streaming_pivot_rate(**args(_streaming_pivot_rate))
        inc_routing = _incremental_routing_metric(**args(_incremental_routing_metric))
        maros_shape = _maros_shape_metric(**args(_maros_shape_metric))
        pdhg_maros = _pdhg_maros_metric(maros_shape["objective"], **args(_pdhg_maros_metric))
    finally:
        profiling.enable(tracing)

    line.update({
        "single_lp": single_lp,
        "netlib_shape_25fv47": netlib_shape,
        "netlib_shape_maros_r7": maros_shape,
        "streaming_pivot_rate": stream_rate,
        "pdhg_maros_shape": pdhg_maros,
        "incremental_routing": inc_routing,
        "kernel_build_s": build_s,
        "launches": {name: mod.launches - before[name] for name, mod in KERNELS.items()},
        "backend": dev.type,
        "device": _device_name(dev),
    })
    print(json.dumps(line), flush=True)
    return line


if __name__ == "__main__":
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--device", default="cuda",
                        help='torch device of every line: "cuda" (default) or "cpu"')
    main(parser.parse_args().device)
