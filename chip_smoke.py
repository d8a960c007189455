#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`minilp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a) and the CUDA toolkit's `nvcc`.  It imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (exit code 1; no result line is printed then):

1. the card, its power limit, torch's CUDA version and `nvcc --version`;
2. the build of every kernel of the single-LP paths from `csrc/` (K1 and
   K2, one `nvcc` each, started together), with what ptxas reports;
3. K1 against its plain torch version on the card, on the same inputs: a
   batch of 64 random 32×128 LPs, the two `single_lp` instances of
   `bench.py` canonicalized (padded (256, 1024) and (504, 2048)) cold, and
   one warm start after a tightened bound.  Required: the same status and
   `verified` flag per LP, certified objectives within 1e-9 relative;
3b. K2 against its plain torch version on the card, on the inputs and
   options of the main path's first K2 launch (`prepare_launch` with the
   driver's `streaming_options`): the 25fv47 shape (presolved and
   canonicalized to (824, 2432), n padded to 2560) cold, run twice by the
   kernel (identical basis and pivots: no read of uninitialised scratch),
   the same instance in chunks of 2048 pivots against the main path's one
   launch (the warm relaunch), a warm start after a tightened bound, and
   the long step forced on at the `single_lp` 256x1024 instance.
   Required as for K1;
4. the main path through K1, `Problem.solve()` with the default options
   (device "cuda", megakernel "auto"), on the two `single_lp` instances and
   the README example.  Required: K1 launched (its launch count, reset just
   before, grows), the `cold_solve_megakernel` record, a certified solution,
   and an objective within 1e-6 relative of scipy's HiGHS;
4b. the main path through K2, `Problem.solve()` with the default options on
   the 25fv47 and fit1p shapes (K2 at (824, 2560) and (632, 2560)), a cold
   and a second solve each.  Required: only the `cold_solve_streaming`
   record, K2 launched, a certified solution within 1e-6 relative of HiGHS.
   The route the port took before K2 (`use_streaming="never"`: the f64
   torch engine on the card) is timed once on the 25fv47 shape.

It prints the kernel table as one JSON line, the card's name and power limit
as `nvidia-smi` gives them, and, last, `{"ok": true, "device": {...}}`.
Without a CUDA device, or without the package beside it, it exits nonzero.
"""

from __future__ import annotations

import json
import math
import os
import pathlib
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REL_KERNEL = 1e-9   # kernel vs plain, certified objectives (both exact f64)
REL_HIGHS = 1e-6    # main path vs HiGHS
SINGLE_LP = {"256x1024": (250, 760, 0.05), "512x2048": (500, 1530, 0.03)}
NETLIB = {"25fv47": (821, 1571, 0.008), "fit1p": (627, 1677, 0.0095)}
DEVICE = "cuda"


def log(*args) -> None:
    print(*args, flush=True)


def smi_name_power() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def highs_objective(prob) -> float:
    """scipy HiGHS on the user-level problem (the tests' oracle, restated
    here because the tests' helper imports the JAX package)."""
    from scipy.optimize import linprog
    from minilp_tpu_torch import ComparisonOp, OptimizationDirection

    nv = prob.num_vars
    sign = 1.0 if prob.direction == OptimizationDirection.Minimize else -1.0
    A_ub, b_ub, A_eq, b_eq = [], [], [], []
    for terms, op, rhs in prob._constraints:
        row = np.zeros(nv)
        for j, coeff in terms:
            row[j] += coeff
        if op == ComparisonOp.Le:
            A_ub.append(row); b_ub.append(rhs)
        elif op == ComparisonOp.Ge:
            A_ub.append(-row); b_ub.append(-rhs)
        else:
            A_eq.append(row); b_eq.append(rhs)
    bounds = [(None if lo == -math.inf else lo, None if hi == math.inf else hi)
              for lo, hi in zip(prob._lo, prob._hi)]
    res = linprog(
        sign * np.asarray(prob._obj),
        A_ub=np.asarray(A_ub) if A_ub else None, b_ub=b_ub or None,
        A_eq=np.asarray(A_eq) if A_eq else None, b_eq=b_eq or None,
        bounds=bounds, method="highs",
    )
    if res.status != 0:
        raise RuntimeError(f"HiGHS failed: {res.message}")
    return sign * float(res.fun)


def timed(torch, fn, reps=1):
    """(last result, mean ms per call) by CUDA events around `reps` calls."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        out = fn()
    stop.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(stop) / reps


class Compare:
    """K1 against its plain version on the same device inputs."""

    def __init__(self, torch, bs):
        self.torch, self.bs = torch, bs
        self.max_abs_err = 0.0
        self.times = {}

    def run(self, tag, A, b, c, lo, hi, *, slack0, max_iter, warm=None, reps=1):
        torch, bs = self.torch, self.bs
        dev = torch.device(DEVICE)
        t = lambda x, dt=np.float32: torch.tensor(np.asarray(x, dtype=dt), device=dev)
        args = [t(x) for x in (A, b, c, lo, hi)]
        warm_t = None
        if warm is not None:
            warm_t = (t(warm[0], np.int32), t(warm[1], np.int32), t(warm[2]))
        kw = dict(slack0=slack0, max_iter=max_iter, refactor_period=32,
                  feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6, bland_after=200)
        m, n = A.shape[1], A.shape[2]
        out_k, ms_k = timed(torch, lambda: bs.simplex_kernel_call(*args, warm_t, **kw), reps)
        out_p, ms_p = timed(torch, lambda: bs.simplex_plain(*args, warm_t, **kw), 1)
        res = []
        for out in (out_k, out_p):
            h = out.cpu().numpy()
            status = h[:, m + n]
            obj, ver, _x = bs._verify_f64(A, b, c, lo, hi, h[:, :m], h[:, m:m + n], status)
            res.append((h[:, :m], status, h[:, m + n + 1], obj, ver))
        (bk, sk, nk, ok_, vk), (bp, sp, np_, op, vp) = res
        if not (sk == sp).all():
            raise AssertionError(f"{tag}: status kernel {sk} vs plain {sp}")
        if not (vk == vp).all():
            raise AssertionError(f"{tag}: verified kernel {vk} vs plain {vp}")
        if not vk.any():
            raise AssertionError(f"{tag}: no LP verified")
        err = np.abs(ok_ - op)[vk]
        rel = err / (1.0 + np.abs(op[vk]))
        if rel.max() > REL_KERNEL:
            raise AssertionError(f"{tag}: certified objectives differ by {rel.max():.3e}")
        self.max_abs_err = max(self.max_abs_err, float(err.max()))
        same = int(sum((np.sort(x) == np.sort(y)).all() for x, y in zip(bk, bp)))
        self.times[tag] = (ms_k, ms_p)
        log(f"  {tag}: B={A.shape[0]} m={m} n={n} status={np.bincount(sk).tolist()} "
            f"verified={int(vk.sum())}/{len(vk)} identical_bases={same}/{len(vk)} "
            f"pivots kernel={int(nk.sum())} plain={int(np_.sum())} "
            f"max_rel_obj_diff={rel.max():.3e} kernel_ms={ms_k:.3f} plain_ms={ms_p:.3f}")


class CompareK2:
    """K2 against its plain version on the same device inputs: those of the
    main path's first launch (`prepare_launch` with the driver's options,
    so n is padded as `Problem.solve()` pads it)."""

    def __init__(self, torch, ss, bs, options):
        self.torch, self.ss, self.bs = torch, ss, bs
        self.options = options  # canonical LP -> the driver's K2 options
        self.max_abs_err = 0.0
        self.times = {}

    def result(self, out, launch):
        """(basis, vstat, status, niter, obj, verified, x) of one launch,
        the objective, flag and vertex from the host's exact f64 check."""
        mon = out.monitor.cpu().numpy()
        basis, vstat = out.basis.cpu().numpy(), out.vstat.cpu().numpy()
        obj, ver, x = self.bs._verify_f64(
            launch.A[None], launch.b[None], launch.c[None], launch.lo[None],
            launch.hi[None], basis[None], vstat[None], mon[:1])
        return basis, vstat, int(mon[0]), int(mon[1]), float(obj[0]), bool(ver[0]), x[0]

    def check(self, tag, rk, rp):
        (_bk, _vk, sk, _nk, ok_, vk, _xk), (_bp, _vp, sp, _np, op, vp, _xp) = rk, rp
        if sk != sp:
            raise AssertionError(f"{tag}: status kernel {sk} vs plain {sp}")
        if vk != vp:
            raise AssertionError(f"{tag}: verified kernel {vk} vs plain {vp}")
        if not vk:
            raise AssertionError(f"{tag}: not verified (status {sk})")
        err = abs(ok_ - op)
        rel = err / (1.0 + abs(op))
        if rel > REL_KERNEL:
            raise AssertionError(f"{tag}: certified objectives differ by {rel:.3e}")
        self.max_abs_err = max(self.max_abs_err, err)
        return rel

    def run(self, tag, can, *, hi=None, warm_state=None, repeat=False, **over):
        """K2 and `stream_plain` on the first launch of `Problem.solve()`'s
        K2 route for `can` (upper bounds `hi`, `warm_state` and the options
        in `over` replacing the driver's where given)."""
        torch, ss = self.torch, self.ss
        launch = ss.prepare_launch(
            can.A, can.b, can.c, can.lo, can.hi if hi is None else hi,
            warm_state=warm_state, **dict(self.options(can), **over))
        call = lambda fn: lambda: fn(*launch.args, launch.warm, **launch.kw)
        out_k, ms_k = timed(torch, call(ss.stream_kernel_call))
        rk = self.result(out_k, launch)
        majors, refreshes = out_k.monitor[5:7].tolist()
        if repeat:
            again, ms_k2 = timed(torch, call(ss.stream_kernel_call))
            ra = self.result(again, launch)
            if ra[3] != rk[3] or not (ra[0] == rk[0]).all() or not (ra[1] == rk[1]).all():
                raise AssertionError(f"{tag}: a second kernel run differs "
                                     f"(pivots {rk[3]} then {ra[3]})")
            log(f"  {tag}: second kernel run identical (basis, vstat, {ra[3]} pivots), "
                f"kernel_ms={ms_k2:.3f}")
        out_p, ms_p = timed(torch, call(ss.stream_plain))
        rp = self.result(out_p, launch)
        rel = self.check(tag, rk, rp)
        same = bool((np.sort(rk[0]) == np.sort(rp[0])).all())
        self.times[tag] = (ms_k, ms_p)
        m, n = launch.A.shape
        log(f"  {tag}: m={m} n={n} max_iter={launch.kw['max_iter']} "
            f"long_step={launch.kw['long_step']} status={rk[2]} verified={rk[5]} "
            f"identical_bases={same} "
            f"pivots kernel={rk[3]} plain={rp[3]} majors={majors} refreshes={refreshes} "
            f"obj={rk[4]!r} "
            f"rel_obj_diff={rel:.3e} kernel_ms={ms_k:.3f} plain_ms={ms_p:.3f}")
        return rk


def canonical_instance(m, nv, dens, seed):
    from minilp_tpu_torch.canonical import canonicalize
    from minilp_tpu_torch.presolve import presolve_problem
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    return canonicalize(presolve_problem(netlib_shaped_problem(m, nv, dens, seed=seed))[0])


def tightened_warm(can, basis, x):
    """The upper bound of the largest basic structural variable cut to the
    midpoint between its lower bound and its value, and the exact inverse of
    the basis as the warm seed."""
    struct_basic = [int(j) for j in basis if j < can.nv]
    j = max(struct_basic, key=lambda k: x[k] - can.lo[k])
    hi2 = can.hi.copy()
    hi2[j] = 0.5 * (can.lo[j] + x[j])
    Binv0 = np.linalg.inv(can.A[:, basis]).astype(np.float32)
    return hi2, Binv0


def build_all(build, names):
    """Build every kernel at once: one nvcc per source, started together."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = dict(zip(names, pool.map(build.load, names)))
    log(f"[2] built {len(names)} kernels in {time.perf_counter() - t0:.2f} s")
    for name, lib in built.items():
        log(f"    {lib.path.name}: nvcc {lib.seconds:.2f} s")
        for line in lib.log.splitlines():
            if "registers" in line or "spill" in line or "smem" in line:
                log("    ptxas: " + line.strip())


def solve_main_path(tag, make, want, event, rec_path, reps=2):
    """`Problem.solve()` of fresh copies: the record, certificate and HiGHS
    gap of each; returns the cold solve's (walls, stages, pivots)."""
    import torch
    from minilp_tpu_torch.utils import profiling

    walls, sols, stages = [], [], []
    for _rep in range(reps):  # cold, then a second solve of a fresh copy
        prob = make()
        profiling.reset_stages()
        n_rec = len(rec_path.read_text().splitlines()) if rec_path.exists() else 0
        t0 = time.perf_counter()
        sol = prob.solve()
        torch.cuda.synchronize()
        walls.append(time.perf_counter() - t0)
        sols.append(sol)
        stages.append(profiling.stages())
        events = [json.loads(line)["event"]
                  for line in rec_path.read_text().splitlines()[n_rec:]]
        if events != [event]:
            raise AssertionError(f"{tag}: solve records {events}")
    for sol in sols:
        if not sol._engine.certified:
            raise AssertionError(f"{tag}: solution not certified")
        got = sol.objective()
        if abs(got - want) > REL_HIGHS * (1.0 + abs(want)):
            raise AssertionError(f"{tag}: objective {got!r} vs HiGHS {want!r}")
    log(f"  {tag}: objective={sols[0].objective()!r} highs={want!r} "
        f"pivots={sols[0]._engine.iterations()} "
        f"walls_s={[round(w, 3) for w in walls]} "
        f"polished={any('host_polish_s' in st for st in stages)} "
        f"cold_stages={stages[0]}")
    return walls, stages, sols[0]._engine.iterations()


def main() -> int:
    if not (HERE / "minilp_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: the minilp_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 3
    sys.path.insert(0, str(HERE))
    import minilp_tpu_torch
    from minilp_tpu_torch import OptimizationDirection, Problem, ComparisonOp, SolverOptions
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs, build
    from minilp_tpu_torch.engine.driver import streaming_options
    from minilp_tpu_torch.ops.kernels import streaming_simplex as ss
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem, random_batch

    if pathlib.Path(minilp_tpu_torch.__file__).resolve().parent != HERE / "minilp_tpu_torch":
        raise RuntimeError(f"imported {minilp_tpu_torch.__file__}, not this checkout's package")
    if "jax" in sys.modules:
        raise RuntimeError("jax was imported")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. the card and the toolchain --------------------------------------
    card = smi_name_power()
    log(f"[1] nvidia-smi: {card}")
    log(f"    torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device {torch.cuda.get_device_name(0)}, count {torch.cuda.device_count()}")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, check=True, timeout=60).stdout.strip()
    log("    nvcc: " + nvcc.splitlines()[-1])

    # ---- 2. build every kernel of the paths ---------------------------------
    build_all(build, ["batched_simplex", "streaming_simplex"])

    # ---- 3. K1 against its plain version on the card ------------------------
    log("[3] K1 (CUDA) vs plain torch on the card")
    cmp_ = Compare(torch, bs)
    A, b, c, lo, hi = random_batch(0, 64, 32, 96)  # the bench's 32×128 LP
    cmp_.run("batch64_32x128", A, b, c, lo, hi, slack0=96, max_iter=2000, reps=5)
    cans = {}
    for tag, (m, nv, dens) in SINGLE_LP.items():
        can = canonical_instance(m, nv, dens, seed=11)
        cans[tag] = can
        a = [x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)]
        cmp_.run(f"single_lp_{tag}", *a, slack0=can.nv,
                 max_iter=32 * (can.M + can.N) + 1000)
    can = cans["256x1024"]
    cold = bs.solve_batch_megakernel(
        can.A[None], can.b[None], can.c[None], can.lo[None], can.hi[None],
        device=DEVICE, slack0=can.nv, max_iter=32 * (can.M + can.N) + 1000)
    hi2, Binv0 = tightened_warm(can, cold.basis[0], cold.x[0])
    cmp_.run("warm_256x1024_tightened", can.A[None], can.b[None], can.c[None],
             can.lo[None], hi2[None], slack0=can.nv, max_iter=32 * (can.M + can.N) + 1000,
             warm=(cold.basis, cold.vstat, Binv0[None]))

    # ---- 3b. K2 against its plain version on the card -----------------------
    log("[3b] K2 (CUDA) vs plain torch on the card")
    k2_options = lambda can: streaming_options(can, SolverOptions())
    cmp2 = CompareK2(torch, ss, bs, k2_options)
    can = canonical_instance(*NETLIB["25fv47"], seed=1)
    cold2 = cmp2.run("25fv47", can, repeat=True)
    # the main path's chunking ("auto": one launch at this m) against chunks
    # of 2048 pivots, each relaunched warm from the device-resident state
    runs = {}
    for chunk in ("auto", 2048):
        t0 = time.perf_counter()
        res = ss.solve_streaming(can.A, can.b, can.c, can.lo, can.hi,
                                 **dict(k2_options(can), chunk_iters=chunk))
        runs[chunk] = res
        log(f"  25fv47 solve_streaming chunk_iters={chunk}: status={int(res.status)} "
            f"verified={bool(res.verified)} pivots={int(res.niter)} obj={float(res.obj)!r} "
            f"wall_s={time.perf_counter() - t0:.3f}")
    one, chunked = runs["auto"], runs[2048]
    if (int(one.status), bool(one.verified)) != (int(chunked.status), bool(chunked.verified)):
        raise AssertionError("25fv47: chunked and single-launch K2 disagree")
    if not bool(one.verified) or abs(float(one.obj) - float(chunked.obj)) > \
            REL_KERNEL * (1.0 + abs(float(one.obj))):
        raise AssertionError("25fv47: chunked and single-launch objectives differ")
    hi2, Binv0 = tightened_warm(can, cold2[0], cold2[6])
    cmp2.run("25fv47_warm_tightened", can, hi=hi2, warm_state=(cold2[0], cold2[1], Binv0))
    cmp2.run("256x1024_long_step", cans["256x1024"], long_step_min_m=0)

    # ---- 4. the main path: Problem.solve() through K1 -----------------------
    log("[4] main path through K1: Problem.solve() on the card")
    rec_path = HERE / "build" / "minilp_tpu_torch" / "chip_smoke_records.jsonl"
    rec_path.parent.mkdir(parents=True, exist_ok=True)
    rec_path.unlink(missing_ok=True)
    os.environ["MINILP_TPU_LOG"] = str(rec_path)

    def readme_example():
        prob = Problem(OptimizationDirection.Maximize)
        x = prob.add_var(1.0, (0.0, None))
        y = prob.add_var(2.0, (0.0, 3.0))
        prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
        return prob

    cases = [("readme_example", readme_example, 7.0)]
    for tag, (m, nv, dens) in SINGLE_LP.items():
        cases.append((f"single_lp_{tag}",
                      lambda m=m, nv=nv, dens=dens: netlib_shaped_problem(m, nv, dens, seed=11),
                      None))
    expected = {tag: (want if want is not None else highs_objective(make()))
                for tag, make, want in cases}
    bs.launches = 0  # counts from here on are the main path's
    for tag, make, _want in cases:
        solve_main_path(tag, make, expected[tag], "cold_solve_megakernel", rec_path)
    k1_launches = bs.launches
    if k1_launches <= 0:
        raise AssertionError("the main path never launched K1")
    log(f"  K1 launches on the main path: {k1_launches}")

    # ---- 4b. the main path: Problem.solve() through K2 ----------------------
    log("[4b] main path through K2: Problem.solve() on the card")
    netlib = {tag: (lambda a=args: netlib_shaped_problem(*a, seed=1))
              for tag, args in NETLIB.items()}
    want = {tag: highs_objective(make()) for tag, make in netlib.items()}
    ss.launches = 0  # counts from here on are the main path's
    for tag, make in netlib.items():
        solve_main_path(tag, make, want[tag], "cold_solve_streaming", rec_path)
    k2_launches = ss.launches
    if k2_launches <= 0:
        raise AssertionError("the main path never launched K2")
    log(f"  K2 launches on the main path: {k2_launches}")

    def before_k2():
        prob = netlib["25fv47"]()
        prob.options = SolverOptions(use_streaming="never")
        return prob

    walls, _stages, pivots = solve_main_path("25fv47_use_streaming_never", before_k2,
                                             want["25fv47"], "cold_solve", rec_path, reps=1)
    log(f"  25fv47 without K2 (f64 torch engine on the card): wall_s={walls[0]:.3f} "
        f"pivots={pivots}")

    ms_k, ms_p = cmp_.times["single_lp_512x2048"]
    ms2_k, ms2_p = cmp2.times["25fv47"]
    kernels = {"kernels": [{
        "name": "batched_simplex",
        "route": "cuda",
        "source": "minilp_tpu_torch/csrc/batched_simplex.cu",
        "replaces": "minilp_tpu/ops/kernels/batched_simplex.py:68",
        "launches": k1_launches,
        "max_abs_err": cmp_.max_abs_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }, {
        "name": "streaming_simplex",
        "route": "cuda",
        "source": "minilp_tpu_torch/csrc/streaming_simplex.cu",
        "replaces": "minilp_tpu/ops/kernels/streaming_simplex.py:134",
        "launches": k2_launches,
        "max_abs_err": cmp2.max_abs_err,
        "ms": ms2_k,
        "plain_ms": ms2_p,
    }]}
    log(json.dumps(kernels))
    log(smi_name_power())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
