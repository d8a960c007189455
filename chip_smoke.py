#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`minilp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a) and the CUDA toolkit's `nvcc`.  It imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (exit code 1; no result line is printed then):

1. the card, its power limit, torch's CUDA version and `nvcc --version`;
2. the build of every kernel of the single-LP path (K1) from `csrc/`;
3. K1 against its plain torch version on the card, on the same inputs: a
   batch of 64 random 32×128 LPs, the two `single_lp` instances of
   `bench.py` canonicalized (padded (256, 1024) and (504, 2048)) cold, and
   one warm start after a tightened bound.  Required: the same status and
   `verified` flag per LP, certified objectives within 1e-9 relative;
4. the main path, `Problem.solve()` with the default options (device
   "cuda", megakernel "auto"), on the two `single_lp` instances and the
   README example.  Required: K1 launched (its launch count, reset just
   before, grows), the `cold_solve_megakernel` record, a certified solution,
   and an objective within 1e-6 relative of scipy's HiGHS.

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

import numpy as np

HERE = pathlib.Path(__file__).resolve().parent
REL_KERNEL = 1e-9   # kernel vs plain, certified objectives (both exact f64)
REL_HIGHS = 1e-6    # main path vs HiGHS
SINGLE_LP = {"256x1024": (250, 760, 0.05), "512x2048": (500, 1530, 0.03)}
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

        def timed(fn, reps):
            start = torch.cuda.Event(enable_timing=True)
            stop = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            start.record()
            for _ in range(reps):
                out = fn()
            stop.record()
            torch.cuda.synchronize()
            return out, start.elapsed_time(stop) / reps

        out_k, ms_k = timed(lambda: bs.simplex_kernel_call(*args, warm_t, **kw), reps)
        out_p, ms_p = timed(lambda: bs.simplex_plain(*args, warm_t, **kw), 1)
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
    from minilp_tpu_torch import OptimizationDirection, Problem, ComparisonOp
    from minilp_tpu_torch.canonical import canonicalize
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs, build
    from minilp_tpu_torch.presolve import presolve_problem
    from minilp_tpu_torch.utils import profiling
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

    # ---- 2. build every kernel of the path ----------------------------------
    t0 = time.perf_counter()
    built = build.load("batched_simplex")
    log(f"[2] built {built.path.name} in {built.seconds:.2f} s "
        f"(load {time.perf_counter() - t0:.2f} s)")
    for line in built.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log("    ptxas: " + line.strip())

    # ---- 3. K1 against its plain version on the card ------------------------
    log("[3] K1 (CUDA) vs plain torch on the card")
    cmp_ = Compare(torch, bs)
    A, b, c, lo, hi = random_batch(0, 64, 32, 96)  # the bench's 32×128 LP
    cmp_.run("batch64_32x128", A, b, c, lo, hi, slack0=96, max_iter=2000, reps=5)
    cans = {}
    for tag, (m, nv, dens) in SINGLE_LP.items():
        prob = netlib_shaped_problem(m, nv, dens, seed=11)
        can = canonicalize(presolve_problem(prob)[0])
        cans[tag] = can
        a = [x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)]
        cmp_.run(f"single_lp_{tag}", *a, slack0=can.nv,
                 max_iter=32 * (can.M + can.N) + 1000)
    # warm start after a tightened bound: the cold optimum's basis, vstat and
    # inverse, with the upper bound of its largest basic structural variable
    # cut to the midpoint between its lower bound and its value
    can = cans["256x1024"]
    cold = bs.solve_batch_megakernel(
        can.A[None], can.b[None], can.c[None], can.lo[None], can.hi[None],
        device=DEVICE, slack0=can.nv, max_iter=32 * (can.M + can.N) + 1000)
    x = cold.x[0]
    struct_basic = [int(j) for j in cold.basis[0] if j < can.nv]
    j = max(struct_basic, key=lambda k: x[k] - can.lo[k])
    hi2 = can.hi.copy()
    hi2[j] = 0.5 * (can.lo[j] + x[j])
    Binv0 = np.linalg.inv(can.A[:, cold.basis[0]]).astype(np.float32)
    cmp_.run("warm_256x1024_tightened", can.A[None], can.b[None], can.c[None],
             can.lo[None], hi2[None], slack0=can.nv, max_iter=32 * (can.M + can.N) + 1000,
             warm=(cold.basis, cold.vstat, Binv0[None]))

    # ---- 4. the main path: Problem.solve() through K1 -----------------------
    log("[4] main path: Problem.solve() on the card")
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
        walls, sols, stages = [], [], []
        for _rep in range(2):  # cold, then a second solve of a fresh copy
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
            if events != ["cold_solve_megakernel"]:
                raise AssertionError(f"{tag}: solve records {events}")
        for sol in sols:
            if not sol._engine.certified:
                raise AssertionError(f"{tag}: solution not certified")
            got, want = sol.objective(), expected[tag]
            if abs(got - want) > REL_HIGHS * (1.0 + abs(want)):
                raise AssertionError(f"{tag}: objective {got!r} vs HiGHS {want!r}")
        log(f"  {tag}: objective={sols[0].objective()!r} highs={expected[tag]!r} "
            f"pivots={sols[0]._engine.iterations()} cold_wall_s={walls[0]:.3f} "
            f"second_wall_s={walls[1]:.3f} "
            f"polished={any('host_polish_s' in st for st in stages)} "
            f"cold_stages={stages[0]}")
    main_launches = bs.launches
    if main_launches <= 0:
        raise AssertionError("the main path never launched K1")
    log(f"  K1 launches on the main path: {main_launches}")

    ms_k, ms_p = cmp_.times["single_lp_512x2048"]
    kernels = {"kernels": [{
        "name": "batched_simplex",
        "route": "cuda",
        "source": "minilp_tpu_torch/csrc/batched_simplex.cu",
        "replaces": "minilp_tpu/ops/kernels/batched_simplex.py:68",
        "launches": main_launches,
        "max_abs_err": cmp_.max_abs_err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}
    log(json.dumps(kernels))
    log(smi_name_power())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
