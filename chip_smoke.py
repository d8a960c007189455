#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (`minilp_tpu_torch`) on one GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with one NVIDIA H100 (the
kernels are built for sm_90a) and the CUDA toolkit's `nvcc`.  It imports
nothing of JAX or of the JAX package.  Phases, each of which raises on
failure (exit code 1; no result line is printed then):

1. the card, its power limit, torch's CUDA version and `nvcc --version`;
2. the build of every kernel from `csrc/` (K1, K2, K3 and the f64
   certificate, one `nvcc` each, started together), with what ptxas
   reports;
3. K1 against its plain torch version on the card, on the same inputs: a
   batch of 64 random 32×128 LPs, the two `single_lp` instances of
   `bench.py` canonicalized (padded (256, 1024) and (504, 2048)) cold, and
   one warm start after a tightened bound.  Required: the same status and
   `verified` flag per LP, certified objectives within 1e-9 relative.  A
   one-LP launch is one cooperative grid (one block per SM); on each
   one-LP case its out rows and the bits of its final B⁻¹ must equal those
   of the same launch on one block, while the batch of 64 runs one block
   per LP.  `utils/k1_split.py` gives the grid's per-refresh and per-pivot
   times at both `single_lp` shapes;
3b. K2 against its plain torch version on the card, on the inputs and
   options of the main path's first K2 launch (`prepare_launch` with the
   driver's `streaming_options`): the 25fv47 shape (presolved and
   canonicalized to (824, 2432)) cold, run twice by the
   kernel (identical basis and pivots: no read of uninitialised scratch),
   the same instance in chunks of 2048 pivots against the main path's one
   launch (the warm relaunch), a warm start after a tightened bound, and
   the long step forced on at the `single_lp` 256x1024 instance.
   Required as for K1.  K2 is one cooperative grid (one block per SM):
   on each of these cases, and on every chunk of the 25fv47 chunk loop
   driven through `stream_kernel_call`, its outputs (basis, vstat, the
   bits of B⁻¹, the monitor) must equal bit for bit those of the same
   launch on one block, and the pivots and majors at 25fv47 repeat
   (13974, 4642).  `utils/k2_split.py` gives the grid's and one block's
   per-refresh and per-major times at 25fv47;
3c. K3 against its plain torch version on the card, on the same device
   inputs: a batch of 1024 of `bench.py`'s 32×128 LPs at pack 8 (seed 0),
   the first batch of phase 5 (seed 1, held to the plain version lane by
   lane where the two take the same pivots, its unverified lanes 293 and
   471 named), a canonicalized `netlib_shaped_problem` instance
   replicated over two packs (its workspace in global memory), and one
   `solve_heterogeneous` bucket as `scheduling.bucket_lps` builds it.
   Required as for K1, two kernel runs give identical output (no read of
   uninitialised scratch), the default layout (each LP's A staged in shared
   memory where the pack fits) gives the out rows of the "global" layout
   bit for bit, and at the full batch the pivots of the seed-0 batch, the
   replicated instance and the bucket repeat (178961, 2352, 2512).
   `utils/k3_split.py` gives the refresh's ms and the µs of one lockstep
   iteration at the bench's batch;
4. the main path through K1, `Problem.solve()` with the default options
   (device "cuda", megakernel "auto"), on the two `single_lp` instances and
   the README example.  Required: K1 launched (its launch count, reset just
   before, grows), the `cold_solve_megakernel` record, a certified solution,
   and an objective within 1e-6 relative of scipy's HiGHS;
4b. the main path through K2, `Problem.solve()` with the default options on
   the 25fv47 and fit1p shapes (K2 at (824, 2432) and (632, 2432)), a cold
   and a second solve each.  Required: only the `cold_solve_streaming`
   record, K2 launched, a certified solution within 1e-6 relative of HiGHS,
   and the pivots of the parent kernel (13974 and 11322).
   The route the port took before K2 (`use_streaming="never"`: the f64
   torch engine on the card) is timed once on the 25fv47 shape;
5b. the batched path's f64 certificate (`csrc/certify_f64.cu`, which
   replaces the host's numpy `_verify_f64`) against its plain torch version
   on the card, on the same device inputs, and both against the host's
   `_verify_f64`: on K3's rows for the bench's batch (seed 0, whose pivots
   repeat 178961) and for phase 5's first batch (seed 1, lanes 293 and 471
   unverified by all three), on K3's rows for one `mixed_lps(50)` bucket,
   on K1's rows for `scenario_batch`'s 512 × (16×24), and on a crafted 16
   lanes of seed 0 (lane 1 exactly singular, lane 2 MAX_ITER, lane 3 above
   a cut bound).  Required: the same `verified` flags on every lane (on
   the crafted batch the host's batched solve fails every lane, the kernel
   and the plain version lane 1 alone, and the other lanes are the host's
   answer without lane 1), obj and x within 1e-12 · max(1, |reference|),
   the shared-memory layout equal to the "global" one bit for bit, two
   kernel runs identical.  Logged: the kernel's ms (least of 3), the
   global layout's, the plain version's, the library calls' (A·x_N,
   `lu_factor_ex`, two `lu_solve`, Aᵀy) and the host's, beside the bound;
5. the batched main path through K3, as `bench.py`'s batched line runs it:
   `solve_batches_pipelined` on a warm-up batch, then three repetitions
   over four fresh batches of 1024 LPs (m = 32, nv = 96, pack 8,
   `structural_cols=96`), each certified on the card, with the certified
   LPs per second (median and spread), the device-only K3 time of one
   batch and every `batch_*` stage.  Required: K3 and the certificate
   launched once a batch, every lane certified (after HiGHS), and a gap to
   HiGHS within 1e-9 relative on 64 sampled lanes.  Also
   `solve_batch_certified` (K1 in batch mode) on one batch of 1024 and
   `solve_heterogeneous` on a mixed list (one certificate a bucket), each
   certified and checked against HiGHS on sampled LPs.  The host's
   `_verify_f64` (the single-LP routes' certificate) must not be called on
   any of these batch entry points;
6. the incremental main path (`Solution.add_constraint` / `fix_var` /
   `unfix_var` / `add_gomory_cut`), one node chain per case
   (`utils/node_chain.py`: bench.py's 6 `add_constraint` cuts, `fix_var`
   and `unfix_var` of the basic structural variable farthest above its
   lower bound, one `add_gomory_cut`) after a cold solve: (a) the default options on both
   `single_lp` instances (cold through K1, every re-solve on the host:
   `dual_resolve_host` / `primal_resolve_host`, no kernel launch);
   (b) `use_megakernel="always"` at 512x2048 (every node launches K1 warm,
   `*_megakernel`); (c) `use_streaming="always"` at the 25fv47 shape (cold
   and every node through K2, `*_streaming`).  Required per node: the
   expected solve record (a fallback record fails the phase; an infeasible
   cut may only end the chain, and HiGHS must agree), a certified solution
   within 1e-6 relative of HiGHS on the edited LP, and in (b) and (c) the
   kernel's launch count grown by one per node at least.  It logs each
   node's wall, pivots and stages, each chain's means, and the warm
   launches of K1 and K2.  Then (b)'s and (c)'s warm launches are run
   again on the same inputs through the kernel (grid and one block) and
   its plain version, as in phases 3 and 3b: the first launch, the first
   after each growth of the row capacity (the same status, certificate
   and objective), and every launch whose claim the driver polished (the
   same status; each claim's f64 distance from the certificate is logged,
   and where one claim passes it and the other not, the pivot at which the
   two paths part).

7. PDHG and the PDHG → simplex crossover (no kernel of this repository:
   the PDHG step is torch ops): (a) the main path at the maros-r7 shape
   (`netlib_shaped_problem(3136, 9408, 0.0049, seed=1)`), written with
   `write_mps`, read back through the native parser, and `Problem.solve()`
   with the default options.  Required: only the `cold_solve_crossover`
   record, the device stage run on the card, a certified solution, the
   objective within 1e-9 relative of the reference's certified
   −4686.208519614669 and within 1e-6 of HiGHS (run once, after the
   solve), and the hand-off the solve took (the host stage's launches and
   timer) the one the rule gives on the last chunk's f64 KKT.  It logs the
   stages, each device chunk (operator, iterations, wall, the host's f64
   KKT), the hand-off, each phase's iterations per second, and one f32 PDHG iteration's ms by
   CUDA events beside its bound (the two matvecs' bytes over 3.35 TB/s);
   (b) `engine="pdhg"` on the `single_lp` 256x1024 instance at feas_tol
   1e-6, dense and sparse: the `pdhg_solve` record, OPTIMAL, within 1e-5
   of HiGHS; then the card against the CPU on the same inputs: the f64
   dense PDHG after 4 windows (1e-9) and one f32 device-stage chunk
   (1e-4); (c) the sparse f64 engine at the maros-r7 shape in `stop_at`
   chunks for 60 s: iterations per second, the f64 KKT, the gap to (a)'s
   objective; required: finite iterates and a falling KKT.  Phase 4b also
   holds K2's 25fv47 objective to the reference's certified one (1e-9).

8. The examples and the multi-device engines (no new kernel: the sharded
   engines are torch ops and `torch.distributed` collectives).  (a) With
   the default options: `examples/tsp.py` by branch-and-cut at n = 9
   (against the brute force) and n = 16 (seed 0, against a Held–Karp
   dynamic program in numpy), the cold solve through K1 and the nodes on
   the incremental API; `examples/scenario_batch.py` at its default 512 ×
   (16×24), every lane OPTIMAL after the f64 fallback, its batch certified
   by one launch of the certificate and never by the host; `examples/
   netlib_runner.py` on an MPS file of the 25fv47 shape named SHAPE_25FV47
   with `--expected` the reference's certified objective: exit code 0,
   `pass_1e-6`, certified, through K2.  K1's and K2's launches on these
   paths count as their own (`launches_by_path["examples"]`); each is
   recorded and, after the path, held against its plain version on the
   same inputs (K2 without phase 3b's one-block rerun).  (b) At the
   `single_lp` 256x1024 shape (canonical, f64): `solve_canonical_sharded`,
   `resolve_dual_sharded` after a cut appended by `incremental._append_row`,
   `solve_pdhg_sharded` (vanilla, 6400 iterations) and
   `solve_batch_sharded` on `make_random_batch_host(1, 64, 32, 96)`,
   first in a one-rank NCCL world in this process, then in a two-rank gloo
   world of two processes on the same card (`parallel.launch.run_world`),
   with the dry run (`parallel.distributed.dryrun_multichip`) in each.
   Required: the single-device engines' status, pivots, basis and
   objective (1e-9) on the same card, the PDHG's status and iterations
   with x and y within 1e-9, the batch bit-identical lane for lane.  It
   logs the ms a pivot and an iteration against the single device's, and
   the collectives a pivot and their share of the wall; two ranks share
   one card, so none of it is a scaling figure.

9. The bench as a user runs it: `python3 -m minilp_tpu_torch.bench` in a
   subprocess under a time limit, which prints bench.py's one JSON line
   from the port (the batched line through K3, the single-LP lines and
   their chains of cuts through K1, 25fv47 and K2's pivot rate through K2,
   the host and K1-warm routing lines, the maros-r7 shape through the
   crossover, the wall-bounded PDHG line).  The line is logged whole.
   Required: 4096 of 4096 LPs optimal and verified, within 1e-6 of HiGHS;
   both `single_lp` lines certified with pivots and at least one node; the
   25fv47 line certified; the pivot-rate line optimal with phase 4b's
   pivots; both routes at least one node; the maros line certified within
   1e-9 of the reference's objective; the PDHG line's KKT and gap finite,
   and `over_budget_s` present; the card in `device`; K1, K2, K3 and the
   certificate launched during the run (its `launches`); and the batched
   line's `batch_stages`, the device ones included.

It prints the kernel table as one JSON line (each kernel's launches on its
main paths, by path in `launches_by_path`: K1's and K2's cold solves of
phases 4 and 4b and warm re-solves of phase 6, K3's and the certificate's
batched path, the certificate's launch on the examples' path, the bench's
launches of each; its time and its plain version's at the stated shape,
the library calls' for the certificate, and the bound of that run: the
larger of its bytes over the card's memory rate and its floating-point
operations, counted from the run's pivots, over the f32 peak, or the
certificate's f64 operations over the FP64 tensor-core peak), the card's
name and power limit as `nvidia-smi` gives them, and,
last, `{"ok": true, "device": {...}}`.
Without a CUDA device, or without the package beside it, it exits nonzero.
"""

from __future__ import annotations

import contextlib
import dataclasses
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
BATCH, BATCH_M, BATCH_NV, PACK = 1024, 32, 96, 8  # bench.py's batched line
F32_FLOPS = 67e12   # H100 SXM f32 rate outside the tensor cores (data sheet, 700 W)
HBM_BYTES = 3.35e12  # H100 SXM memory rate, bytes/s (data sheet)
#: H100 SXM FP64 tensor-core rate (data sheet, 700 W; 34 TFLOP/s outside the
#: tensor cores): the certificate's least time takes the faster of the two
F64_FLOPS = 67e12
REL_CERT = 1e-12    # the certificate kernel vs its plain version and the host's
KERNEL_KW = dict(refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
                 bland_after=200)
# K3's pivots on phase 3c's cases at the full batch (PERF.md §6), which every
# change of the kernel that keeps its bits repeats
K3_PIVOTS = {f"batch{BATCH}_32x128": 178961, "netlib_shaped_60x150_replicated": 2352,
             "heterogeneous_bucket_16x80": 2512}
# the lanes of phase 5's first batch (seed 1) whose OPTIMAL claim from K3
# fails the f64 check: 471 as in the plain version and the Pallas kernel,
# 293 after a pivot path of its own, whose ratio test parts from the plain
# version's at pivot 127 on K3's f32 x_B of one row (`utils/k3_lane.py`;
# ROADMAP Queue 3)
K3_UNVERIFIED_SEED1 = [293, 471]
# K2's pivots and majors at the Netlib shapes on the main path's launch
# (PERF.md §5), which every change of the kernel that keeps its bits repeats
K2_COUNTS = {"25fv47": (13974, 4642), "fit1p": (11322, None)}
#: the reference's certified objective at the 25fv47 shape (seed 1), from the
#: JAX package on the CPU (`tests/test_torch_crossover.py`, OBJ_25FV47)
OBJ_25FV47 = -685.0486724425741
REL_REF = 1e-9      # a certified objective vs the reference's
#: phase 7: the maros-r7 shape of bench.py:133 (`NETLIB_SHAPES["maros-r7"]`,
#: seed 1) and the reference's certified objective there (`BENCH_r05.json`,
#: `netlib_shape_maros_r7`: an exact f64 certificate after 776 polish pivots)
MAROS = (3136, 9408, 0.0049)
MAROS_OBJ = -4686.208519614669
#: engine="pdhg" at 1e-6 as tests/test_large.py runs it (`PDHG`)
PDHG_KW = dict(engine="pdhg", feas_tol=1e-6, pdhg_max_iter=600_000)
PDHG_WALL_S = 60.0  # phase 7(c)'s wall bound
#: phase 9: the bench as a user runs it, and its time limit
BENCH_CMD = (sys.executable, "-m", "minilp_tpu_torch.bench")
BENCH_TIMEOUT_S = 480.0
#: the kernels whose launches the bench's line counts, and the batched
#: line's stages (`solve_batches_pipelined`) on a card
BENCH_KERNELS = ("batched_simplex", "streaming_simplex", "packed_simplex", "certify_f64")
BATCH_STAGES = ("batch_prep_s", "batch_wait_s", "batch_verify_s", "batch_verify_dev_s",
                "batch_resolve_s", "batch_resolved", "batch_upload_dev_s", "batch_kernel_dev_s")


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


def bound(flops, nbytes):
    """(bound_ms, bound_by): the larger of the bytes over the memory rate
    and the operations over the f32 peak."""
    t_ops, t_bytes = flops / F32_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def dense_simplex_bound(niter, m, n, refactor_period=32):
    """K1's and K3's bound on this run's pivots: per pivot of an LP the
    pivot row (2mn) and FTRAN plus the rank-1 update (4m²), and at least one
    Newton refresh per `refactor_period` pivots (four m³ products and the
    recompute: 8m³ + 4mn); bytes: the f32 inputs read once, the int32 rows
    written once."""
    niter = np.asarray(niter, dtype=np.float64)
    flops = float((niter * (2 * m * n + 4 * m * m)
                   + np.floor(niter / refactor_period) * (8 * m ** 3 + 4 * m * n)).sum())
    nbytes = niter.size * 4 * ((m * n + m + 3 * n) + (m + n + 2))
    return bound(flops, nbytes)


def certify_bound(B, m, n):
    """The certificate's bound on B lanes of m x n: the larger of its bytes
    (A, b, c, lo, hi read once in f64, the basis, vstat and status in int32,
    obj, verified and x written once) over the memory rate and its f64
    operations (an LU, 2m³/3; two triangular solves each way, 4m²; A·x_N
    and Aᵀy, 4mn) over `F64_FLOPS`."""
    nbytes = B * (8 * (m * n + m + 3 * n) + 4 * (m + n + 1) + 8 + 1 + 8 * n)
    flops = B * (2 * m ** 3 / 3 + 4 * m * m + 4 * m * n)
    t_ops, t_bytes = flops / F64_FLOPS * 1e3, nbytes / HBM_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


@contextlib.contextmanager
def host_checks_counted():
    """Count the calls of the host's `_verify_f64` (the single-LP routes'
    certificate) while the block runs: a list whose length is the count."""
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs

    saved, calls = bs._verify_f64, []

    def counted(*args):
        calls.append(args[0].shape)
        return saved(*args)

    bs._verify_f64 = counted
    try:
        yield calls
    finally:
        bs._verify_f64 = saved


def streaming_bound(m, n, majors, refreshes, minor_k=16):
    """K2's bound on this run's counts: per refresh two Newton sweeps (8m³)
    and the steepest-edge weights (2nm²), per major the pricing over Aᵀ
    (2mn), y and the candidates' block W = B⁻¹·A_cand (2m²(1 + minor_k));
    bytes: Aᵀ and the vectors read once, basis, vstat and B⁻¹ written once."""
    flops = refreshes * (8 * m ** 3 + 2 * n * m * m) + majors * (2 * m * n + 2 * m * m * (1 + minor_k))
    nbytes = 4 * ((n * m + m + 3 * n) + (m + n + m * m))
    return bound(flops, nbytes)


def assert_agree(tag, kernel, plain, polished=False):
    """The kernel's and the plain version's (status, verified, objective)
    per LP: the same status and `verified` flag, some LP verified, and the
    certified objectives within REL_KERNEL relative.  A `polished` launch
    (one whose claim failed the certificate on the main path) needs only
    the same status: after many f32 pivots the two paths may part, and
    either claim may then miss the certificate (`Compare.parting` logs
    where).  Returns the largest absolute and relative objective
    differences."""
    (sk, vk, ok_), (sp, vp, op) = ([np.atleast_1d(x) for x in r] for r in (kernel, plain))
    if not (sk == sp).all():
        raise AssertionError(f"{tag}: status kernel {sk} vs plain {sp}")
    both = vk & vp
    if not polished:
        if not (vk == vp).all():
            raise AssertionError(f"{tag}: verified kernel {vk} vs plain {vp}")
        if not vk.any():
            raise AssertionError(f"{tag}: no LP verified (status {sk})")
    if not both.any():
        return 0.0, 0.0
    err = np.abs(ok_ - op)[both]
    rel = err / (1.0 + np.abs(op[both]))
    if rel.max() > REL_KERNEL:
        raise AssertionError(f"{tag}: certified objectives differ by {rel.max():.3e}")
    return float(err.max()), float(rel.max())


def certificate_gaps(A, b, c, lo, hi, basis, vstat):
    """How far one LP's claimed basis is from the f64 certificate, whose
    tolerance is 1e-7 (`_verify_f64`): the largest bound violation of x_B
    and the largest wrong-signed reduced cost, in exact f64, then the basic
    variable of that bound violation."""
    from minilp_tpu_torch.canonical import nonbasic_values
    from minilp_tpu_torch.status import VarStat

    A, b, c, lo, hi = (np.asarray(x, dtype=np.float64) for x in (A, b, c, lo, hi))
    B = A[:, basis]
    xB = np.linalg.solve(B, b - A @ nonbasic_values(vstat, lo, hi))
    d = c - np.linalg.solve(B.T, c[basis]) @ A
    viol = np.maximum(np.maximum(lo[basis] - xB, xB - hi[basis]), 0.0)
    wrong = np.where(vstat == int(VarStat.AT_LOWER), -d, 0.0)
    wrong = np.where(vstat == int(VarStat.AT_UPPER), d, wrong)
    wrong = np.where(vstat == int(VarStat.FREE), np.abs(d), wrong)
    return float(viol.max()), float(wrong.max(initial=0.0)), int(basis[np.argmax(viol)])


def same_k1_bits(tag, wide, one, m):
    """Raise unless two one-LP K1 launches' (out, ws) agree bit for bit: the
    out row and the final B⁻¹ (the workspace's first m·m floats, as int32);
    name the first differing index."""
    import torch

    for name, a, b in (("out row", wide[0], one[0]),
                       ("B⁻¹", wide[1][:m * m].view(torch.int32),
                        one[1][:m * m].view(torch.int32))):
        diff = torch.nonzero(a.reshape(-1) != b.reshape(-1))
        if diff.numel():
            i = int(diff[0])
            raise AssertionError(f"{tag}: wide and one-block K1 differ in {name} "
                                 f"at flat index {i}")


class Compare:
    """K1 against its plain version on the same device inputs; a one-LP
    case also against its own launch on one block."""

    def __init__(self, torch, bs):
        self.torch, self.bs = torch, bs
        self.max_abs_err = 0.0
        self.times = {}
        self.niter = {}  # the kernel's pivots per LP, per case

    def run(self, tag, A, b, c, lo, hi, *, slack0, max_iter, warm=None, reps=1,
            polished=False):
        torch, bs = self.torch, self.bs
        dev = torch.device(DEVICE)
        t = lambda x, dt=np.float32: torch.tensor(np.ascontiguousarray(x, dtype=dt), device=dev)
        args = [t(x) for x in (A, b, c, lo, hi)]
        warm_t = None
        if warm is not None:
            warm_t = (t(warm[0], np.int32), t(warm[1], np.int32), t(warm[2]))
        kw = dict(slack0=slack0, max_iter=max_iter, **KERNEL_KW)
        m, n = A.shape[1], A.shape[2]
        wide, ms_k = timed(torch, lambda: bs._launch(*args, warm_t, **kw), reps)
        out_k = wide[0]
        if A.shape[0] == 1:
            one, ms_one = timed(torch, lambda: bs._launch(*args, warm_t, blocks=1, **kw))
            same_k1_bits(tag, wide, one, m)
            log(f"  {tag}: wide grid of {bs.default_blocks(dev, m, n)} blocks and one block "
                f"bit-identical (out row, B⁻¹); one_block_ms={ms_one:.3f}")
        out_p, ms_p = timed(torch, lambda: bs.simplex_plain(*args, warm_t, **kw), 1)
        res = []
        for out in (out_k, out_p):
            h = out.cpu().numpy()
            status = h[:, m + n]
            obj, ver, _x = bs._verify_f64(A, b, c, lo, hi, h[:, :m], h[:, m:m + n], status)
            res.append((h[:, :m], status, h[:, m + n + 1], obj, ver, h[:, m:m + n]))
        (bk, sk, nk, ok_, vk, xk), (bp, sp, np_, op, vp, xp) = res
        err, rel = assert_agree(tag, (sk, vk, ok_), (sp, vp, op), polished)
        self.max_abs_err = max(self.max_abs_err, err)
        same = int(sum((np.sort(x) == np.sort(y)).all() for x, y in zip(bk, bp)))
        self.times[tag] = (ms_k, ms_p)
        self.niter[tag] = nk
        log(f"  {tag}: B={A.shape[0]} m={m} n={n} status={np.bincount(sk).tolist()} "
            f"verified={int(vk.sum())}/{len(vk)} identical_bases={same}/{len(vk)} "
            f"pivots kernel={int(nk.sum())} plain={int(np_.sum())} "
            f"max_rel_obj_diff={rel:.3e} kernel_ms={ms_k:.3f} plain_ms={ms_p:.3f}")
        for i in np.flatnonzero(~(vk & vp))[:4]:
            gaps = [certificate_gaps(A[i], b[i], c[i], lo[i], hi[i], basis[i], vstat[i])
                    for basis, vstat in ((bk, xk), (bp, xp))]
            conds = [np.linalg.cond(np.asarray(A[i], dtype=np.float64)[:, basis[i]])
                     for basis in (bk, bp)]
            log(f"  {tag}: LP {i} verified kernel={bool(vk[i])} plain={bool(vp[i])}; f64 "
                f"(primal, dual) violation of the claim: kernel {gaps[0]}, plain {gaps[1]} "
                f"(certificate tolerance 1e-7); condition number of the final basis "
                f"kernel {conds[0]:.3e}, plain {conds[1]:.3e}")
        if A.shape[0] == 1 and vk[0] != vp[0]:
            self.parting(tag, args, warm_t, kw, (int(nk[0]), int(np_[0])), m, n,
                         tuple(x[0] for x in (A, b, c, lo, hi)))

    def parting(self, tag, args, warm_t, kw, pivots, m, n, lp):
        """Log where the kernel's path (`pivots` its and the plain
        version's pivots) goes astray on the LP `lp`: the first pivot at
        which its out rows and the plain version's part (bisecting
        `max_iter`), then, every 32 pivots of its own path from there, the
        exact bound violation of its basis, and the first pivot at which
        that exceeds feas_tol.  At each of the two pivots, what each side
        did (entering, leaving, bound flips) and the ratio test in exact f64
        from the basis before it (`explain`)."""
        bs, ftol = self.bs, kw["feas_tol"]
        run = lambda fn, k: fn(*args, warm_t, **dict(kw, max_iter=k))
        kern = lambda k: run(bs._launch, k)[0].cpu().numpy()[0]
        plain = lambda k: run(bs.simplex_plain, k).cpu().numpy()[0]
        violation = lambda row: certificate_gaps(*lp, row[:m], row[m:m + n])

        def first(lo_k, hi_k, parts):
            """The smallest k in (lo_k, hi_k] with parts(k), given parts(hi_k)."""
            while hi_k - lo_k > 1:
                mid = (lo_k + hi_k) // 2
                lo_k, hi_k = (lo_k, mid) if parts(mid) else (mid, hi_k)
            return hi_k

        k = first(0, max(pivots), lambda k: not np.array_equal(kern(k), plain(k)))
        log(f"  {tag}: the kernel's and the plain version's paths part at pivot {k} "
            f"of {pivots}: " + self.explain(lp, kern(k - 1), {"kernel": kern(k),
                                                              "plain": plain(k)}, m, n, kw))
        scan = {}
        for j in [*range(k, pivots[0], 32), pivots[0]]:
            scan[j] = violation(kern(j))
        keys = list(scan)
        changes = [j for i, j in enumerate(keys)
                   if scan[j][0] > 0.0 and (i == 0 or scan[j] != scan[keys[i - 1]])]
        log(f"  {tag}: the kernel's path from pivot {k}, every 32 pivots, where it changes: "
            f"(pivots: largest exact bound violation of its basis, that basic variable) "
            + ", ".join(f"{j}: {scan[j][0]:.3e} x{scan[j][2]}" for j in changes))
        over = [i for i, j in enumerate(keys) if scan[j][0] > ftol]
        if over and over[0] > 0:
            j = first(keys[over[0] - 1], keys[over[0]], lambda j: violation(kern(j))[0] > ftol)
            before, after = kern(j - 1), kern(j)
            watch = violation(after)[2]
            log(f"  {tag}: the kernel's basis first leaves its bounds by more than feas_tol "
                f"at pivot {j} ({violation(after)[0]:.3e}, x{watch}): "
                + self.explain(lp, before, {"kernel": after}, m, n, kw, watch=watch))
            from minilp_tpu_torch.status import VarStat

            entered = sorted(set(after[:m].tolist()) - set(before[:m].tolist()))
            if (watch in before[:m] and watch in after[:m] and len(entered) == 1
                    and int(before[m + entered[0]]) in (VarStat.AT_LOWER, VarStat.AT_UPPER)):
                # the kernel's own f32 state from its workspace (after four
                # m x m blocks: x_B, loB, hiB, cB, w), after pivot j - 1 and
                # after pivot j; w is still pivot j's FTRAN column, and the
                # entering row holds its new value, so the step t and the
                # watched row's x_B after the refresh before pivot j follow
                q = entered[0]
                at = lambda row, v: int(np.flatnonzero(row[:m] == v)[0])
                i, r = at(after, watch), at(after, q)
                ws0, ws1 = (run(bs._launch, k)[1].cpu().numpy()[4 * m * m:]
                            for k in (j - 1, j))
                vq = int(before[m + q])
                up = vq == VarStat.AT_LOWER  # it enters moving away from its bound
                base, s = (float(lp[3][q]), 1.0) if up else (float(lp[4][q]), -1.0)
                t = (float(ws1[r]) - base) * s
                x_ref = float(ws1[i]) - t * (-s * float(ws1[4 * m + i]))
                log(f"  {tag}: pivot {j} in the kernel's f32 state: x{watch}'s row {i}: "
                    f"bounds [{float(ws1[m + i])!r}, {float(ws1[2 * m + i])!r}], "
                    f"x_B {float(ws0[i])!r} after pivot {j - 1} and {float(ws1[i])!r} after "
                    f"pivot {j}, w {float(ws1[4 * m + i])!r}; entering x{q} (status {vq}) "
                    f"at row {r}: w {float(ws1[4 * m + r])!r}, new value {float(ws1[r])!r}, "
                    f"so the step t={t!r} and x{watch}'s x_B before it {x_ref!r}")

    @staticmethod
    def explain(lp, before, afters, m, n, kw, watch=None):
        """What each side did between the out row `before` and its row in
        `afters`, and, where some side entered a variable, that column's
        ratio test in exact f64 from `before`: the step t_rows, the tie
        window, the rule's row, and the ratio, |w| and x_B of each side's
        leaving row and of the row of the basic variable `watch`."""
        from minilp_tpu_torch.utils.k3_lane import f64_ratio_test

        basis = before[:m]
        b0, did, q = set(basis.tolist()), [], None
        rows = {}
        for side, after in afters.items():
            b1 = set(after[:m].tolist())
            flips = [int(j) for j in np.flatnonzero(before[m:m + n] != after[m:m + n])
                     if j not in b0 | b1]
            entered, left = sorted(b1 - b0), sorted(b0 - b1)
            did.append(f"{side} entered {entered} left {left} flipped {flips}")
            if entered:
                q = entered[0]
                rows[f"{side}'s leaving row"] = int(np.flatnonzero(basis == left[0])[0])
        if watch is not None and watch in b0:
            rows[f"row of x{watch}"] = int(np.flatnonzero(basis == watch)[0])
        if q is None:
            return "; ".join(did)
        xB, w, ratio, r64 = f64_ratio_test(lp, basis, before[m:m + n], q, kw["feas_tol"],
                                           kw["pivot_tol"])
        t = float(ratio.min())
        return "; ".join(did) + (
            f"; entering x{q} in exact f64: t_rows={t!r} window={t * 1.0001 + 1e-6!r} "
            f"rule's row {r64}; " + ", ".join(
                f"{name} {r}: ratio={float(ratio[r])!r} |w|={abs(float(w[r]))!r} "
                f"x_B={float(xB[r])!r}" for name, r in rows.items()))


def same_bits(tag, wide, one):
    """Raise unless two K2 launches' `StreamOut`s are equal bit for bit:
    basis, vstat, B⁻¹ (as int32) and the monitor; name the first
    differing index."""
    import torch

    for name in ("basis", "vstat", "Binv", "monitor"):
        a, b = getattr(wide, name), getattr(one, name)
        a, b = (x.view(torch.int32).reshape(-1) for x in (a, b))
        diff = torch.nonzero(a != b)
        if diff.numel():
            i = int(diff[0])
            raise AssertionError(f"{tag}: wide and one-block K2 differ in {name} "
                                 f"at flat index {i} ({int(a[i])} vs {int(b[i])})")


class CompareK2:
    """K2 against its plain version on the same device inputs: those of the
    main path's first launch (`prepare_launch` with the driver's options,
    at the shape `Problem.solve()` launches)."""

    def __init__(self, torch, ss, bs, options):
        self.torch, self.ss, self.bs = torch, ss, bs
        self.options = options  # canonical LP -> the driver's K2 options
        self.max_abs_err = 0.0
        self.times = {}
        self.counts = {}  # (m, n, pivots, majors, refreshes) per case

    def result(self, out, launch):
        """(basis, vstat, status, niter, obj, verified, x) of one launch,
        the objective, flag and vertex from the host's exact f64 check."""
        mon = out.monitor.cpu().numpy()
        basis, vstat = out.basis.cpu().numpy(), out.vstat.cpu().numpy()
        obj, ver, x = self.bs._verify_f64(
            launch.A[None], launch.b[None], launch.c[None], launch.lo[None],
            launch.hi[None], basis[None], vstat[None], mon[:1])
        return basis, vstat, int(mon[0]), int(mon[1]), float(obj[0]), bool(ver[0]), x[0]

    def check(self, tag, rk, rp, polished=False):
        err, rel = assert_agree(tag, (rk[2], rk[5], rk[4]), (rp[2], rp[5], rp[4]), polished)
        self.max_abs_err = max(self.max_abs_err, err)
        return rel

    def run(self, tag, can, *, hi=None, warm_state=None, repeat=False, polished=False,
            one_block=True, **over):
        """K2 and `stream_plain` on the first launch of `Problem.solve()`'s
        K2 route for `can` (upper bounds `hi`, `warm_state` and the options
        in `over` replacing the driver's where given); with `one_block`
        also K2 on one block, bit for bit."""
        torch, ss = self.torch, self.ss
        launch = ss.prepare_launch(
            can.A, can.b, can.c, can.lo, can.hi if hi is None else hi,
            warm_state=warm_state, **dict(self.options(can), **over))
        call = lambda fn, **kw: lambda: fn(*launch.args, launch.warm, **launch.kw, **kw)
        out_k, ms_k = timed(torch, call(ss.stream_kernel_call))
        rk = self.result(out_k, launch)
        majors, refreshes = out_k.monitor[5:7].tolist()
        m, n = launch.A.shape
        if one_block:
            one, ms_one = timed(torch, call(ss.stream_kernel_call, blocks=1))
            same_bits(tag, out_k, one)
            log(f"  {tag}: wide grid of {ss.default_blocks(DEVICE, m, n)} blocks and one "
                f"block bit-identical (basis, vstat, B⁻¹, monitor); one_block_ms={ms_one:.3f}")
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
        rel = self.check(tag, rk, rp, polished)
        same = bool((np.sort(rk[0]) == np.sort(rp[0])).all())
        self.times[tag] = (ms_k, ms_p)
        self.counts[tag] = (m, n, rk[3], majors, refreshes)
        log(f"  {tag}: m={m} n={n} max_iter={launch.kw['max_iter']} "
            f"long_step={launch.kw['long_step']} status={rk[2]} verified={rk[5]} "
            f"identical_bases={same} "
            f"pivots kernel={rk[3]} plain={rp[3]} majors={majors} refreshes={refreshes} "
            f"obj={rk[4]!r} "
            f"rel_obj_diff={rel:.3e} kernel_ms={ms_k:.3f} plain_ms={ms_p:.3f}")
        return rk


def chunked_wide_vs_one_block(torch, ss, can, options):
    """The 25fv47 chunk loop as `solve_streaming` makes it (chunks of 2048
    pivots, each relaunched warm from the last launch's basis, vstat and
    B⁻¹ until the status is no longer MAX_ITER), through
    `stream_kernel_call` once on one block and once on the default grid:
    every chunk's outputs bit-identical.  Returns the chunks' pivots."""
    from minilp_tpu_torch.status import Status

    launch = ss.prepare_launch(can.A, can.b, can.c, can.lo, can.hi,
                               **dict(options, chunk_iters=2048))
    runs, ms = {}, {}
    for blocks in (1, None):
        outs, warm = [], launch.warm
        t0 = time.perf_counter()
        for _chunk in range(-(-launch.max_iter // launch.kw["max_iter"])):
            out = ss.stream_kernel_call(*launch.args, warm, blocks=blocks, **launch.kw)
            outs.append(out)
            if int(out.monitor[0]) != int(Status.MAX_ITER):
                break
            warm = (out.basis, out.vstat, out.Binv)
        torch.cuda.synchronize()
        runs[blocks], ms[blocks] = outs, (time.perf_counter() - t0) * 1e3
    if len(runs[1]) != len(runs[None]):
        raise AssertionError(f"25fv47 chunked: {len(runs[None])} wide chunks, "
                             f"{len(runs[1])} on one block")
    for k, (wide, one) in enumerate(zip(runs[None], runs[1])):
        same_bits(f"25fv47 chunk {k}", wide, one)
    pivots = [int(o.monitor[1]) for o in runs[None]]
    log(f"  25fv47 chunks of 2048 through stream_kernel_call: {len(pivots)} chunks, "
        f"pivots {pivots}, every chunk bit-identical on the grid and on one block; "
        f"wall_ms grid={ms[None]:.1f} one_block={ms[1]:.1f}")
    return pivots


class CompareK3:
    """K3 against its plain version on the same device inputs, and its
    default layout against the "global" one."""

    def __init__(self, torch, ps):
        self.torch, self.ps = torch, ps
        self.max_abs_err = 0.0
        self.times = {}
        self.niter = {}  # the kernel's pivots per LP, per case

    def run(self, tag, A, b, c, lo, hi, *, slack0, max_iter=2000, reps=1,
            paths_may_part=False):
        from minilp_tpu_torch.ops.kernels.batched_simplex import verify_rows_f64

        torch, ps = self.torch, self.ps
        B, m, n = A.shape
        args = ps.upload_packed(A, b, c, lo, hi, pack=PACK, device=DEVICE)
        kw = dict(pack=PACK, slack0=slack0, max_iter=max_iter, **KERNEL_KW)
        # the first launch of each layout also loads its kernel: untimed
        out_k = ps.packed_kernel_call(*args, **kw)
        again, ms_k = timed(torch, lambda: ps.packed_kernel_call(*args, **kw), reps)
        if not torch.equal(out_k, again):
            raise AssertionError(f"{tag}: a second kernel run differs")
        layout = ps.pick_layout(PACK, m, n)
        glob = ps.packed_kernel_call(*args, layout="global", **kw)
        _glob, ms_g = timed(torch, lambda: ps.packed_kernel_call(*args, layout="global", **kw))
        if not torch.equal(out_k, glob):
            raise AssertionError(f"{tag}: the {layout} and global layouts differ")
        out_p, ms_p = timed(torch, lambda: ps.packed_plain(*args, **kw), 1)
        rk, rp = (verify_rows_f64(o.cpu().numpy(), A, b, c, lo, hi) for o in (out_k, out_p))
        if paths_may_part:
            err, parted = agree_where_paths_agree(tag, rk, rp)
            rel = float("nan")
            log(f"  {tag}: lanes of other pivots than the plain version's {parted}; "
                f"unverified kernel {np.flatnonzero(~rk.verified).tolist()} "
                f"plain {np.flatnonzero(~rp.verified).tolist()}")
        else:
            err, rel = assert_agree(tag, (rk.status, rk.verified, rk.obj),
                                    (rp.status, rp.verified, rp.obj))
        self.max_abs_err = max(self.max_abs_err, err)
        self.times[tag] = (ms_k, ms_p)
        self.niter[tag] = rk.niter
        packs = rk.niter.reshape(-1, PACK)
        log(f"  {tag}: B={B} m={m} n={n} pack={PACK} status={np.bincount(rk.status).tolist()} "
            f"verified={int(rk.verified.sum())}/{B} unverified_lanes="
            f"{np.flatnonzero(~rk.verified).tolist()[:8]} second run identical, "
            f"layout={layout} (smem {ps.smem_bytes(PACK, m, n, layout)} B per block) "
            f"bit-identical to global (global_ms={ms_g:.3f}), "
            f"pivots kernel={int(rk.niter.sum())} plain={int(rp.niter.sum())} "
            f"lockstep={packs.max(1).sum() * PACK / max(int(rk.niter.sum()), 1):.3f} "
            f"max_rel_obj_diff={rel:.3e} kernel_ms={ms_k:.3f} plain_ms={ms_p:.3f}")
        return rk


def agree_where_paths_agree(tag, rk, rp):
    """K3 (rk) and its plain version (rp) as `BatchResult`s on a batch where
    f32 reduction orders may part their pivot paths: the same status on
    every lane; the same `verified` flag and certified objectives within
    REL_KERNEL on each lane where both took the same pivots; and a lane
    left unverified by one and not the other only where the paths parted.
    Returns the largest absolute objective difference and the lanes of
    other pivots."""
    if not (rk.status == rp.status).all():
        raise AssertionError(f"{tag}: status kernel vs plain differ on lanes "
                             f"{np.flatnonzero(rk.status != rp.status).tolist()}")
    same = rk.niter == rp.niter
    if not (rk.verified == rp.verified)[same].all():
        raise AssertionError(f"{tag}: verified differs on lanes of the same pivots "
                             f"{np.flatnonzero(same & (rk.verified != rp.verified)).tolist()}")
    both = same & rk.verified
    err = np.abs(rk.obj - rp.obj)[both]
    if (err / (1.0 + np.abs(rp.obj[both]))).max() > REL_KERNEL:
        raise AssertionError(f"{tag}: certified objectives differ")
    return float(err.max()), np.flatnonzero(~same).tolist()


def highs_gaps(lanes, results, tol=REL_HIGHS):
    """Largest relative gap of certified objectives to scipy's HiGHS on the
    given (A, b, c, lo, hi) lanes, each equality-form and minimized; raises
    above `tol`."""
    from scipy.optimize import linprog

    worst = 0.0
    for (A, b, c, lo, hi), got in zip(lanes, results):
        bounds = [(lo[j] if np.isfinite(lo[j]) else None,
                   hi[j] if np.isfinite(hi[j]) else None) for j in range(c.size)]
        r = linprog(c, A_eq=A, b_eq=b, bounds=bounds, method="highs")
        if r.status != 0:
            raise RuntimeError(f"HiGHS failed: {r.message}")
        worst = max(worst, abs(got - r.fun) / (1.0 + abs(r.fun)))
    if worst > tol:
        raise AssertionError(f"certified objectives {worst:.3e} from HiGHS")
    return worst


def mixed_lps(seed):
    """A heterogeneous list: three sizes of the bench's random LPs."""
    from minilp_tpu_torch.utils.synth import random_batch

    lps = []
    for k, (count, m, nv) in enumerate([(40, 16, 48), (30, 24, 72), (50, 32, 96)]):
        A, b, c, lo, hi = random_batch(seed + k, count, m, nv)
        lps += [(A[i], b[i], c[i], lo[i], hi[i]) for i in range(count)]
    return lps


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


def solve_main_path(tag, make, want, event, rec_path, reps=2, ref=None):
    """`Problem.solve()` of fresh copies: the record, certificate and HiGHS
    gap of each, and the gap to the reference's certified objective `ref`
    where given; returns the cold solve's (walls, stages, pivots)."""
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
        if ref is not None and abs(got - ref) > REL_REF * (1.0 + abs(ref)):
            raise AssertionError(f"{tag}: objective {got!r} vs the reference's {ref!r}")
    log(f"  {tag}: objective={sols[0].objective()!r} highs={want!r} "
        f"pivots={sols[0]._engine.iterations()} "
        f"walls_s={[round(w, 3) for w in walls]} "
        f"polished={any('host_polish_s' in st for st in stages)} "
        f"cold_stages={stages[0]}")
    return walls, stages, sols[0]._engine.iterations()


def compare_k3(torch, batch=BATCH):
    """Phase 3c: K3 against its plain version and its "global" layout on the
    bench's batch (seed 0, and phase 5's first batch, seed 1), on a
    replicated canonical instance and on one `solve_heterogeneous` bucket;
    then `k3_split` at the bench's batch."""
    from minilp_tpu_torch.ops.kernels import packed_simplex as ps
    from minilp_tpu_torch.parallel import scheduling
    from minilp_tpu_torch.utils import k3_split
    from minilp_tpu_torch.utils.synth import random_batch

    log("[3c] K3 (CUDA) vs plain torch on the card")
    cmp3 = CompareK3(torch, ps)
    cmp3.run(f"batch{batch}_32x128", *random_batch(0, batch, BATCH_M, BATCH_NV),
             slack0=BATCH_NV, reps=5)
    seed1 = cmp3.run(f"batch{batch}_32x128_seed1", *random_batch(1, batch, BATCH_M, BATCH_NV),
                     slack0=BATCH_NV, paths_may_part=True)
    if batch == BATCH and np.flatnonzero(~seed1.verified).tolist() != K3_UNVERIFIED_SEED1:
        raise AssertionError(f"seed 1: K3 left lanes {np.flatnonzero(~seed1.verified).tolist()} "
                             f"unverified, expected {K3_UNVERIFIED_SEED1}")
    can = canonical_instance(60, 150, 0.06, seed=11)
    tile = lambda x: np.broadcast_to(x, (2 * PACK,) + x.shape).copy()
    cmp3.run("netlib_shaped_60x150_replicated",
             *(tile(x) for x in (can.A, can.b, can.c, can.lo, can.hi)),
             slack0=can.nv, max_iter=32 * (can.M + can.N) + 1000)
    _parsed, buckets = scheduling.bucket_lps(mixed_lps(50), pack=PACK)
    bucket = buckets[0]
    cmp3.run(f"heterogeneous_bucket_{bucket.M}x{bucket.NV + bucket.M}", *bucket.batch,
             slack0=bucket.NV)
    if batch == BATCH:
        got = {tag: int(cmp3.niter[tag].sum()) for tag in K3_PIVOTS}
        if got != K3_PIVOTS:
            raise AssertionError(f"K3's pivots {got}, expected {K3_PIVOTS}")
        log(f"  K3's pivots repeated: {got}")
        k3s = k3_split.split(clocks=False)
        log(f"  k3_split at batch {k3s['batch']} (layout {k3s['layout']}, smem "
            f"{k3s['smem_bytes']} B per block): refresh_ms={k3s['refresh_ms']:.4f} "
            f"iter_us={k3s['iter_us']:.3f} default run {k3s['default']} "
            f"start {k3s['one_pivot']}")
    return cmp3


def cert_close(got, ref, rel=REL_CERT):
    """Elementwise: got within rel · max(1, |ref|) of ref, an equal infinity
    or both NaN."""
    got, ref = np.asarray(got), np.asarray(ref)
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    with np.errstate(invalid="ignore"):
        return same | (np.abs(got - ref) <= rel * np.maximum(1.0, np.abs(ref)))


def crafted_certificate_batch(lp, basis, vstat, status, x, nv):
    """The first 16 lanes of a solved batch (`lp`, its basis, vstat, status
    and the host's x; nv structural columns) with lane 1 exactly singular (a
    basic column of A zeroed), lane 2's status MAX_ITER and lane 3's
    largest basic structural above a cut upper bound."""
    from minilp_tpu_torch.status import Status

    A, b, c, lo, hi = (np.array(v[:16]) for v in lp)
    basis, vstat, status = (np.array(v[:16]) for v in (basis, vstat, status))
    A[1][:, basis[1, 3]] = 0.0
    status[2] = int(Status.MAX_ITER)
    j = max((int(k) for k in basis[3] if k < nv), key=lambda k: x[3, k])
    hi[3, j] = 0.5 * x[3, j]
    return (A, b, c, lo, hi), (basis, vstat, status)


def compare_certify(torch, batch=BATCH):
    """Phase 5b: the certificate kernel against `certify_plain` on the card,
    on the same device inputs, and both against the host's `_verify_f64`
    (module docstring); returns the kernel's figures at the bench's batch."""
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs
    from minilp_tpu_torch.ops.kernels import certify
    from minilp_tpu_torch.ops.kernels import packed_simplex as ps
    from minilp_tpu_torch.parallel import scheduling
    from minilp_tpu_torch.utils.synth import random_batch

    log("[5b] the f64 certificate (CUDA) vs plain torch and the host's _verify_f64")

    def rows_of(lp, slack0, kernel):
        """(basis, vstat, status) of K3's or K1's launch on `lp`, on the
        card, and the pivots."""
        data = bs.upload(DEVICE, *lp)
        if kernel == "K3":
            out = ps.packed_kernel_call(*ps.packed_args(*data, pack=PACK), pack=PACK,
                                        slack0=slack0, max_iter=2000, **KERNEL_KW)
        else:
            out = bs.megakernel_rows(*data, slack0=slack0, max_iter=2000, **KERNEL_KW)
        B, m, n = data[0].shape
        rows = out.reshape(B, m + n + 2)
        return ([rows[:, :m].contiguous(), rows[:, m:m + n].contiguous(),
                 rows[:, m + n].contiguous()], rows[:, -1].cpu().numpy())

    def check(tag, lp, ints, source):
        """The kernel (twice, and in the global layout), the plain version
        and the host on one case; returns (figures, the host's x)."""
        data = bs.upload(DEVICE, *lp)
        B, m, n = data[0].shape
        args = (*data, *ints)
        first = certify.certify_kernel_call(*args)  # also loads the kernel
        ms_k = min(timed(torch, lambda: certify.certify_kernel_call(*args))[1] for _ in range(3))
        again = certify.certify_kernel_call(*args)
        glob = certify.certify_kernel_call(*args, layout="global")
        ms_g = min(timed(torch, lambda: certify.certify_kernel_call(*args, layout="global"))[1]
                   for _ in range(3))
        for name, other in (("a second run", again), ("the global layout", glob)):
            if not all(torch.equal(u, v) for u, v in zip(first, other)):
                raise AssertionError(f"{tag}: the certificate differs on {name}")
        certify.certify_plain(*args)  # the first call of torch's batched LU loads it
        plain, ms_p = timed(torch, lambda: certify.certify_plain(*args))
        host_in = [np.asarray(v) for v in lp] + [v.cpu().numpy() for v in ints]
        t0 = time.perf_counter()
        oh, vh, xh = bs._verify_f64(*host_in)
        ms_h = (time.perf_counter() - t0) * 1e3
        (ok, vk, xk), (op, vp, xp) = [[t.cpu().numpy() for t in r] for r in (first, plain)]
        if not ((vk == vp).all() and cert_close(ok, op).all() and cert_close(xk, xp).all()):
            raise AssertionError(f"{tag}: the kernel and the plain version differ: verified on "
                                 f"lanes {np.flatnonzero(vk != vp).tolist()}, or obj or x "
                                 f"beyond {REL_CERT} relative")
        x_host, keep = xh, slice(None)
        if tag == "crafted":
            # the host's batched solve fails every lane on lane 1's singular
            # basis; the kernel and the plain version fail lane 1 alone (and
            # lanes 2 and 3 on their edits), and the other lanes are the
            # host's answer without lane 1
            want = [True, False, False, False] + [True] * 12
            if vh.any() or vk.tolist() != want:
                raise AssertionError(f"crafted: verified kernel {vk.tolist()}, host "
                                     f"{vh.tolist()}")
            keep = np.arange(B) != 1
            oh, vh, xh = bs._verify_f64(*(v[keep] for v in host_in))
        if not ((vk[keep] == vh).all() and cert_close(ok[keep], oh).all()
                and cert_close(xk[keep], xh).all()):
            raise AssertionError(f"{tag}: the kernel and the host differ: verified on lanes "
                                 f"{np.flatnonzero(vk[keep] != vh).tolist()}, or obj or x "
                                 f"beyond {REL_CERT} relative")
        err = max(float(np.abs(ok - op)[np.isfinite(op)].max(initial=0.0)),
                  float(np.abs(xk - xp)[np.isfinite(xp)].max(initial=0.0)))
        bnd = certify_bound(B, m, n)
        layout = certify.pick_layout(m, n)
        unver = np.flatnonzero(~first[1].cpu().numpy()).tolist()
        log(f"  {tag} ({source}): B={B} m={m} n={n} layout={layout} (smem "
            f"{certify.smem_bytes(m, n, layout)} B) bit-identical to global and on a second "
            f"run; verified={B - len(unver)}/{B} unverified={unver[:8]}; the same flags as "
            f"plain and host; max_abs_err vs plain={err:.3e}; kernel_ms={ms_k:.4f} "
            f"global_ms={ms_g:.4f} plain_ms={ms_p:.3f} host_ms={ms_h:.3f} "
            f"bound_ms={bnd[0]:.5f} ({bnd[1]})")
        return dict(ms=ms_k, plain_ms=ms_p, host_ms=ms_h, global_ms=ms_g, bound=bnd,
                    max_abs_err=err, unverified=unver), x_host

    bucket = scheduling.bucket_lps(mixed_lps(50), pack=PACK)[1][0]
    seed0 = random_batch(0, batch, BATCH_M, BATCH_NV)
    cases = {f"bench_seed0_{batch}x32x128": (seed0, BATCH_NV, "K3"),
             f"phase5_seed1_{batch}x32x128": (random_batch(1, batch, BATCH_M, BATCH_NV),
                                             BATCH_NV, "K3"),
             f"bucket_{bucket.M}x{bucket.NV + bucket.M}": (bucket.batch, bucket.NV, "K3"),
             f"scenario_{SCENARIOS[0]}x{SCENARIOS[1]}x{sum(SCENARIOS[1:])}": (
                 random_batch(0, *SCENARIOS), SCENARIOS[2], "K1")}
    figures = {}
    for tag, (lp, slack0, kernel) in cases.items():
        ints, niter = rows_of(lp, slack0, kernel)
        figures[tag], x_host = check(tag, lp, ints, f"{kernel}'s rows")
        if lp is seed0:
            if batch == BATCH and int(niter.sum()) != K3_PIVOTS[f"batch{BATCH}_32x128"]:
                raise AssertionError(f"seed 0: K3 took {int(niter.sum())} pivots")
            lib_ms = library_certificate_ms(torch, *bs.upload(DEVICE, *lp), *ints)
            figures[tag]["library_ms"] = lib_ms
            log(f"  {tag}: library calls (A·x_N, lu_factor_ex, two lu_solve, Aᵀy) "
                f"ms={lib_ms:.4f}")
            crafted = crafted_certificate_batch(lp, *(v.cpu().numpy() for v in ints),
                                                x_host, BATCH_NV)
    lp, ints = crafted
    check("crafted", lp, [torch.tensor(v, device=DEVICE) for v in ints],
          "seed 0's first 16 lanes: lane 1 singular, 2 MAX_ITER, 3 above a bound")
    if batch == BATCH and figures[f"phase5_seed1_{batch}x32x128"]["unverified"] != \
            K3_UNVERIFIED_SEED1:
        raise AssertionError(f"seed 1: unverified lanes, expected {K3_UNVERIFIED_SEED1}")
    out = dict(figures[f"bench_seed0_{batch}x32x128"])
    out["max_abs_err"] = max(f["max_abs_err"] for f in figures.values())
    return out


def library_certificate_ms(torch, A, b, c, lo, hi, basis, vstat, status):
    """The least of 3 CUDA-event times of PyTorch's own calls for the
    certificate's linear algebra on the same inputs: A·x_N, one batched
    `lu_factor_ex`, two `lu_solve` (B x_B = rhs, Bᵀy = c_B) and Aᵀy (the
    gathers and the checks are not counted)."""
    from minilp_tpu_torch.status import VarStat

    B, m, n = A.shape
    idx = basis.long()
    Bmat = torch.gather(A, 2, idx[:, None, :].expand(B, m, m)).contiguous()
    at_lo = (vstat == int(VarStat.AT_LOWER)) | (vstat == int(VarStat.FIXED))
    xN = torch.where(at_lo, lo, torch.where(vstat == int(VarStat.AT_UPPER), hi, 0.0))[..., None]
    cB = torch.gather(c, 1, idx)[..., None]

    def run():
        rhs = b[..., None] - torch.bmm(A, xN)
        LU, piv, _info = torch.linalg.lu_factor_ex(Bmat)
        xB = torch.linalg.lu_solve(LU, piv, rhs)
        y = torch.linalg.lu_solve(LU, piv, cB, adjoint=True)
        return xB, c - torch.bmm(y.transpose(1, 2), A)[:, 0]

    run()
    return min(timed(torch, run)[1] for _ in range(3))


def batched_main_path(torch, batch=BATCH):
    """Phase 5: `solve_batches_pipelined` as bench.py's batched line runs it,
    then `solve_heterogeneous` on a mixed list (K3's launches counted over
    both), `solve_batch_certified` through K1, each certified on the card
    (the host's `_verify_f64` never called), and K3 alone on one
    device-resident batch.  Returns K3's and the certificate's launches on
    the batched path."""
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs
    from minilp_tpu_torch.ops.kernels import certify
    from minilp_tpu_torch.ops.kernels import packed_simplex as ps
    from minilp_tpu_torch.parallel import batched, scheduling
    from minilp_tpu_torch.utils import profiling
    from minilp_tpu_torch.utils.synth import random_batch

    log("[5] batched main path through K3: solve_batches_pipelined on the card")
    run_pipelined = lambda bs_: batched.solve_batches_pipelined(
        bs_, device=DEVICE, pack=PACK, max_iter=2000, structural_cols=BATCH_NV)
    batches = [random_batch(1 + k, batch, BATCH_M, BATCH_NV) for k in range(4)]
    ps.launches = certify.launches = 0  # counts from here on are the batched path's
    with host_checks_counted() as host_checks:
        run_pipelined([random_batch(0, batch, BATCH_M, BATCH_NV)])  # warm-up batch
        walls, rep_stages = [], []
        for _rep in range(3):
            profiling.reset_stages()
            t0 = time.perf_counter()
            results = run_pipelined(batches)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t0)
            rep_stages.append(profiling.stages(None))
    if ps.launches != 1 + 3 * len(batches) or certify.launches != ps.launches:
        raise AssertionError(f"pipelined: {ps.launches} K3 launches and {certify.launches} "
                             f"certificate launches for {1 + 3 * len(batches)} batches")
    lps_s = sorted(len(batches) * batch / w for w in walls)
    verified = np.concatenate([r.verified for r in results])
    if not verified.all():
        raise AssertionError(f"pipelined: {int((~verified).sum())} lanes not certified")
    niter = np.concatenate([r.niter for r in results])
    pack_max = niter.reshape(-1, PACK).max(1)
    sample = np.random.default_rng(0).choice(len(batches) * batch, 64, replace=False)
    lanes = [tuple(x[i % batch] for x in batches[i // batch]) for i in sample]
    gap = highs_gaps(lanes, [float(results[i // batch].obj[i % batch]) for i in sample],
                     tol=1e-9)
    log(f"  pipelined 4 x {batch} (32x128, pack {PACK}, structural upload, the certificate "
        f"on the card): certified LPs/s median={lps_s[1]:.1f} "
        f"spread={lps_s[0]:.1f}..{lps_s[2]:.1f} "
        f"walls_s={[round(w, 4) for w in walls]} verified={int(verified.sum())}/{verified.size} "
        f"status={np.bincount(np.concatenate([r.status for r in results])).tolist()} "
        f"pivots mean={niter.mean():.2f} pack-max mean={pack_max.mean():.2f} "
        f"max_rel_gap_highs_64={gap:.3e}; certificate launches {certify.launches} "
        f"(one a batch)")
    log(f"  stages per repetition (4 batches): {rep_stages}")

    lps = mixed_lps(50)
    n_buckets = len(scheduling.bucket_lps(lps, pack=PACK)[1])
    cert0 = certify.launches
    t0 = time.perf_counter()
    with host_checks_counted() as more:
        het = scheduling.solve_heterogeneous(lps, pack=PACK, device=DEVICE)
    host_checks += more
    wall_het = time.perf_counter() - t0
    if not all(r.verified for r in het) or certify.launches - cert0 != n_buckets:
        raise AssertionError(f"solve_heterogeneous: certified {sum(r.verified for r in het)}"
                             f"/{len(het)}, {certify.launches - cert0} certificate launches "
                             f"for {n_buckets} buckets")
    pick = list(range(0, len(lps), 10))
    gap_het = highs_gaps([lps[i] for i in pick], [het[i].obj for i in pick])
    k3_launches = ps.launches
    log(f"  solve_heterogeneous ({len(lps)} LPs in {n_buckets} buckets): "
        f"wall_s={wall_het:.4f} max_rel_gap_highs_{len(pick)}={gap_het:.3e}")
    log(f"  K3 launches on the batched path: {k3_launches}")

    bs.launches = 0
    cert0 = certify.launches
    t0 = time.perf_counter()
    with host_checks_counted() as more:
        cert = batched.solve_batch_certified(*batches[0], device=DEVICE)
    host_checks += more
    wall_k1 = time.perf_counter() - t0
    if not cert.verified.all() or bs.launches != 1 or certify.launches - cert0 != 1:
        raise AssertionError("solve_batch_certified: not all lanes certified through K1 "
                             "and one certificate launch")
    gap_k1 = highs_gaps([tuple(x[i] for x in batches[0]) for i in range(16)],
                        [float(o) for o in cert.obj[:16]])
    log(f"  solve_batch_certified (K1, batch {batch}): wall_s={wall_k1:.4f} "
        f"pivots={int(cert.niter.sum())} max_rel_gap_highs_16={gap_k1:.3e}")
    if host_checks:
        raise AssertionError(f"the batch entry points called the host's _verify_f64 on "
                             f"{host_checks}")
    cert_launches = certify.launches
    log(f"  certificate launches on the batched path: {cert_launches}; the host's "
        f"_verify_f64 called 0 times")

    # the kernels alone on one device-resident batch, K3 and then K1
    n = BATCH_M + BATCH_NV
    dev_args = ps.upload_packed(*batches[0], pack=PACK, device=DEVICE)
    out, ms = timed(torch, lambda: ps.packed_kernel_call(
        *dev_args, pack=PACK, slack0=BATCH_NV, max_iter=2000, **KERNEL_KW), 3)
    niter3 = out[..., -1].cpu().numpy().ravel()
    dev_args = [torch.tensor(np.asarray(x, dtype=np.float32), device=DEVICE)
                for x in batches[0]]
    out, ms1 = timed(torch, lambda: bs.simplex_kernel_call(
        *dev_args, slack0=BATCH_NV, max_iter=2000, **KERNEL_KW), 3)
    niter1 = out[:, -1].cpu().numpy()
    for name, t, it in (("K3", ms, niter3), ("K1", ms1, niter1)):
        bnd = dense_simplex_bound(it, BATCH_M, n)
        log(f"  {name} alone on one device-resident batch of {batch}: {t:.3f} ms "
            f"({batch / t * 1e3:.0f} LPs/s, no host verification), pivots={int(it.sum())}, "
            f"bound_ms={bnd[0]:.5f} ({bnd[1]})")
    return k3_launches, cert_launches


#: phase 6's node chains: tag -> (problem, options, cold-solve event, the
#: re-solves' event suffix); (a) the default route, (b) K1 warm, (c) K2 warm
CHAINS = {
    "a_default_256x1024": ("256x1024", {}, "cold_solve_megakernel", "_host"),
    "a_default_512x2048": ("512x2048", {}, "cold_solve_megakernel", "_host"),
    "b_megakernel_512x2048": ("512x2048", {"use_megakernel": "always"},
                              "cold_solve_megakernel", "_megakernel"),
    "c_streaming_25fv47": ("25fv47", {"use_streaming": "always"},
                           "cold_solve_streaming", "_streaming"),
}


def chain_problem(shape):
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    if shape in SINGLE_LP:
        return netlib_shaped_problem(*SINGLE_LP[shape], seed=11)
    return netlib_shaped_problem(*NETLIB[shape], seed=1)


@contextlib.contextmanager
def recording_launches(cold=False):
    """Record the warm K1 and K2 launches that the driver's routes make (and
    with `cold` the cold ones too): a list of dicts (route, a copy of the
    canonical LP, the warm state or None, whether the driver polished the
    claim)."""
    from minilp_tpu_torch.engine import driver

    names = ("_try_megakernel_solve", "_try_streaming_solve", "_host_polish_from_basis")
    saved = {name: getattr(driver, name) for name in names}
    seen, current = [], []

    def route(name):
        def call(can, opts, warm_state=None):
            if warm_state is None and not cold:
                return saved[name](can, opts)
            seen.append(dict(route=name, polished=False,
                             warm=None if warm_state is None
                             else tuple(np.array(x) for x in warm_state),
                             can=dataclasses.replace(can, A=can.A.copy(), b=can.b.copy(),
                                                     c=can.c.copy(), lo=can.lo.copy(),
                                                     hi=can.hi.copy())))
            current.append(seen[-1])
            try:
                return saved[name](can, opts, warm_state=warm_state)
            finally:
                current.pop()
        return call

    def polish(*args, **kw):
        if current:
            current[-1]["polished"] = True
        return saved["_host_polish_from_basis"](*args, **kw)

    driver._try_megakernel_solve = route("_try_megakernel_solve")
    driver._try_streaming_solve = route("_try_streaming_solve")
    driver._host_polish_from_basis = polish
    try:
        yield seen
    finally:
        for name, fn in saved.items():
            setattr(driver, name, fn)


def compare_launches(tag, seen, max_iter, cmp_k1, cmp_k2, one_block=True):
    """Hold a path's recorded kernel launches (`recording_launches`) against
    their plain versions on the same inputs: the first, the first at each
    new padded row count (the row capacity grew), and every one whose claim
    the driver polished (`assert_agree`'s `polished`).  `one_block=False`
    skips K2's one-block rerun."""
    shapes = set()
    for i, launch in enumerate(seen):
        can, warm = launch["can"], launch["warm"]
        pick = i == 0 or can.M not in shapes or launch["polished"]
        shapes.add(can.M)
        if not pick:
            continue
        kind = "cold" if warm is None else "warm"
        name = (f"{tag} {kind} launch {i} M={can.M}"
                + (" (polished)" if launch["polished"] else ""))
        if launch["route"] == "_try_megakernel_solve":
            cmp_k1.run(name, can.A[None], can.b[None], can.c[None], can.lo[None], can.hi[None],
                       slack0=can.nv, max_iter=max_iter(can.M, can.N),
                       warm=None if warm is None else tuple(x[None] for x in warm),
                       polished=launch["polished"])
        else:
            cmp_k2.run(name, can, warm_state=warm, polished=launch["polished"],
                       one_block=one_block)


def incremental_main_path(torch, rec_path, cmp_k1, cmp_k2, chains=CHAINS):
    """Phase 6: one node chain per case of `chains` (module docstring), the
    kernel chains' warm launches then held against the plain versions by
    `cmp_k1` and `cmp_k2`; returns the warm launches of K1 and K2 over all
    chains."""
    from minilp_tpu_torch import SolverOptions
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs
    from minilp_tpu_torch.ops.kernels import streaming_simplex as ss
    from minilp_tpu_torch.utils.node_chain import highs_outcome, run_chain

    log("[6] incremental main path: node chains through the incremental API on the card")
    warm = {"batched_simplex": 0, "streaming_simplex": 0}
    for tag, (shape, options, cold_event, suffix) in chains.items():
        prob = chain_problem(shape)
        prob.options = SolverOptions(device=DEVICE, **options)
        n_rec = len(rec_path.read_text().splitlines()) if rec_path.exists() else 0
        t0 = time.perf_counter()
        sol = prob.solve()
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
        events = [json.loads(line)["event"]
                  for line in rec_path.read_text().splitlines()[n_rec:]]
        if events != [cold_event] or not sol._engine.certified:
            raise AssertionError(f"{tag}: cold solve records {events}, "
                                 f"certified {sol._engine.certified}")
        k1, k2, cold_pivots = bs.launches, ss.launches, sol._engine.iterations()
        with recording_launches() as seen:
            nodes = run_chain(sol, log_path=rec_path, sync=torch.cuda.synchronize)
        k1, k2 = bs.launches - k1, ss.launches - k2
        for i, node in enumerate(nodes):
            want = ("primal_resolve" if node.edit == "unfix_var" else "dual_resolve") + suffix
            outcome, ref = highs_outcome(node.problem)
            name = f"{tag} node {i} {node.edit}"
            if node.outcome != "optimal":
                # an infeasible cut ends the chain; an f32 kernel's INFEASIBLE
                # is confirmed by an exact engine, whose record it then is
                ok = (node.outcome == "Infeasible" and outcome == "infeasible"
                      and i == len(nodes) - 1 and node.edit == "add_constraint"
                      and node.events[-1:] in ([want], ["dual_resolve"]))
                if not ok:
                    raise AssertionError(f"{name}: {node.outcome}, HiGHS {outcome}, "
                                         f"records {node.events}")
                log(f"  {name}: {node.outcome} (HiGHS {outcome}) records={node.events} "
                    f"wall_s={node.wall_s:.4f}")
                continue
            if node.events != [want]:
                raise AssertionError(f"{name}: solve records {node.events}, expected {[want]}")
            if not node.certified:
                raise AssertionError(f"{name}: solution not certified")
            if outcome != "optimal" or abs(node.objective - ref) > REL_HIGHS * (1.0 + abs(ref)):
                raise AssertionError(f"{name}: objective {node.objective!r} vs HiGHS "
                                     f"{outcome} {ref!r}")
            log(f"  {name}: {node.events[0]} wall_s={node.wall_s:.4f} pivots={node.pivots} "
                f"certified={node.certified} objective={node.objective!r} "
                f"rel_gap_highs={abs(node.objective - ref) / (1.0 + abs(ref)):.3e} "
                f"stages={node.stages}")
        done = [n for n in nodes if n.outcome == "optimal"]
        cuts = [n for n in done if n.edit == "add_constraint"]
        if suffix == "_host" and (k1 or k2):
            raise AssertionError(f"{tag}: host re-solves launched K1 {k1} and K2 {k2} times")
        if suffix == "_megakernel" and (k1 < len(done) or k2):
            raise AssertionError(f"{tag}: {k1} K1 and {k2} K2 launches for {len(done)} nodes")
        if suffix == "_streaming" and (k2 < len(done) or k1):
            raise AssertionError(f"{tag}: {k2} K2 and {k1} K1 launches for {len(done)} nodes")
        warm["batched_simplex"] += k1
        warm["streaming_simplex"] += k2
        mean = lambda xs: float(np.mean(xs)) if xs else float("nan")
        log(f"  {tag}: cold_s={cold_s:.3f} cold_pivots={cold_pivots} "
            f"nodes={len(nodes)} (cuts {len(cuts)}) "
            f"mean_wall_s={mean([n.wall_s for n in done]):.4f} "
            f"mean_pivots={mean([n.pivots for n in done]):.1f} "
            f"cuts: mean_wall_s={mean([n.wall_s for n in cuts]):.4f} "
            f"mean_pivots={mean([n.pivots for n in cuts]):.1f} "
            f"warm launches K1={k1} K2={k2}")
        if k1 + k2 < len(seen):
            raise AssertionError(f"{tag}: {len(seen)} warm kernel calls recorded, "
                                 f"{k1 + k2} launches counted")
        compare_launches(tag, seen, prob.options.effective_max_iter, cmp_k1, cmp_k2)
    log(f"  warm launches on the incremental path: K1 {warm['batched_simplex']}, "
        f"K2 {warm['streaming_simplex']}; {smi_name_power()}")
    return warm


def maros_highs() -> float:
    """HiGHS on the maros-r7 shape: phase 7(a)'s oracle, run in process
    after the solve it checks (it takes minutes)."""
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    return highs_objective(netlib_shaped_problem(*MAROS, seed=1))


@contextlib.contextmanager
def recording_device_chunks():
    """Record the crossover's stages as they run: the device stage chunk by
    chunk (the operator's dtype and device, the iterations after the chunk
    and its wall, from `pdhg.solve_pdhg`; the host's f64 KKT of its
    iterate, from `crossover.kkt_error_f64`), and each launch of the host
    stage (`pdhg.solve_pdhg_sparse`: warm from the device iterate or
    cold)."""
    from minilp_tpu_torch.engine import crossover, pdhg

    saved = pdhg.solve_pdhg, crossover.kkt_error_f64, pdhg.solve_pdhg_sparse
    chunks, host = [], []

    def solve(A, *args, **kw):
        t0 = time.perf_counter()
        st = saved[0](A, *args, **kw)
        chunks.append(dict(phase=str(A.dtype).replace("torch.", ""), device=A.device.type,
                           niter=int(st.niter), wall_s=time.perf_counter() - t0))
        return st

    def kkt(*args):
        err = saved[1](*args)
        if chunks and "kkt" not in chunks[-1]:
            chunks[-1]["kkt"] = err
        return err

    def host_stage(*args, **kw):
        host.append("warm" if kw.get("state0") is not None else "cold")
        return saved[2](*args, **kw)

    pdhg.solve_pdhg, crossover.kkt_error_f64, pdhg.solve_pdhg_sparse = solve, kkt, host_stage
    try:
        yield chunks, host
    finally:
        pdhg.solve_pdhg, crossover.kkt_error_f64, pdhg.solve_pdhg_sparse = saved


def pdhg_step_ms(torch, can, windows=32):
    """ms of one f32 halpern PDHG iteration of the device stage at `can`'s
    shape, by CUDA events: (a run of 1 + `windows` windows − a run of one
    window) over the iterations between, so Ruiz and ‖A‖₂ drop out."""
    from minilp_tpu_torch import SolverOptions
    from minilp_tpu_torch.engine import crossover, pdhg

    opts = crossover.stage_options(SolverOptions(), 1e-4)
    put = lambda v: torch.as_tensor(np.asarray(v, np.float32), device=DEVICE)
    args = [put(v) for v in (can.A, can.b, can.c, can.lo, can.hi)]
    every = opts.pdhg_check_every
    _, t1 = timed(torch, lambda: pdhg.solve_pdhg(*args, opts=opts, stop_at=every))
    st, t2 = timed(torch, lambda: pdhg.solve_pdhg(*args, opts=opts,
                                                   stop_at=every * (1 + windows)))
    if int(st.niter) != every * (1 + windows):
        raise AssertionError(f"the timed PDHG run stopped at {int(st.niter)}")
    return (t2 - t1) / (every * windows)


def crossover_main_path(torch, rec_path, shape=MAROS, want=MAROS_OBJ):
    """Phase 7(a): the maros-r7 shape written with `write_mps`, read back
    through the native parser, and `Problem.solve()` with the default
    options on the card: the crossover (device PDHG stage, identify, host
    polish).  Returns what (c) and the PDHG step's row need."""
    from minilp_tpu_torch import SolverOptions
    from minilp_tpu_torch.io import mps
    from minilp_tpu_torch.utils import profiling
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    log(f"[7a] main path through the crossover: MPS file -> Problem.solve() at the "
        f"maros-r7 shape {shape[0]}x{shape[1]} on the card")
    path = rec_path.parent / "maros_r7_shape.mps"
    t0 = time.perf_counter()
    path.write_text(mps.write_mps(netlib_shaped_problem(*shape, seed=1)))
    t_write = time.perf_counter() - t0
    t0 = time.perf_counter()
    mp = mps.read_mps(str(path), options=SolverOptions(device=DEVICE), native=True)
    t_read = time.perf_counter() - t0
    log(f"  write_mps {t_write:.3f} s ({path.stat().st_size} bytes), read_mps "
        f"(native) {t_read:.3f} s: {mp.problem.num_vars} vars, "
        f"{mp.problem.num_constraints} rows")
    prob = mp.problem
    n_rec = len(rec_path.read_text().splitlines()) if rec_path.exists() else 0
    profiling.reset_stages()
    with recording_device_chunks() as (chunks, host):
        t0 = time.perf_counter()
        sol = prob.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    stages = profiling.stages()
    events = [json.loads(line)["event"] for line in rec_path.read_text().splitlines()[n_rec:]]
    if events != ["cold_solve_crossover"]:
        raise AssertionError(f"maros: solve records {events}")
    dev_iters = stages.get("crossover_pdhg_device_iters", 0)
    if dev_iters <= 0 or not chunks or {c["device"] for c in chunks} != {DEVICE}:
        raise AssertionError(f"maros: device stage {dev_iters} iterations, chunks {chunks}")
    if not sol._engine.certified:
        raise AssertionError("maros: solution not certified")
    got = sol.objective()
    if abs(got - want) > REL_REF * (1.0 + abs(want)):
        raise AssertionError(f"maros: objective {got!r} vs the reference's {want!r}")
    can = sol._engine.can
    tol = max(prob.options.crossover_tol, prob.options.feas_tol)
    err_d = chunks[-1]["kkt"]
    rule = ("identify from the device iterate" if err_d <= 10 * tol else
            "host stage cold" if err_d > 1e-2 else "host stage warm")
    # the branch the solve took: the host stage's launches, and its timer
    branch = f"host stage {host[0]}" if host else "identify from the device iterate"
    if len(host) > 1 or bool(host) != ("crossover_pdhg_s" in stages) or branch != rule:
        raise AssertionError(f"maros: hand-off {branch} (host launches {host}, stages "
                             f"{sorted(stages)}), the rule on the f64 KKT {err_d:.3e}: {rule}")
    log(f"  objective={got!r} (reference {want!r}, rel {abs(got - want) / (1 + abs(want)):.3e}) "
        f"canonical {can.M}x{can.N} wall_s={wall:.3f} polish pivots={sol._engine.iterations()}")
    log(f"  hand-off: device f64 KKT {err_d:.3e} (tol {tol:g}) -> {branch}")
    done = 0
    for c in chunks:
        c["iters"], done = c["niter"] - done, c["niter"]
    for ph in ("bfloat16", "float32"):
        it = sum(c["iters"] for c in chunks if c["phase"] == ph)
        sec = sum(c["wall_s"] for c in chunks if c["phase"] == ph)
        if it:
            log(f"  device phase {ph}: {it} iterations in {sec:.3f} s = {it / sec:.1f} it/s")
    for c in chunks:
        log(f"    chunk {c['phase']}: iters={c['niter']} wall_s={c['wall_s']:.3f} "
            f"f64_kkt={c['kkt']:.4e}")
    log(f"  stages: {stages}")
    step_ms = pdhg_step_ms(torch, can)
    # one iteration's two matvecs each read the dense f32 A once
    step_bytes = 2 * 4 * can.M * can.N
    step_bound = step_bytes / HBM_BYTES * 1e3
    log(f"  PDHG step (torch ops, f32 halpern at {can.M}x{can.N}): {step_ms:.4f} ms/iteration "
        f"by CUDA events; bound {step_bound:.4f} ms (two matvecs, {step_bytes} bytes "
        f"over {HBM_BYTES:.3g} B/s); device iterations on the path: {dev_iters}")
    t0 = time.perf_counter()
    h = maros_highs()
    log(f"  HiGHS {h!r}, rel {abs(got - h) / (1 + abs(h)):.3e}; it took "
        f"{time.perf_counter() - t0:.1f} s")
    if abs(got - h) > REL_HIGHS * (1.0 + abs(h)):
        raise AssertionError(f"maros: objective {got!r} vs HiGHS {h!r}")
    return dict(objective=got, step_ms=step_ms, step_bound_ms=step_bound, iterations=dev_iters)


def same_iterates(tag, card, cpu, tol):
    """x and y of a card run within `tol` of the CPU run's: ‖Δ‖ ≤ tol·(1 + ‖cpu‖)."""
    worst = 0.0
    for name in ("x", "y"):
        a, b = getattr(card, name).double().cpu().numpy(), getattr(cpu, name).double().numpy()
        rel = float(np.linalg.norm(a - b) / (1.0 + np.linalg.norm(b)))
        if not rel <= tol:
            raise AssertionError(f"{tag}: {name} card vs CPU {rel:.3e} > {tol:g}")
        worst = max(worst, rel)
    log(f"  {tag}: card vs CPU on the same inputs, iterations {int(card.niter)} / "
        f"{int(cpu.niter)}, x and y within {worst:.3e} (tolerance {tol:g})")


def pdhg_engine_on_card(torch, rec_path, highs_256):
    """Phase 7(b): engine="pdhg" on the `single_lp` 256x1024 instance, dense
    and sparse, then the card against the CPU on the same inputs."""
    from minilp_tpu_torch import SolverOptions
    from minilp_tpu_torch.canonical import canonicalize
    from minilp_tpu_torch.engine import crossover, pdhg
    from minilp_tpu_torch.presolve import presolve_problem
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    log("[7b] engine=\"pdhg\" on the card: single_lp 256x1024 at feas_tol 1e-6")
    make = lambda: netlib_shaped_problem(*SINGLE_LP["256x1024"], seed=11)
    for matrix in ("dense", "sparse"):
        prob = make()
        prob.options = SolverOptions(device=DEVICE, pdhg_matrix=matrix, **PDHG_KW)
        n_rec = len(rec_path.read_text().splitlines()) if rec_path.exists() else 0
        t0 = time.perf_counter()
        sol = prob.solve()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        recs = [json.loads(line) for line in rec_path.read_text().splitlines()[n_rec:]]
        if [(r["event"], r["status"], r["backend"]) for r in recs] != \
                [("pdhg_solve", "OPTIMAL", DEVICE)]:
            raise AssertionError(f"pdhg {matrix}: records {recs}")
        got = sol.objective()
        if abs(got - highs_256) > 1e-5 * (1.0 + abs(highs_256)):
            raise AssertionError(f"pdhg {matrix}: objective {got!r} vs HiGHS {highs_256!r}")
        it = sol._engine.iterations()
        log(f"  {matrix}: objective={got!r} HiGHS={highs_256!r} iterations={it} "
            f"wall_s={wall:.3f} ({it / wall:.1f} it/s)")
    can = canonicalize(presolve_problem(make())[0])
    put = lambda dev, dt: [torch.as_tensor(np.asarray(v), dtype=dt, device=dev)
                           for v in (can.A, can.b, can.c, can.lo, can.hi)]
    opts = SolverOptions(**PDHG_KW)
    every = opts.pdhg_check_every
    card = pdhg.solve_pdhg(*put(DEVICE, torch.float64), opts=opts, stop_at=4 * every)
    cpu = pdhg.solve_pdhg(*put("cpu", torch.float64), opts=opts, stop_at=4 * every)
    same_iterates("f64 dense PDHG, 4 windows", card, cpu, 1e-9)
    stage = crossover.stage_options(SolverOptions(), 1e-4)
    card = pdhg.solve_pdhg(*put(DEVICE, torch.float32), opts=stage, stop_at=crossover.FIRST_CHUNK)
    cpu = pdhg.solve_pdhg(*put("cpu", torch.float32), opts=stage, stop_at=crossover.FIRST_CHUNK)
    same_iterates("f32 device-stage chunk", card, cpu, 1e-4)


def pdhg_maros_wall_bounded(torch, cert_obj, wall_s=PDHG_WALL_S, shape=MAROS):
    """Phase 7(c): the sparse f64 engine on the card at the maros-r7 shape in
    `stop_at` chunks for `wall_s` seconds, as bench.py's `pdhg_maros_shape`
    reports it: iterations per second, the f64 KKT, the gap to (a)'s
    certified objective.  Required: finite iterates and a falling KKT."""
    from minilp_tpu_torch import SolverOptions, Status
    from minilp_tpu_torch.canonical import canonicalize
    from minilp_tpu_torch.engine import crossover, pdhg
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    log(f"[7c] sparse f64 PDHG on the card at the maros-r7 shape, {wall_s:g} s wall-bounded")
    can = canonicalize(netlib_shaped_problem(*shape, seed=1), dtype=np.float64)
    opts = SolverOptions(engine="pdhg", feas_tol=1e-6, pdhg_matrix="sparse",
                         pdhg_max_iter=400_000)
    put = lambda v: torch.as_tensor(np.asarray(v, np.float64), device=DEVICE)
    A = put(can.A).to_sparse_csr()
    vecs = [put(v) for v in (can.b, can.c, can.lo, can.hi)]
    A64 = can.csc()
    st, done, chunk, kkts = None, 0, 1000, []
    t0 = time.perf_counter()
    while done < opts.pdhg_max_iter and time.perf_counter() - t0 < wall_s:
        tc = time.perf_counter()
        st = pdhg.solve_pdhg_sparse(A, *vecs, opts=opts, state0=st,
                                    stop_at=min(done + chunk, opts.pdhg_max_iter))
        x, y = st.x.cpu().numpy(), st.y.cpu().numpy()
        dt = time.perf_counter() - tc
        prev, done = done, int(st.niter)
        if not (np.isfinite(x).all() and np.isfinite(y).all()):
            raise AssertionError(f"maros sparse PDHG: non-finite iterate after {done}")
        kkts.append(crossover.kkt_error_f64(A64, can.b, can.c, can.lo, can.hi, x, y,
                                            opts.feas_tol))
        log(f"    chunk: iters={done} wall_s={dt:.3f} f64_kkt={kkts[-1]:.4e}")
        if int(st.status) != int(Status.MAX_ITER):
            break
        rate = (done - prev) / max(dt, 1e-3)
        left = wall_s - (time.perf_counter() - t0)
        chunk = int(max(min(rate * 10.0, rate * left, 100_000), 64))
    wall = time.perf_counter() - t0
    if len(kkts) < 2 or not kkts[-1] < kkts[0]:
        raise AssertionError(f"maros sparse PDHG: the KKT did not fall {kkts}")
    obj = float(can.obj_sign * (can.c @ x))
    log(f"  iterations={done} wall_s={wall:.3f} ({done / wall:.1f} it/s) status="
        f"{Status(int(st.status)).name} f64_kkt first/last {kkts[0]:.4e} / {kkts[-1]:.4e} "
        f"objective={obj!r} rel_gap_vs_certified={abs(obj - cert_obj) / (1 + abs(cert_obj)):.3e}")


#: phase 8(a): the examples at their card sizes
TSP_SIZES = (9, 16)
SCENARIOS = (512, 16, 24)    # scenario_batch's default batch
#: phase 8(b): the sharded engines at the `single_lp` 256x1024 shape
SHARDED_PDHG_ITERS = 6400
SHARDED_BATCH = (1, 64, 32, 96)   # make_random_batch_host(seed, batch, m, nv)
ONE_RANK_BACKEND = "nccl"


def held_karp(dist) -> float:
    """The exact shortest tour by the Held–Karp dynamic program (numpy; an
    oracle that uses nothing of the port)."""
    n = dist.shape[0]
    k = n - 1  # cities 1..n-1 are the bits of a mask
    dp = np.full((1 << k, k), np.inf)
    dp[1 << np.arange(k), np.arange(k)] = dist[0, 1:]
    inner = dist[1:, 1:]
    for mask in range(1, 1 << k):
        row = dp[mask]
        if not np.isfinite(row).any():
            continue
        step = (row[:, None] + inner).min(axis=0)  # best way into each city
        for j in range(k):
            if not mask >> j & 1:
                nxt = mask | 1 << j
                dp[nxt, j] = min(dp[nxt, j], step[j])
    return float((dp[-1] + dist[1:, 0]).min())


def _events(rec_path, n_rec):
    return [json.loads(line)["event"] for line in rec_path.read_text().splitlines()[n_rec:]]


@contextlib.contextmanager
def recording_batch_calls(module):
    """Record the K1 batch calls that `module` makes through its own name
    `solve_batch_megakernel`: a list of (A, b, c, lo, hi, keywords)."""
    saved, seen = module.solve_batch_megakernel, []

    def call(A, b, c, lo, hi, **kw):
        seen.append(tuple(np.array(x) for x in (A, b, c, lo, hi)) + (kw,))
        return saved(A, b, c, lo, hi, **kw)

    module.solve_batch_megakernel = call
    try:
        yield seen
    finally:
        module.solve_batch_megakernel = saved


def examples_main_path(torch, rec_path, cmp_k1, cmp_k2, tsp_sizes=TSP_SIZES,
                       scenarios=SCENARIOS, netlib=NETLIB["25fv47"], want_netlib=OBJ_25FV47):
    """Phase 8(a): the three examples with the default options (device
    "cuda"): TSP by branch-and-cut on the incremental API (n = 9 against
    the brute force, n = 16 against Held–Karp), `scenario_batch` at its
    default batch, `netlib_runner` on an MPS file of the 25fv47 shape under
    a non-Netlib name with `--expected`.  Every K1 and K2 launch of the
    path is recorded and, after the path, held against its plain version
    on the same inputs (`cmp_k1`, `cmp_k2`).  Returns K1's and K2's
    launches on the path."""
    import collections
    import io

    from minilp_tpu_torch import SolverOptions
    from minilp_tpu_torch.examples import netlib_runner, scenario_batch, tsp
    from minilp_tpu_torch.io.mps import write_mps
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs, certify
    from minilp_tpu_torch.ops.kernels import streaming_simplex as ss
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    log("[8a] the examples on the card")
    recorded = []  # (tag, launches through the driver's routes)
    bs.launches = ss.launches = certify.launches = 0  # counts from here on are the examples' path
    for n in tsp_sizes:
        rng = np.random.default_rng(0)
        pts = rng.random((n, 2))
        dist = np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))
        n_rec = len(rec_path.read_text().splitlines()) if rec_path.exists() else 0
        k1 = bs.launches
        t0 = time.perf_counter()
        with recording_launches(cold=True) as seen:
            solver = tsp.TspSolver(dist, device=DEVICE)
            length, tour = solver.solve()
        wall = time.perf_counter() - t0
        recorded.append((f"TSP n={n}", seen))
        events = _events(rec_path, n_rec)
        t0 = time.perf_counter()
        exact = float(tsp.tour_length_brute_force(dist) if n <= 9 else held_karp(dist))
        oracle = "brute force" if n <= 9 else "Held-Karp"
        if abs(length - exact) > 1e-9 * (1.0 + exact):
            raise AssertionError(f"TSP n={n}: length {length!r} vs {oracle} {exact!r}")
        if events[0] != "cold_solve_megakernel" or bs.launches == k1:
            raise AssertionError(f"TSP n={n}: the cold solve went {events[0]}, not K1")
        log(f"  TSP n={n} (seed 0, {n * (n - 1) // 2} edges): length={length!r} "
            f"{oracle}={exact!r} ({time.perf_counter() - t0:.2f} s) nodes={solver.nodes} "
            f"records={dict(collections.Counter(events))} K1 launches={bs.launches - k1} "
            f"wall_s={wall:.3f} tour={sorted(tour)}")

    k1 = bs.launches
    with contextlib.redirect_stdout(io.StringIO()) as out, host_checks_counted() as host, \
            recording_batch_calls(scenario_batch) as batch_calls:
        res = scenario_batch.main(*scenarios, device=DEVICE)
    for line in out.getvalue().splitlines():
        log("  scenario_batch: " + line)
    if not (res["status"] == 1).all() or bs.launches == k1 or certify.launches != 1 or host:
        raise AssertionError(f"scenario_batch: statuses {np.unique(res['status'])}, "
                             f"K1 launches {bs.launches - k1}, certificate launches "
                             f"{certify.launches}, host checks {len(host)}")
    batch = scenarios[0]
    log(f"  scenario_batch {batch} x ({scenarios[1]}x{scenarios[2]}): K1 + the certificate on "
        f"the card "
        f"{res['kernel_s']:.3f} s = {batch / res['kernel_s']:.1f} certified LPs/s; "
        f"fallback lanes {res['fallback'].tolist()} ({res['fallback_s']:.3f} s); "
        f"every lane OPTIMAL")

    path = rec_path.parent / "shape_25fv47.mps"
    path.write_text(write_mps(netlib_shaped_problem(*netlib, seed=1), name="SHAPE_25FV47"))
    k2 = ss.launches
    n_rec = len(rec_path.read_text().splitlines())
    with contextlib.redirect_stdout(io.StringIO()) as out, \
            recording_launches(cold=True) as seen:
        rc = netlib_runner.main([str(path), "--device", DEVICE,
                                 f"--expected=shape_25fv47={want_netlib!r}"])
    recorded.append(("netlib_runner", seen))
    rec = json.loads(out.getvalue().splitlines()[0])
    log(f"  netlib_runner: exit {rc} {json.dumps(rec)}")
    events = _events(rec_path, n_rec)
    if rc != 0 or rec.get("pass_1e-6") is not True or rec.get("certified") is not True:
        raise AssertionError(f"netlib_runner at the 25fv47 shape: exit {rc}, {rec}")
    if events != ["cold_solve_streaming"] or ss.launches == k2:
        raise AssertionError(f"netlib_runner: records {events}, K2 launches {ss.launches - k2}")
    counts = {"batched_simplex": bs.launches, "streaming_simplex": ss.launches,
              "certify_f64": certify.launches}

    # every launch above against its plain version on the same inputs (K2's
    # one-block rerun is phase 3b's check, at this shape)
    for tag, seen in recorded:
        if not seen:
            raise AssertionError(f"{tag}: no kernel launch recorded")
        compare_launches(f"examples {tag}", seen, SolverOptions().effective_max_iter,
                         cmp_k1, cmp_k2, one_block=False)
    for A, b, c, lo, hi, kw in batch_calls:
        m, n = A.shape[1:]
        cmp_k1.run(f"examples scenario_batch {A.shape[0]} LPs", A, b, c, lo, hi,
                   slack0=kw.get("slack0") or n - m, max_iter=kw.get("max_iter", 2000))
    n_cmp = sum(len(seen) for _, seen in recorded) + len(batch_calls)
    if n_cmp > counts["batched_simplex"] + counts["streaming_simplex"]:
        raise AssertionError(f"{n_cmp} kernel calls recorded, launches counted {counts}")
    return counts


def _sharded_calls(inputs, cols, batch_mesh, dry):
    """The calls of one world (`launch.run_calls`): the cold solve, the dual
    re-solve, the row-sharded PDHG, the sharded batch, the dry run."""
    eng = "minilp_tpu_torch.parallel.sharded_engine:"
    return [
        (cols, eng + "solve_canonical_sharded", inputs["cold"], {}),
        (cols, eng + "resolve_dual_sharded", inputs["dual"], {}),
        (cols, "minilp_tpu_torch.parallel.pdhg_sharded:solve_pdhg_sharded", inputs["pdhg"], {}),
        (batch_mesh, "minilp_tpu_torch.parallel.batched:solve_batch_sharded", inputs["batch"], {}),
        (None, "minilp_tpu_torch.parallel.distributed:dryrun_multichip", (dry,), {}),
    ]


def sharded_main_path(torch, card, shape=SINGLE_LP["256x1024"], batch=SHARDED_BATCH,
                      pdhg_iters=SHARDED_PDHG_ITERS):
    """Phase 8(b): the sharded engines against the single-device port on
    the card, in a one-rank world (`ONE_RANK_BACKEND`, in process) and in a
    two-rank gloo world on the same card (`launch.run_world`)."""
    import torch.distributed as dist
    from minilp_tpu_torch import ComparisonOp, SolverOptions
    from minilp_tpu_torch.engine import incremental
    from minilp_tpu_torch.engine.driver import EngineHandle
    from minilp_tpu_torch.engine.dual import resolve_dual
    from minilp_tpu_torch.engine.pdhg import solve_pdhg
    from minilp_tpu_torch.engine.primal import solve_canonical
    from minilp_tpu_torch.engine.state import state_to_numpy
    from minilp_tpu_torch.parallel import launch
    from minilp_tpu_torch.parallel.batched import make_random_batch_host, solve_batch
    from minilp_tpu_torch.parallel.distributed import init_distributed
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem

    log(f"[8b] the sharded engines on the card ({card}); the ranks of a world share "
        f"this one card: the times are the cost of the code path, not a scaling figure")
    sync = torch.cuda.synchronize if DEVICE == "cuda" else (lambda: None)

    def timed_wall(fn):
        sync()
        t0 = time.perf_counter()
        out = fn()
        sync()
        return out, time.perf_counter() - t0

    prob = netlib_shaped_problem(*shape, seed=11)
    can = canonical_instance(*shape, seed=11)
    opts = SolverOptions(device=DEVICE)
    host = lambda *xs: tuple(np.array(x) for x in xs)
    cold_in = host(can.A, can.b, can.c, can.lo, can.hi, can.vstat0, can.basis0) + (opts,)
    put = lambda xs: [torch.as_tensor(x, device=DEVICE) for x in xs]
    ref_cold, cold_s = timed_wall(lambda: solve_canonical(*put(cold_in[:7]), opts))
    # a cut of the optimum, appended as tests/test_parallel.py appends it
    handle = EngineHandle(can, state_to_numpy(ref_cold), prob, opts)
    coeffs = np.random.default_rng(7).normal(size=can.nv)
    incremental._append_row(handle, coeffs, ComparisonOp.Le,
                            float(coeffs @ handle._x_full()[: can.nv]) - 0.25)
    c2 = handle.can
    warm = host(handle.state.basis, handle.state.vstat, handle.state.Binv)
    dual_in = host(c2.A, c2.b, c2.c, c2.lo, c2.hi) + warm + (opts,)
    ref_dual, dual_s = timed_wall(lambda: resolve_dual(*put(dual_in[:8]), opts))
    pdhg_opts = SolverOptions(engine="pdhg", pdhg_variant="vanilla", dtype="float64",
                              pdhg_max_iter=pdhg_iters, device=DEVICE)
    pdhg_in = cold_in[:5] + (pdhg_opts,)
    ref_pdhg, pdhg_s = timed_wall(lambda: solve_pdhg(*put(pdhg_in[:5]), opts=pdhg_opts))
    A, b, c, lo, hi = make_random_batch_host(*batch)
    B, m, n = A.shape
    vstat0 = np.full((B, n), 0, np.int8)
    vstat0[:, n - m:] = 4  # AT_LOWER structurals, BASIC slacks
    basis0 = np.tile(np.arange(n - m, n), (B, 1))
    batch_in = (A, b, c, lo, hi, vstat0, basis0, opts)
    ref_batch, batch_s = timed_wall(lambda: solve_batch(*put(batch_in[:7]), opts=opts))
    log(f"  single device: cold {int(ref_cold.niter)} pivots in {cold_s:.3f} s "
        f"({cold_s / int(ref_cold.niter) * 1e3:.3f} ms a pivot), status {int(ref_cold.status)}; "
        f"dual re-solve after the cut {int(ref_dual.niter)} pivots in {dual_s:.3f} s, "
        f"status {int(ref_dual.status)}; PDHG {int(ref_pdhg.niter)} iterations in "
        f"{pdhg_s:.3f} s ({pdhg_s / int(ref_pdhg.niter) * 1e3:.4f} ms an iteration), "
        f"status {int(ref_pdhg.status)}; batch of {B} in {batch_s:.3f} s")
    inputs = dict(cold=cold_in, dual=dual_in, pdhg=pdhg_in, batch=batch_in)

    worlds = {}
    init_distributed(f"127.0.0.1:{launch.free_port()}", 1, 0, backend=ONE_RANK_BACKEND,
                     timeout_s=300.0)
    try:
        worlds[f"1 rank, {ONE_RANK_BACKEND}"] = launch.to_host(launch.run_calls(
            _sharded_calls(inputs, (1, 1), (1, 1), 1), device=DEVICE))
    finally:
        dist.destroy_process_group()
    worlds["2 ranks, gloo, one card"] = launch.run_world(
        "minilp_tpu_torch.parallel.launch:run_calls", 2, backend="gloo", device=DEVICE,
        args=(_sharded_calls(inputs, (1, 2), (2, 1), 2),), timeout_s=600.0)[0]

    for tag, (cold, dual, pd, bat, dry) in worlds.items():
        for what, got, ref in (("cold solve", cold, ref_cold), ("dual re-solve", dual, ref_dual)):
            r = got["result"]
            same = (int(r["status"]) == int(ref.status) and int(r["niter"]) == int(ref.niter)
                    and np.array_equal(np.sort(r["basis"]), np.sort(ref.basis.cpu().numpy())))
            if not same or abs(float(r["obj"]) - float(ref.obj)) > 1e-9 * (1 + abs(float(ref.obj))):
                raise AssertionError(f"{tag}, {what}: status {int(r['status'])} niter "
                                     f"{int(r['niter'])} obj {float(r['obj'])!r} vs the single "
                                     f"device's {int(ref.status)} {int(ref.niter)} {float(ref.obj)!r}")
            piv = max(int(r["niter"]), 1)
            log(f"  {tag}, {what}: {int(r['niter'])} pivots, status {int(r['status'])}, "
                f"obj {float(r['obj'])!r} (single device {float(ref.obj)!r}), basis in the "
                f"same order: {np.array_equal(r['basis'], ref.basis.cpu().numpy())}; "
                f"{got['wall_s']:.3f} s = {got['wall_s'] / piv * 1e3:.3f} ms a pivot; "
                f"{got['collectives'] / piv:.2f} collectives a pivot, "
                f"{got['collective_s'] / got['wall_s']:.1%} of the wall in them")
        r = pd["result"]
        rel = lambda a, b: float(np.max(np.abs(a - b)) / (1.0 + np.max(np.abs(b))))
        ex, ey = rel(r["x"], ref_pdhg.x.cpu().numpy()), rel(r["y"], ref_pdhg.y.cpu().numpy())
        if (int(r["status"]), int(r["niter"])) != (int(ref_pdhg.status), int(ref_pdhg.niter)) \
                or max(ex, ey) > 1e-9:
            raise AssertionError(f"{tag}, PDHG: status {int(r['status'])} niter {int(r['niter'])}"
                                 f" x {ex:.2e} y {ey:.2e} from the single device's")
        log(f"  {tag}, row-sharded PDHG: {int(r['niter'])} iterations, status "
            f"{int(r['status'])}, x and y within {ex:.2e} / {ey:.2e} (relative) of the single "
            f"device's; {pd['wall_s']:.3f} s = {pd['wall_s'] / int(r['niter']) * 1e3:.4f} ms an "
            f"iteration; {pd['collectives'] / int(r['niter']):.2f} collectives an iteration, "
            f"{pd['collective_s'] / pd['wall_s']:.1%} of the wall in them")
        r = bat["result"]
        for field in ("obj", "niter", "basis", "status"):
            if not np.array_equal(r[field], getattr(ref_batch, field).cpu().numpy()):
                raise AssertionError(f"{tag}, sharded batch: {field} differs from solve_batch")
        log(f"  {tag}, sharded batch of {B}: bit-identical to solve_batch lane for lane; "
            f"{bat['wall_s']:.3f} s (single device {batch_s:.3f} s)")
        log(f"  {tag}: {dry['result']}")


def check_bench_line(line, card, k2_pivots, n_lps=4 * BATCH, maros_obj=MAROS_OBJ):
    """Phase 9's checks of the bench's JSON line (module docstring); raises
    with every check that failed."""
    finite = lambda v: isinstance(v, (int, float)) and math.isfinite(v)
    rate, maros, pd = (line["streaming_pivot_rate"], line["netlib_shape_maros_r7"],
                       line["pdhg_maros_shape"])
    checks = {
        f"{n_lps} LPs optimal and verified": line["n_optimal"] == line["n_verified"] == n_lps,
        "within 1e-6 of HiGHS": line["max_rel_gap_vs_highs"] <= REL_HIGHS,
        "single_lp certified, pivots, a node": all(
            e["certified"] and e["cold_iters"] > 0 and e["resolve_nodes"] >= 1
            for e in line["single_lp"].values()),
        "25fv47 certified": line["netlib_shape_25fv47"]["certified"] is True,
        f"pivot rate optimal at {k2_pivots} pivots": (rate["status_optimal"] is True
                                                      and rate["pivots"] == k2_pivots),
        "both routes a node": all(e["nodes"] >= 1 for e in line["incremental_routing"].values()),
        "maros certified at the reference's objective": (
            maros["certified"] is True
            and abs(maros["objective"] - maros_obj) <= REL_REF * (1.0 + abs(maros_obj))),
        "PDHG KKT and gap finite, over_budget_s": (
            finite(pd["kkt_err"]) and finite(pd.get("rel_gap_vs_certified"))
            and finite(pd.get("over_budget_s"))),
        "the card named": line["device"] == card,
        "K1, K2, K3 and the certificate launched": (
            set(line["launches"]) == set(BENCH_KERNELS)
            and all(n > 0 for n in line["launches"].values())),
        "the batched line's stages": (
            set(BATCH_STAGES) <= set(line["batch_stages"])
            and all(finite(line["batch_stages"][k]) for k in BATCH_STAGES)),
    }
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"bench line: failed {failed}")


def bench_main_path(card, k2_pivots, cmd=BENCH_CMD, timeout_s=BENCH_TIMEOUT_S, **expect):
    """Phase 9: the bench (`cmd`) in a subprocess from the checkout's root,
    killed at `timeout_s`; its one JSON line logged and checked
    (`check_bench_line`, with `expect`).  Returns its kernels' launches."""
    log(f"[9] the bench on the card: {' '.join(cmd[1:])}")
    env = {k: v for k, v in os.environ.items() if k != "MINILP_TPU_LOG"}
    t0 = time.perf_counter()
    res = subprocess.run(list(cmd), cwd=HERE, env=env, capture_output=True, text=True,
                         timeout=timeout_s)
    wall = time.perf_counter() - t0
    if res.returncode != 0:
        raise AssertionError(f"the bench exited {res.returncode}: {res.stderr[-4000:]}")
    lines = res.stdout.splitlines()
    if len(lines) != 1:
        raise AssertionError(f"the bench printed {len(lines)} lines, not one: {res.stdout[-4000:]}")
    log(f"  bench line ({wall:.1f} s): {lines[0]}")
    line = json.loads(lines[0])
    check_bench_line(line, card, k2_pivots, **expect)
    log(f"  every check of the bench line held; launches {line['launches']}")
    return line["launches"]


def main() -> int:
    if not (HERE / "minilp_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke.py: the minilp_tpu_torch package is not beside this "
              "script; run it from the root of a checkout", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke.py: no CUDA device is available", file=sys.stderr)
        return 3
    return phases(torch)


def phases(torch) -> int:
    """Phases 1 to 9 (the module docstring; 5b runs before 5)."""
    t_start = time.perf_counter()
    sys.path.insert(0, str(HERE))
    import minilp_tpu_torch
    from minilp_tpu_torch import OptimizationDirection, Problem, ComparisonOp, SolverOptions
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs, build
    from minilp_tpu_torch.engine.driver import streaming_options
    from minilp_tpu_torch.ops.kernels import streaming_simplex as ss
    from minilp_tpu_torch.utils import k1_split, k2_split
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
    build_all(build, ["batched_simplex", "streaming_simplex", "packed_simplex", "certify_f64"])

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
    for tag in SINGLE_LP:
        k1s = k1_split.split(tag)
        log(f"  K1 grid at {tag}: G={k1s['blocks']} blocks on {k1s['sm_count']} SMs; "
            f"k1_split: refresh_ms={k1s['refresh_ms']:.3f} pivot_ms={k1s['pivot_ms']:.4f} "
            f"default run {k1s['default']}")

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
    chunked_wide_vs_one_block(torch, ss, can, k2_options(can))
    k2s = k2_split.split("25fv47", clocks=False)
    g, one = k2s["grid"], k2s["one_block"]
    log(f"  K2 at 25fv47 (k2_split): grid of G={k2s['blocks']} blocks on {k2s['sm_count']} "
        f"SMs: major_ms={g['major_ms']:.4f} refresh_ms={g['refresh_ms']:.3f}; one block: "
        f"major_ms={one['major_ms']:.4f} refresh_ms={one['refresh_ms']:.3f}; "
        f"default runs grid {g['default']} one block {one['default']}")
    for run in (g["default"], one["default"], dict(zip(("pivots", "majors"),
                                                        cmp2.counts["25fv47"][2:4]))):
        if (run["pivots"], run["majors"]) != K2_COUNTS["25fv47"]:
            raise AssertionError(f"K2 at 25fv47: pivots and majors {run}, "
                                 f"expected {K2_COUNTS['25fv47']}")

    # ---- 3c. K3 against its plain version on the card -----------------------
    cmp3 = compare_k3(torch)

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
    k2_pivots = {}
    for tag, make in netlib.items():
        _walls, _stages, k2_pivots[tag] = solve_main_path(
            tag, make, want[tag], "cold_solve_streaming", rec_path,
            ref=OBJ_25FV47 if tag == "25fv47" else None)
        if k2_pivots[tag] != K2_COUNTS[tag][0]:
            raise AssertionError(f"{tag}: K2 took {k2_pivots[tag]} pivots, expected "
                                 f"{K2_COUNTS[tag][0]}")
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

    # ---- 5b. the f64 certificate against its plain version and the host ---
    cert = compare_certify(torch)

    # ---- 5. the batched main path: solve_batches_pipelined through K3 -------
    k3_launches, cert_launches = batched_main_path(torch)

    # ---- 6. the incremental main path: warm re-solves through the API -------
    bs.launches = ss.launches = 0  # counts from here on are the incremental path's
    warm = incremental_main_path(torch, rec_path, cmp_, cmp2)
    if warm["batched_simplex"] <= 0 or warm["streaming_simplex"] <= 0:
        raise AssertionError(f"the incremental path launched K1 and K2 {warm}")

    # ---- 7. PDHG and the PDHG → simplex crossover ---------------------------
    maros = crossover_main_path(torch, rec_path)
    pdhg_engine_on_card(torch, rec_path, expected["single_lp_256x1024"])
    pdhg_maros_wall_bounded(torch, maros["objective"])

    # ---- 8. the examples, then the sharded engines --------------------------
    ex = examples_main_path(torch, rec_path, cmp_, cmp2)
    if ex["batched_simplex"] <= 0 or ex["streaming_simplex"] <= 0:
        raise AssertionError(f"the examples launched K1 and K2 {ex}")
    sharded_main_path(torch, card)

    # ---- 9. the bench, as a user runs it -------------------------------------
    bench = bench_main_path(card, k2_pivots["25fv47"])

    ms_k, ms_p = cmp_.times["single_lp_512x2048"]
    k1_bound = dense_simplex_bound(cmp_.niter["single_lp_512x2048"], 504, 2048)
    ms2_k, ms2_p = cmp2.times["25fv47"]
    k2_bound = streaming_bound(*cmp2.counts["25fv47"][:2], *cmp2.counts["25fv47"][3:])
    tag3 = f"batch{BATCH}_32x128"
    ms3_k, ms3_p = cmp3.times[tag3]
    k3_bound = dense_simplex_bound(cmp3.niter[tag3], BATCH_M, BATCH_M + BATCH_NV)
    by_path = {"batched_simplex": {"cold": k1_launches, "incremental": warm["batched_simplex"],
                                   "examples": ex["batched_simplex"],
                                   "bench": bench["batched_simplex"]},
               "streaming_simplex": {"cold": k2_launches,
                                     "incremental": warm["streaming_simplex"],
                                     "examples": ex["streaming_simplex"],
                                     "bench": bench["streaming_simplex"]},
               "packed_simplex": {"batched": k3_launches, "bench": bench["packed_simplex"]},
               "certify_f64": {"batched": cert_launches, "examples": ex["certify_f64"],
                               "bench": bench["certify_f64"]}}
    row = lambda name, replaces, err, ms, plain_ms, bnd, library_ms=None: {
        "name": name, "route": "cuda", "source": f"minilp_tpu_torch/csrc/{name}.cu",
        "replaces": replaces,
        "launches": sum(by_path[name].values()), "launches_by_path": by_path[name],
        "max_abs_err": err, "ms": ms,
        "plain_ms": plain_ms, "bound_ms": bnd[0], "bound_by": bnd[1],
        # no single PyTorch call solves an LP
        "library_ms": library_ms,
    }
    tpu = "minilp_tpu/ops/kernels/{}.py:{}".format
    kernels = {"kernels": [
        row("batched_simplex", tpu("batched_simplex", 68), cmp_.max_abs_err, ms_k, ms_p,
            k1_bound),
        row("streaming_simplex", tpu("streaming_simplex", 134), cmp2.max_abs_err, ms2_k, ms2_p,
            k2_bound),
        row("packed_simplex", tpu("packed_simplex", 60), cmp3.max_abs_err, ms3_k, ms3_p,
            k3_bound),
        dict(row("certify_f64", tpu("batched_simplex", 555), cert["max_abs_err"], cert["ms"],
                 cert["plain_ms"], cert["bound"], cert["library_ms"]),
             replaces_note="host numpy (_verify_f64), not a Pallas kernel",
             host_ms=cert["host_ms"]),
    ]}
    log(f"chip_smoke.py: every phase passed in {time.perf_counter() - t_start:.1f} s")
    log(json.dumps(kernels))
    log(smi_name_power())
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
