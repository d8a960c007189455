"""Batched scenario solving, PyTorch port of `minilp_tpu/parallel/batched.py`.

Many independent canonical LPs per call, with no communication between
them.  Entry points:

* `solve_batches_pipelined` — a sequence of host batches through K3 (the
  packed simplex kernel, `ops/kernels/packed_simplex.py`) and the exact f64
  certificate on the device (`ops/kernels/certify.py`): the upload of batch
  k+1 and the host's finishing of batch k−1 overlap the device work of
  batch k;
* `solve_batch_certified` — one batch through K1 in batch mode (one LP per
  thread block), every lane certified on the device;
* `solve_batch` — the f64 torch engine, lane after lane;
* `solve_batch_sharded` — the same, the batch split over the ranks of a
  mesh's 'data' axis (`torch.distributed`, no communication until the
  result is put back together);
* `resolve_unverified_host` — the shared tail: an exact scipy-HiGHS re-solve
  on the host of every lane whose f32 basis failed the f64 certificate.

The device is explicit (`device="cuda"` by default, "cpu" runs every kernel
as its plain torch version).
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..engine.primal import solve_canonical
from ..engine.state import SimplexState
from ..ops.kernels import certify, packed_simplex as ps
from ..ops.kernels.batched_simplex import BatchResult, solve_batch_megakernel
from ..options import SolverOptions
from ..status import Status, VarStat
from ..utils import profiling
from ..utils.synth import random_batch as make_random_batch_host
from .mesh import BATCH_AXIS, assemble, batch_block
from .scheduling import difficulty_scores, sort_for_packing

__all__ = [
    "make_random_batch",
    "make_random_batch_host",
    "resolve_unverified_host",
    "solve_batch",
    "solve_batch_certified",
    "solve_batch_sharded",
    "solve_batches_pipelined",
]


def solve_batch(A, b, c, lo, hi, vstat0, basis0, opts: SolverOptions) -> SimplexState:
    """Solve B independent canonical LPs with the f64 torch engine; returns a
    batched `SimplexState` (every field stacked over the lanes).

    Inputs are tensors A (B, M, N), b (B, M), c/lo/hi (B, N), vstat0 (B, N),
    basis0 (B, M) on one device.  The JAX package vmaps the engine, which
    masks a finished lane until every lane is done, so each lane's result is
    its solo result: here the lanes run one after another.
    """
    lanes = [solve_canonical(A[i], b[i], c[i], lo[i], hi[i], vstat0[i], basis0[i], opts)
             for i in range(A.shape[0])]
    return SimplexState(*(torch.stack(field) for field in zip(*lanes)))


def solve_batch_sharded(mesh, A, b, c, lo, hi, vstat0, basis0, opts: SolverOptions) -> SimplexState:
    """Same, with the batch axis split over the mesh's 'data' axis (pure DP).

    Every rank of the mesh calls it with the whole batch; each solves its
    slice (the batch size must divide over the axis), and the lanes are put
    back together bit for bit, so every rank returns the whole batched
    state, lane for lane `solve_batch`'s on the same device.
    """
    local = solve_batch(*(batch_block(mesh, x) for x in (A, b, c, lo, hi, vstat0, basis0)),
                        opts=opts)
    return SimplexState(*(assemble(mesh, f, BATCH_AXIS, 0) for f in local))


def resolve_unverified_host(res, A, b, c, lo, hi):
    """Exact scipy-HiGHS host re-solve of every lane whose f32 basis failed
    f64 certification — the shared tail of all certified batched entry points.

    Returns `res` with the uncertified lanes replaced by the oracle's exact
    answers (host numpy arrays), so the `verified` mask is all-True unless a
    lane is genuinely pathological for HiGHS too.
    """
    from scipy.optimize import linprog

    verified = np.asarray(res.verified).copy()
    if verified.all():
        return res
    obj = np.array(res.obj)
    x = np.array(res.x)
    status = np.array(res.status)
    An, bn, cn, lon, hin = [np.asarray(v, dtype=np.float64) for v in (A, b, c, lo, hi)]
    for i in np.flatnonzero(~verified):
        bounds = [
            (lon[i, j] if np.isfinite(lon[i, j]) else None,
             hin[i, j] if np.isfinite(hin[i, j]) else None)
            for j in range(cn.shape[1])
        ]
        r = linprog(cn[i], A_eq=An[i], b_eq=bn[i], bounds=bounds, method="highs")
        if r.status == 0:
            obj[i], x[i] = r.fun, r.x
            status[i], verified[i] = int(Status.OPTIMAL), True
        elif r.status == 2:
            status[i], verified[i] = int(Status.INFEASIBLE), True
        elif r.status == 3:
            status[i], verified[i] = int(Status.UNBOUNDED), True
    return res._replace(obj=obj, x=x, status=status, verified=verified)


def solve_batch_certified(A, b, c, lo, hi, *, device="cuda", slack0=None,
                          max_iter: int = 2000):
    """Batched solve where EVERY lane's answer is exact and certified.

    K1 in batch mode (one thread block per LP, f32 iterate) plus the exact
    f64 recompute of each discovered basis on the same device; the rare
    lanes whose basis fails the certificate are re-solved on the host
    (scipy-HiGHS), so the returned `verified` mask is all-True unless a lane
    is pathological.
    """
    res = solve_batch_megakernel(A, b, c, lo, hi, device=device, slack0=slack0,
                                 max_iter=max_iter)
    return resolve_unverified_host(res, A, b, c, lo, hi)


def _host_f64(x, pinned: bool) -> torch.Tensor:
    """Host data as one C-ordered f64 tensor, in page-locked memory on a
    card (so that its upload can run asynchronously)."""
    t = torch.empty(np.shape(x), dtype=torch.float64, pin_memory=pinned)
    t.numpy()[...] = x
    return t


def _assemble(A_s, *, slack0: int, n: int) -> torch.Tensor:
    """Device-side assembly of [structural | identity slack | padding] from
    the uploaded structural block A_s (B, m, nv) → A (B, m, n)."""
    B, m, nv = A_s.shape
    if slack0 != nv:
        raise ValueError(f"the identity slack block must follow the {nv} "
                         f"structural columns, got slack0={slack0}")
    A = torch.zeros((B, m, n), dtype=A_s.dtype, device=A_s.device)
    A[:, :, :nv] = A_s
    A[:, :, nv:nv + m] = torch.eye(m, dtype=A_s.dtype, device=A_s.device)
    return A


def solve_batches_pipelined(
    batches,
    *,
    device="cuda",
    pack: int = 8,
    slack0=None,
    max_iter: int = 2000,
    structural_cols: int | None = None,
    sort_packs: bool = False,
):
    """Solve a sequence of host-resident LP batches through K3, each
    certified on the device, overlapping the device work of batch k with the
    upload of batch k+1 and the host's finishing of batch k−1.  Returns one
    certified `BatchResult` per batch.

    `batches` is a list of (A, b, c, lo, hi) numpy tuples, each with a batch
    size divisible by `pack`.  Each batch goes to the device in f64; there
    K3 takes it cast to f32 (round to nearest even, numpy's `astype` bits),
    and the f64 certificate of every lane (`ops/kernels/certify.py`) runs on
    the same stream behind K3, so only (basis, vstat, status, niter, obj,
    verified, x) come back, in one copy.  On a card, a prefetch thread
    copies batch k+1 into page-locked host memory and uploads it with
    non-blocking copies on a side stream; the launch stream waits on that
    upload's event before K3 runs, and each batch's results come back by a
    non-blocking copy queued behind its certificate.  Every uploaded tensor
    stays referenced until its batch is finalized.  The lanes whose basis
    fails the certificate are re-solved on the host by HiGHS
    (`resolve_unverified_host`).

    `structural_cols=nv` declares that columns [nv, nv+m) of A are the
    identity slack block (true of every canonicalized LP and of
    `make_random_batch_host`): then only the structural block A[:, :, :nv]
    is uploaded and the identity is assembled on the device.

    `sort_packs=True` orders each batch by the a-priori difficulty proxy
    (`scheduling.difficulty_scores`) before packing, so that lockstep packs
    idle less on stragglers; results are un-permuted before returning.

    Stage timers (`utils.profiling`): `batch_prep_s` (the prefetch thread's
    copy into pinned memory and enqueue), `batch_wait_s` (the host blocked on
    a batch's results), `batch_verify_s` (the certificate's call on the host
    clock: on a card its checks and enqueue only, on the CPU the whole plain
    version), `batch_resolve_s` and the counter `batch_resolved` (HiGHS
    re-solves); on a card also the device times `batch_upload_dev_s`,
    `batch_kernel_dev_s` (the f32 cast, the assembly and K3) and
    `batch_verify_dev_s` (the certificate) from CUDA events.
    """
    dev = torch.device(device)
    on_card = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if on_card else None
    event = lambda: torch.cuda.Event(enable_timing=True)

    def prep(batch):
        """The f64 copy into pinned memory and the upload of one batch (on
        the prefetch thread)."""
        t0 = time.perf_counter()
        A, b, c, lo, hi = batch
        B, m, n = A.shape
        if B % pack != 0:
            raise ValueError(f"batch {B} not divisible by pack {pack}")
        order = None
        if sort_packs:
            order = sort_for_packing(difficulty_scores(A, b, c, lo, hi, slack0=slack0))
            A, b, c, lo, hi = A[order], b[order], c[order], lo[order], hi[order]
        A_in = A if structural_cols is None else A[:, :, :structural_cols]
        host = [_host_f64(x, on_card) for x in (A_in, b, c, lo, hi)]
        up = None
        if on_card:
            up = (event(), event())
            with torch.cuda.stream(side):
                up[0].record(side)
                args = [h.to(dev, non_blocking=True) for h in host]
                up[1].record(side)
        else:
            args = host
        profiling.record_stage("batch_prep_s", time.perf_counter() - t0)
        return dict(order=order, args=args, host=host, up=up)

    def launch(staged, batch):
        A, b, c, lo, hi = batch
        B, m, n = A.shape
        s0 = (n - m) if slack0 is None else slack0
        A64, *vecs = staged["args"]
        run = verify = None
        if on_card:
            torch.cuda.current_stream(dev).wait_event(staged["up"][1])
            run, verify = (event(), event()), (event(), event())
            run[0].record()
        if structural_cols is not None:
            A64 = _assemble(A64, slack0=s0, n=n)
        out = ps.packed_kernel_call(
            *ps.packed_args(A64, *vecs, pack=pack), pack=pack, slack0=s0,
            max_iter=max_iter, refactor_period=32, feas_tol=1e-5, opt_tol=1e-6,
            pivot_tol=1e-6, bland_after=200,
        )
        t0 = time.perf_counter()
        if on_card:
            run[1].record()
            verify[0].record()
        packed = certify.certify_out(out, A64, *vecs)
        profiling.record_stage("batch_verify_s", time.perf_counter() - t0)
        if on_card:
            verify[1].record()
            res = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
            res.copy_(packed, non_blocking=True)
            done = torch.cuda.Event()
            done.record()
        else:
            res, done = packed, None
        staged.update(assembled=A64, out=out, packed=packed, res=res, done=done, run=run,
                      verify=verify)
        return staged

    def finalize(batch, staged):
        A, b, c, lo, hi = batch
        B, m, n = A.shape
        t0 = time.perf_counter()
        if staged["done"] is not None:
            staged["done"].synchronize()
            for name, (start, stop) in (("batch_upload_dev_s", staged["up"]),
                                        ("batch_kernel_dev_s", staged["run"]),
                                        ("batch_verify_dev_s", staged["verify"])):
                profiling.record_stage(name, start.elapsed_time(stop) / 1e3)
        profiling.record_stage("batch_wait_s", time.perf_counter() - t0)
        buf = staged["res"].numpy()
        order = staged["order"]
        if order is not None:
            # un-permute the sorted-pack results back to the caller's order
            inv = np.empty_like(order)
            inv[order] = np.arange(order.size)
            buf = buf[inv]
        res = BatchResult(*certify.host_fields(buf, m, n))
        with profiling.stage("batch_resolve_s"):
            profiling.bump_stage("batch_resolved", int((~res.verified).sum()))
            return resolve_unverified_host(res, A, b, c, lo, hi)

    results = []
    prev = None
    with ThreadPoolExecutor(max_workers=1) as pool:
        fut = pool.submit(prep, batches[0])
        for k, batch in enumerate(batches):
            staged = fut.result()
            if k + 1 < len(batches):
                fut = pool.submit(prep, batches[k + 1])  # overlap the next upload
            staged = launch(staged, batch)  # asynchronous on a card
            if prev is not None:
                results.append(finalize(*prev))  # the host's tail overlaps the device
            prev = (batch, staged)
        results.append(finalize(*prev))
    return results


def make_random_batch(gen: torch.Generator, batch: int, m: int, nv: int,
                      dtype=torch.float64):
    """A batch of random dense canonical LPs, guaranteed feasible and bounded,
    on the generator's device: ``(A, b, c, lo, hi, vstat0, basis0)``.

    Structure: minimize c·x s.t. A_s·x + s = b, 0 ≤ x ≤ 1 (boxed structural
    vars ⇒ bounded), s ≥ 0 with b = A_s·x₀ + u for an interior x₀ and u > 0
    (⇒ x₀ strictly feasible).  The JAX package draws from `jax.random` keys;
    the numbers differ, the structure does not (`make_random_batch_host` is
    the numpy twin that both packages share).
    """
    kw = dict(generator=gen, device=gen.device, dtype=dtype)
    n = nv + m
    A_s = torch.randn(batch, m, nv, **kw)
    c_s = torch.randn(batch, nv, **kw)
    x0 = 0.2 + 0.6 * torch.rand(batch, nv, **kw)
    u = 0.1 + 0.9 * torch.rand(batch, m, **kw)
    b = torch.einsum("bmn,bn->bm", A_s, x0) + u
    full = lambda shape, v, dt=dtype: torch.full(shape, v, dtype=dt, device=gen.device)
    eye = torch.eye(m, dtype=dtype, device=gen.device).expand(batch, m, m)
    A = torch.cat([A_s, eye], dim=2)
    c = torch.cat([c_s, full((batch, m), 0.0)], dim=1)
    lo = full((batch, n), 0.0)
    hi = torch.cat([full((batch, nv), 1.0), full((batch, m), torch.inf)], dim=1)
    vstat0 = torch.cat([full((batch, nv), int(VarStat.AT_LOWER), torch.int8),
                        full((batch, m), int(VarStat.BASIC), torch.int8)], dim=1)
    basis0 = torch.arange(nv, n, dtype=torch.int32, device=gen.device).repeat(batch, 1)
    return A, b, c, lo, hi, vstat0, basis0
