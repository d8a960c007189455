"""Process-group initialization, the scaling harness and the multi-device
dry run, PyTorch port of `minilp_tpu/parallel/distributed.py` and of
`__graft_entry__.py::dryrun_multichip`.

`init_distributed` wraps `torch.distributed.init_process_group` with an
explicit backend and a short timeout (gloo's default is 30 minutes).  Unlike
the JAX function, one process still initialises a one-rank group: torch's
collectives need a process group even then.

`measure_scaling` is the scaling harness (LPs/s at 1 rank against n ranks,
same per-rank batch), and `dryrun_multichip` runs one step of each sharded
engine on an n-rank mesh.  Both are called by every rank of a world; the
command line starts that world itself (`launch.run_world`):

    python -m minilp_tpu_torch.parallel.distributed --dryrun 4 --device cpu
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import time
from typing import Optional

import torch
import torch.distributed as dist

from ..options import SolverOptions
from ..utils import records
from . import batched
from .collectives import pmax
from .mesh import make_mesh, rank_device

_OPTS = SolverOptions(max_iter=500)


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    backend: str,
    timeout_s: float = 60.0,
) -> None:
    """Initialize the default process group of `num_processes` ranks.

    `coordinator_address` is "host:port" of rank 0; the arguments left out
    come from the environment (`MASTER_ADDR`, `MASTER_PORT`, `WORLD_SIZE`,
    `RANK`).  `backend` is "gloo" (CPU tensors, and CUDA tensors through the
    host, also for ranks that share one card) or "nccl" (one card per rank).
    `timeout_s` bounds every collective.
    """
    def env(key: str) -> str:
        if not os.environ.get(key):
            raise ValueError(f"init_distributed: {key} is not set and no argument gives it")
        return os.environ[key]

    address = coordinator_address or f"{env('MASTER_ADDR')}:{env('MASTER_PORT')}"
    world = int(env("WORLD_SIZE") if num_processes is None else num_processes)
    rank = int(env("RANK") if process_id is None else process_id)
    dist.init_process_group(
        backend=backend, init_method=f"tcp://{address}", world_size=world,
        rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
    )


def _random_batch(seed: int, batch: int, m: int, nv: int):
    """`batched.make_random_batch` from a CPU generator (the same numbers on
    every device)."""
    return batched.make_random_batch(torch.Generator().manual_seed(seed), batch, m, nv)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def measure_scaling(
    n_devices: int,
    batch_per_device: int = 128,
    m: int = 16,
    nv: int = 24,
    opts: SolverOptions = _OPTS,
    *,
    device="cuda",
) -> dict:
    """Throughput at 1 rank vs `n_devices` ranks (same per-rank batch).

    Every rank of a world of at least `n_devices` calls it.  Returns
    {"lps_per_sec_1dev", "lps_per_sec_ndev", "efficiency", ...} where
    efficiency is (LPs/s at n) / (n × LPs/s at 1).  Ranks that share a
    host's cores (or one card) measure the code path, not scaling.
    """
    dev = rank_device(device)

    def run(nd: int, batch: int) -> float:
        mesh = make_mesh(n_data=nd, n_model=1, device=dev, ranks=range(nd))
        dt = 0.0
        if mesh is not None:
            batched.solve_batch_sharded(mesh, *_random_batch(0, batch, m, nv), opts=opts)
            args = _random_batch(1, batch, m, nv)
            _sync(dev)
            t0 = time.perf_counter()
            batched.solve_batch_sharded(mesh, *args, opts=opts)
            _sync(dev)
            dt = time.perf_counter() - t0
        # the slowest rank's time, on every rank of the world
        return batch / float(pmax(torch.tensor(dt, device=dev), None))

    r1 = run(1, batch_per_device)
    rn = run(n_devices, batch_per_device * n_devices)
    result = {
        "lps_per_sec_1dev": r1,
        "lps_per_sec_ndev": rn,
        "n_devices": n_devices,
        "efficiency": rn / (n_devices * r1),
        "backend": f"{dev.type}/{dist.get_backend()}",
        "batch_per_device": batch_per_device,
        "m": m,
        "nv": nv,
    }
    if records.enabled() and dist.get_rank() == 0:
        records.emit(records.SolveRecord(
            event="scaling_harness", engine="simplex", status="OPTIMAL",
            rows=m, cols=nv, padded_rows=m, padded_cols=nv + m,
            iterations=0, objective=None, wall_s=0.0,
            backend=result["backend"], dtype=opts.dtype, extra=result,
        ))
    return result


def dryrun_multichip(n_devices: int, *, device="cuda") -> Optional[str]:
    """One step of each sharded engine on an n-rank mesh (DP × TP), as
    `__graft_entry__.py::dryrun_multichip` runs them: the batch over 'data',
    pricing, the column-sharded cold solve and dual re-solve over 'model',
    the row-sharded PDHG.  Every rank of the world calls it; rank 0 prints
    the summary line, and every rank of the mesh returns it."""
    from .pdhg_sharded import solve_pdhg_sharded
    from .pricing import choose_entering_sharded
    from .sharded_engine import resolve_dual_sharded, solve_canonical_sharded

    if dist.get_world_size() < n_devices:
        raise RuntimeError(f"need {n_devices} ranks, have {dist.get_world_size()}")
    n_model = 2 if n_devices % 2 == 0 else 1
    mesh = make_mesh(n_data=n_devices // n_model, n_model=n_model, device=device,
                     ranks=range(n_devices))
    if mesh is None:
        return None

    # DP: the full batched solve, batch split over 'data'
    batch = max(8, n_devices)
    state = batched.solve_batch_sharded(mesh, *_random_batch(1, batch, 8, 16), opts=_OPTS)

    # TP: column-partitioned pricing with the deterministic cross-rank argmax
    n_cols = 128 * n_model
    d = torch.randn(n_cols, generator=torch.Generator().manual_seed(2), dtype=torch.float64)
    vstat = torch.zeros(n_cols, dtype=torch.int8)  # all AT_LOWER
    choice = choose_entering_sharded(mesh, d, vstat, 1e-8)

    # TP: the full column-sharded solve loop on one tiny LP
    A1, b1, c1, lo1, hi1, vs1, bs1 = [x[0] for x in _random_batch(3, 1, 8, 8 * n_model)]
    tp = solve_canonical_sharded(mesh, A1, b1, c1, lo1, hi1, vs1, bs1, _OPTS)

    # TP warm re-solve: box the structurals, then the column-sharded dual
    # simplex from the maintained inverse of the cold sharded solve
    M1, N1 = A1.shape
    hi2 = hi1.clone()
    hi2[: N1 - M1] = torch.clamp(hi2[: N1 - M1], max=0.35)
    dual = resolve_dual_sharded(mesh, A1, b1, c1, lo1, hi2, tp["basis"], tp["vstat"],
                                tp["Binv"], _OPTS)

    # SP/CP: row-sharded PDHG over 'model'
    A2, b2, c2, lo2, hi2, _, _ = [x[0] for x in _random_batch(4, 1, 12, 20)]
    pd_opts = SolverOptions(engine="pdhg", feas_tol=1e-4, pdhg_max_iter=50_000)
    pd = solve_pdhg_sharded(mesh, A2, b2, c2, lo2, hi2, pd_opts)

    line = (
        f"dryrun_multichip OK: mesh={mesh.shape} "
        f"batch_objs={state.obj[:4].tolist()} pricing_q={int(choice.q)} "
        f"tp_solve=(status={int(tp['status'])}, obj={float(tp['obj']):.6f}, "
        f"iters={int(tp['niter'])}) "
        f"tp_dual_resolve=(status={int(dual['status'])}, iters={int(dual['niter'])}) "
        f"pdhg_rowsharded=(status={int(pd.status)}, iters={int(pd.niter)})"
    )
    if dist.get_rank() == 0:
        print(line, flush=True)
    return line


def main(argv=None) -> int:
    from .launch import run_world

    ap = argparse.ArgumentParser(description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--dryrun", type=int, required=True, metavar="N",
                    help="ranks of the world (one process each)")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    lines = run_world("minilp_tpu_torch.parallel.distributed:dryrun_multichip",
                      args.dryrun, backend="gloo", device=args.device,
                      args=(args.dryrun,), timeout_s=300.0)
    print(lines[0])
    return 0


if __name__ == "__main__":
    sys.exit(main())
