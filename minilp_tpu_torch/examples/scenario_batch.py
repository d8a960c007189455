"""Batched scenario solving, PyTorch port of `examples/scenario_batch.py`.

The two batched engines (BASELINE config 3):
  * K1 in batch mode (`ops.kernels.batched_simplex.solve_batch_megakernel`,
    one thread block per LP on the card, its plain torch version on the
    CPU): the f32 simplex loop plus the exact f64 certificate of each final
    basis on the same device (`ops/kernels/certify.py`), the throughput
    path;
  * the f64 torch engine (`parallel.batched.solve_batch`), lane after lane:
    the fallback for the lanes whose basis fails the certificate.

`solve_scenarios` takes the arrays; the command line makes the batch:

    python -m minilp_tpu_torch.examples.scenario_batch [batch] [m] [nv] [device]

The batch comes from `make_random_batch_host(0, ...)` (numpy), not from the
JAX example's `jax.random` key, so the default batch's numbers differ from
the JAX script's; its structure (boxed structurals, a feasible interior
point) is the same.  `solve_batch_certified` is not used: its HiGHS re-solve
of the unverified lanes would leave the f64 fallback nothing to do.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch

from minilp_tpu_torch.ops.kernels.batched_simplex import solve_batch_megakernel
from minilp_tpu_torch.options import SolverOptions
from minilp_tpu_torch.parallel.batched import make_random_batch_host, solve_batch
from minilp_tpu_torch.status import Status, VarStat


def solve_scenarios(A, b, c, lo, hi, *, device: str = "cuda") -> dict:
    """Solve a batch of canonical LPs (A (B, m, n), identity slack block in
    the last m columns) through K1, then the lanes K1 left unverified
    through the f64 engine.

    Returns the final `status` and `obj` per lane (the fallback's where it
    ran), K1's `verified` flags and pivots (`niter`), the `fallback` lanes,
    and the walls `kernel_s` (K1 and its certificate) and `fallback_s`.
    """
    t0 = time.perf_counter()
    res = solve_batch_megakernel(A, b, c, lo, hi, device=device)
    kernel_s = time.perf_counter() - t0
    status, obj = np.array(res.status), np.array(res.obj)
    verified = np.asarray(res.verified)

    # fall back to the exact f64 engine for any unverified lane
    bad = np.flatnonzero(~verified)
    t0 = time.perf_counter()
    if bad.size:
        B, m, n = np.shape(A)
        put = lambda x: torch.as_tensor(np.asarray(x)[bad], device=device)
        vstat0 = torch.full((bad.size, n), int(VarStat.AT_LOWER), dtype=torch.int8)
        vstat0[:, n - m:] = int(VarStat.BASIC)
        basis0 = torch.arange(n - m, n).repeat(bad.size, 1)
        ref = solve_batch(*(put(x) for x in (A, b, c, lo, hi)), vstat0.to(device),
                          basis0.to(device), opts=SolverOptions(device=device))
        status[bad] = ref.status.cpu().numpy()
        obj[bad] = ref.obj.cpu().numpy()
    return dict(status=status, verified=verified, obj=obj, niter=np.asarray(res.niter),
                fallback=bad, kernel_s=kernel_s, fallback_s=time.perf_counter() - t0)


def main(batch: int = 512, m: int = 16, nv: int = 24, device: str = "cuda") -> dict:
    A, b, c, lo, hi = make_random_batch_host(0, batch, m, nv)
    out = solve_scenarios(A, b, c, lo, hi, device=device)
    verified = out["verified"]
    print(
        f"K1 batch mode: {batch} LPs in {out['kernel_s']:.3f}s "
        f"({batch / out['kernel_s']:.0f} LPs/s incl. the f64 certificate), "
        f"{int(verified.sum())}/{batch} f64-certified, "
        f"mean iters {float(out['niter'].mean()):.1f}"
    )
    if out["fallback"].size:
        print(f"fallback re-solved {out['fallback'].size} lanes: statuses "
              f"{out['status'][out['fallback']]}")
    n_opt = int((out["status"] == int(Status.OPTIMAL)).sum())
    print(f"{n_opt}/{batch} optimal; example objectives: "
          f"{out['obj'][:4].round(6).tolist()}")
    return out


if __name__ == "__main__":
    argv = sys.argv[1:5]
    main(*[int(a) for a in argv[:3]], *argv[3:])
