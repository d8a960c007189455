"""Traffic kind "scenario": batches of small independent dense LPs, a closed
loop with one client.  Each call hands `solve_batches_pipelined`
`batches_per_call` host batches from a pool made in set-up, call k taking
the batches k·batches_per_call onward of the pool's order, round the pool.
The pool is made from `pool_seed`, the same for every run, and the run's
seed orders it and draws the lanes judged: every seed gets the same work
(the same lanes fail the certificate and go to HiGHS), in another order.

The generator is `minilp_tpu_torch.utils.synth.random_batch`'s (the JAX
package's `make_random_batch_host`), copied draw for draw: minimize c·x s.t.
[A_s | I] x = b, structural x in [0, 1], slacks >= 0, b = A_s x0 + u for an
interior x0 and u > 0, so every LP is feasible and bounded.

Judged: in every call, the lanes of each batch that the seed drew for that
pool batch (`judged_lanes` each); and over the whole window, every lane's
certificate flag.
"""

from __future__ import annotations

import time

import numpy as np

from ..core import Answer, Request, Run, Window, seeded
from ..reference.lp import RowLP

STATUS = {1: "optimal", 2: "infeasible"}


def random_batch(seed, batch: int, m: int, nv: int):
    """`random_batch(seed, batch, m, nv)` of `minilp_tpu_torch.utils.synth`:
    (A (B, m, nv+m), b (B, m), c, lo, hi (B, nv+m)), host f64."""
    rng = np.random.default_rng(seed)
    n = nv + m
    A_s = rng.normal(size=(batch, m, nv))
    c_s = rng.normal(size=(batch, nv))
    x0 = rng.uniform(0.2, 0.8, size=(batch, nv))
    u = rng.uniform(0.1, 1.0, size=(batch, m))
    b = np.einsum("bmn,bn->bm", A_s, x0) + u
    eye = np.broadcast_to(np.eye(m), (batch, m, m))
    A = np.concatenate([A_s, eye], axis=2)
    c = np.concatenate([c_s, np.zeros((batch, m))], axis=1)
    lo = np.zeros((batch, n))
    hi = np.concatenate([np.ones((batch, nv)), np.full((batch, m), np.inf)], axis=1)
    return A, b, c, lo, hi


def lane_lp(batch, i: int) -> RowLP:
    A, b, c, lo, hi = batch
    return RowLP(c=c[i], A=A[i], sense=np.zeros(A.shape[1], dtype=np.int64), rhs=b[i],
                 lo=lo[i], hi=hi[i])


class Program:
    """`minilp_tpu_torch.parallel.batched.solve_batches_pipelined` on `device`:
    K3, the f64 certificate on the card, HiGHS on the lanes that fail it."""

    def __init__(self, device: str, sync, config: dict, params: dict):
        from minilp_tpu_torch.parallel.batched import solve_batches_pipelined

        self.run = lambda batches: solve_batches_pipelined(
            batches, device=device, pack=params["pack"], max_iter=params["max_iter"],
            structural_cols=config["shape"]["cols"])
        self.sync = sync

    def solve_batches(self, batches):
        """[(status, verified, obj, x, niter)] per batch, host arrays."""
        out = self.run(batches)
        self.sync()
        return [(np.asarray(r.status), np.asarray(r.verified), np.asarray(r.obj),
                 np.asarray(r.x), np.asarray(r.niter)) for r in out]


def prepare(config, params, seed):
    """(the pool of host batches, the run's order of it)."""
    shape = config["shape"]
    pool = [random_batch([params["pool_seed"], k, 6], params["batch"], shape["rows"],
                         shape["cols"])
            for k in range(params["pool"])]
    return pool, [int(p) for p in seeded(seed, 8).permutation(params["pool"])]


def _call_batches(params, order, k):
    per, size = params["batches_per_call"], params["pool"]
    return [order[(per * k + j) % size] for j in range(per)]


def warmup(config, params, seed, system, spans, state) -> None:
    """One call at the cell's shapes, on the window's first batches."""
    batches, order = state
    with spans("lpbench.warmup"):
        system.solve_batches([batches[p] for p in _call_batches(params, order, 0)])


def run(config, params, seed, system, window: Window, stages, records, spans, state) -> Run:
    batches, order = state
    lanes = [sorted(seeded(seed, p, 7).choice(params["batch"], size=params["judged_lanes"],
                                             replace=False))
             for p in range(params["pool"])]
    judged = []   # (pool batch, lane, answer)
    unverified = 0
    niter = []
    k = 0
    window.start()
    while window.open():
        which = _call_batches(params, order, k)
        stages.reset()
        failed = False
        t0 = time.perf_counter()
        with spans("lpbench.call"):
            try:
                out = system.solve_batches([batches[p] for p in which])
            except Exception:  # an error fails the whole call
                out, failed = None, True
        wall = time.perf_counter() - t0
        n = len(which) * params["batch"]
        req = Request("call", wall, stages.snapshot(), n_lps=n, failed=failed)
        window.requests.append(req)
        k += 1
        if failed:
            judged += [(p, i, Answer("failed")) for p in which for i in lanes[p]]
            unverified += n
            continue
        for p, (status, verified, obj, x, it) in zip(which, out):
            ok = verified & (status == 1)
            req.n_certified += int(ok.sum())
            unverified += int((~verified).sum())
            niter.append(it)
            for i in lanes[p]:
                judged.append((p, i, Answer(STATUS.get(int(status[i]), "failed"),
                                            float(obj[i]), x[i].copy())))
    window.close()
    lps = {(p, i): lane_lp(batches[p], i) for p in range(params["pool"]) for i in lanes[p]}
    return Run(window, [lps[(p, i)] for p, i, _ in judged], [a for _p, _i, a in judged],
               info={"unverified": unverified, "niter": niter, "shape": config["shape"],
                     "distinct": lps})
