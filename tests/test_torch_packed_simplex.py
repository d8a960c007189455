"""PyTorch port, K3 (the packed simplex kernel) against the Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain torch version
(`packed_plain`); the reference runs its Pallas kernel in interpret mode, as
the JAX package's own tests do.  Both iterate in f32 and reduce in different
orders, so the gate is: the same status and `verified` flag per LP,
certified (exact f64) objectives within 1e-9 relative, and the same per-LP
pivot count where both take the same pivot path (every instance here).  The
CUDA kernel is held against the plain version on the card by
`test_torch_cuda.py` and `chip_smoke.py`.

Each distinct Pallas signature costs seconds to trace in interpret mode, so
every reference result is computed once per module.
"""

import functools

import numpy as np
import pytest
import torch

from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.ops.kernels import packed_simplex as ref_ps
from minilp_tpu.parallel.batched import make_random_batch_host
from minilp_tpu.status import Status
from minilp_tpu.utils.synth import degenerate_problem
from minilp_tpu_torch.ops.kernels import packed_simplex as ps
from minilp_tpu_torch.utils.synth import random_batch

from .oracle import random_problem
from .torch_helpers import rel_err

REL_OBJ = 1e-9  # certified objectives, both exact f64 recomputations
KW = dict(refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
          bland_after=200)


def _replicated(seed, lanes):
    """A canonicalized random problem replicated over `lanes` lanes."""
    rng = np.random.default_rng(8800 + seed)
    can = ref_canonicalize(random_problem(rng, nv=int(rng.integers(4, 8)),
                                          m=int(rng.integers(2, 6))))
    tile = lambda x: np.broadcast_to(x, (lanes,) + x.shape).copy()
    return tuple(tile(x) for x in (can.A, can.b, can.c, can.lo, can.hi)), can.nv


def _unequal_packs():
    """Two packs of 4 degenerate LPs (ties in the ratio test and pricing),
    one lane of each pack with a zero objective: that lane stops after its
    phase 1 (11 and 14 pivots) while its pack-mates run to 25–31."""
    cans = [ref_canonicalize(degenerate_problem(12, 30, 0.3, seed=s))
            for s in (24, 25, 26, 27, 36, 37, 38, 39)]
    A, b, c, lo, hi = (np.stack([getattr(can, f) for can in cans])
                       for f in ("A", "b", "c", "lo", "hi"))
    c[[0, 5]] = 0.0
    return (A, b, c, lo, hi), cans[0].nv


CASES = {
    "rand_pack4": (make_random_batch_host(0, 8, 8, 16), dict(pack=4)),
    "rand_pack8": (make_random_batch_host(1, 16, 8, 24), dict(pack=8)),
    "rand_pack4_period4": (make_random_batch_host(2, 8, 8, 24),
                           dict(pack=4, refactor_period=4)),
}
for _seed in range(2):
    _lp, _nv = _replicated(_seed, 8)
    CASES[f"canonical_{_seed}"] = (_lp, dict(pack=4, slack0=_nv, max_iter=4000))
_lp, _nv = _unequal_packs()
CASES["unequal_period4"] = (_lp, dict(pack=4, slack0=_nv, max_iter=4000,
                                      refactor_period=4))


@functools.lru_cache(maxsize=None)
def _ref(case):
    """The Pallas kernel's result on a named case (cached per module)."""
    lp, kw = CASES[case]
    return ref_ps.solve_batch_packed(*lp, interpret=True, **kw)


def _port(case, **over):
    lp, kw = CASES[case]
    return ps.solve_batch_packed(*lp, device="cpu", **dict(kw, **over))


def _assert_agree(ref, got, same_path=True):
    np.testing.assert_array_equal(got.status, np.asarray(ref.status))
    np.testing.assert_array_equal(got.verified, np.asarray(ref.verified))
    v = np.asarray(ref.verified)
    for o_got, o_ref in zip(got.obj[v], np.asarray(ref.obj)[v]):
        assert rel_err(float(o_got), float(o_ref)) <= REL_OBJ
    if same_path:
        np.testing.assert_array_equal(got.niter, np.asarray(ref.niter))


@pytest.mark.parametrize("case", list(CASES))
def test_cold_matches_pallas(case):
    ref, got = _ref(case), _port(case)
    assert got.verified.any()
    _assert_agree(ref, got)
    A, b = CASES[case][0][:2]
    v = got.verified
    # the exact vertex solves A x = b on every certified lane
    assert np.abs(np.einsum("bmn,bn->bm", A[v], got.x[v]) - b[v]).max() < 1e-9


def test_pack_rule_decides_pivots():
    """At refactor_period=4 the pack-mates' transitions, forced exit checks
    and pivot counts decide when each LP refreshes and when its terminal
    claim is believed.  The port follows the reference lane for lane, and
    K1's per-LP rule (pack 1) takes other pivots on the same lanes."""
    ref, got = _ref("unequal_period4"), _port("unequal_period4")
    _assert_agree(ref, got)
    assert (got.status == int(Status.OPTIMAL)).all() and got.verified.all()
    for pack in got.niter.reshape(2, 4):  # pack-mates of unequal length
        assert pack.max() - pack.min() >= 10
    solo = _port("unequal_period4", pack=1)
    assert (solo.niter != got.niter).any()
    _assert_agree(got, solo, same_path=False)


def test_bench_batch_unverified_lane_is_parity():
    """Pack 58 (lanes 464-471) of `random_batch(1, 1024, 32, 96)`, the first
    batch of `chip_smoke.py`'s phase 5 at bench.py's shape: lane 471 ends
    OPTIMAL but fails the f64 check, so the batched path re-solves it on the
    host.  The Pallas kernel leaves the same lane unverified, after the same
    pivots on every lane: parity, not a fault of the port."""
    lp = tuple(x[464:472] for x in random_batch(1, 1024, 32, 96))
    kw = dict(pack=8, slack0=96, max_iter=2000, **KW)
    ref = ref_ps.solve_batch_packed(*lp, interpret=True, **kw)
    got = ps.solve_batch_packed(*lp, device="cpu", **kw)
    _assert_agree(ref, got)
    assert (got.status == int(Status.OPTIMAL)).all()
    assert got.verified.tolist() == [True] * 7 + [False]
    assert got.niter.tolist() == [161, 224, 182, 179, 184, 194, 159, 155]


def _tensors(P=2, pack=4, m=4, nv=6, seed=0):
    A, b, c, lo, hi = make_random_batch_host(seed, P * pack, m, nv)
    return ps.upload_packed(A, b, c, lo, hi, pack=pack, device="cpu")


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _tensors()
    before = ps.launches
    out = ps.packed_kernel_call(*args, pack=4, slack0=6, max_iter=100, **KW)
    assert ps.launches == before
    assert out.dtype == torch.int32 and out.shape == (2, 4, 4 + 10 + 2)
    np.testing.assert_array_equal(
        out.numpy(), ps.packed_plain(*args, pack=4, slack0=6, max_iter=100, **KW).numpy())
    assert (out[..., -2] == int(Status.OPTIMAL)).all()


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous", "rows", "pack", "layout"])
def test_wrapper_rejects_bad_inputs(fault):
    A, b, c, lo, hi = _tensors()
    pack, layout = 4, None
    if fault == "dtype":
        A = A.double()
    elif fault == "shape":
        b = b[:, :, :3].contiguous()
    elif fault == "contiguous":
        A = A.transpose(1, 2).contiguous().transpose(1, 2)
    elif fault == "rows":
        pack = 3  # 16 rows are not 3 LPs
    elif fault == "pack":
        pack = ps.MAX_PACK + 1  # more warps than one thread block holds
    else:
        layout = "registers"  # not one of ps.LAYOUTS
    with pytest.raises(ValueError):
        ps.packed_kernel_call(A, b, c, lo, hi, pack=pack, slack0=6, max_iter=10,
                              layout=layout, **KW)


def test_batch_must_divide_into_packs():
    A, b, c, lo, hi = make_random_batch_host(0, 6, 4, 6)
    with pytest.raises(ValueError, match="not divisible"):
        ps.solve_batch_packed(A, b, c, lo, hi, device="cpu", pack=4)
