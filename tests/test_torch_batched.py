"""PyTorch port, the batched scenario path against the JAX package's.

The same numpy batches go through `minilp_tpu.parallel.batched` /
`.scheduling` (Pallas kernels in interpret mode, the vmapped f64 engine) and
through the port's `minilp_tpu_torch.parallel.batched` / `.scheduling` on
the CPU, where K1 and K3 run as their plain torch versions.  Certified
objectives agree within 1e-9 relative (exact f64 recomputations from f32
bases); the f64 engines take the same pivot sequence lane for lane.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minilp_tpu
from minilp_tpu.parallel import batched as ref_batched
from minilp_tpu.parallel import scheduling as ref_sched
from minilp_tpu.status import Status, VarStat
from minilp_tpu_torch.parallel import batched, scheduling
from minilp_tpu_torch.utils.synth import random_batch

from .torch_helpers import CPU, f64, rel_err

REL_OBJ = 1e-9


def _batches(base, count=3, B=8, m=8, nv=16):
    return [ref_batched.make_random_batch_host(base + k, batch=B, m=m, nv=nv)
            for k in range(count)]


def _assert_same_answers(ref, got, rel=REL_OBJ, same_path=True):
    np.testing.assert_array_equal(np.asarray(got.status), np.asarray(ref.status))
    np.testing.assert_array_equal(np.asarray(got.verified), np.asarray(ref.verified))
    for o_got, o_ref in zip(np.asarray(got.obj), np.asarray(ref.obj)):
        assert rel_err(float(o_got), float(o_ref)) <= rel
    if same_path:
        np.testing.assert_array_equal(np.asarray(got.niter), np.asarray(ref.niter))


def test_host_batch_generator_is_the_reference_one():
    for x, y in zip(batched.make_random_batch_host(5, 4, 6, 10),
                    ref_batched.make_random_batch_host(5, 4, 6, 10)):
        np.testing.assert_array_equal(x, y)
    assert batched.make_random_batch_host is random_batch


@functools.lru_cache(maxsize=None)
def _ref_pipelined(structural: bool, sort_packs: bool):
    return ref_batched.solve_batches_pipelined(
        _batches(100), pack=4, max_iter=2000, sort_packs=sort_packs,
        structural_cols=16 if structural else None)


@pytest.mark.parametrize("structural,sort_packs", [
    (False, False), (True, False), (False, True)])
def test_pipelined_matches_reference(structural, sort_packs):
    batches = _batches(100)
    got = batched.solve_batches_pipelined(
        batches, device="cpu", pack=4, max_iter=2000, sort_packs=sort_packs,
        structural_cols=16 if structural else None)
    assert len(got) == 3
    for ref_res, res in zip(_ref_pipelined(structural, sort_packs), got):
        assert np.asarray(res.verified).all()
        _assert_same_answers(ref_res, res)
    if structural or sort_packs:
        # the structural upload and the sorted packing change no answer
        plain = batched.solve_batches_pipelined(batches, device="cpu", pack=4)
        for a, b in zip(plain, got):
            np.testing.assert_allclose(np.asarray(a.obj), np.asarray(b.obj),
                                       rtol=1e-12, atol=1e-12)


def test_pipelined_structural_upload_needs_the_slack_after_it():
    with pytest.raises(ValueError, match="slack block"):
        batched.solve_batches_pipelined(_batches(100, count=1), device="cpu", pack=4,
                                        structural_cols=12)


def test_solve_batch_certified_matches_reference():
    A, b, c, lo, hi = ref_batched.make_random_batch_host(7, 6, 8, 16)
    ref = ref_batched.solve_batch_certified(A, b, c, lo, hi)
    got = batched.solve_batch_certified(A, b, c, lo, hi, device="cpu")
    assert np.asarray(got.verified).all()
    _assert_same_answers(ref, got, same_path=False)


def test_resolve_unverified_host_matches_reference():
    """A lane whose certificate failed is re-solved by HiGHS, in both
    packages alike."""
    A, b, c, lo, hi = ref_batched.make_random_batch_host(8, 4, 6, 10)
    res = batched.solve_batch_certified(A, b, c, lo, hi, device="cpu")
    broken = res._replace(verified=np.array([True, False, True, False]),
                          obj=np.where([True, False, True, False], res.obj, 123.0))
    ref = ref_batched.resolve_unverified_host(broken, A, b, c, lo, hi)
    got = batched.resolve_unverified_host(broken, A, b, c, lo, hi)
    assert np.asarray(got.verified).all()
    for x, y in zip(got, ref):
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))
    np.testing.assert_allclose(got.obj, res.obj, rtol=1e-9, atol=1e-9)


def test_packed_sorted_matches_reference_and_unsorted():
    A, b, c, lo, hi = ref_batched.make_random_batch_host(11, 8, 8, 16)
    ref = ref_sched.solve_batch_packed_sorted(A, b, c, lo, hi, pack=4, interpret=True)
    got = scheduling.solve_batch_packed_sorted(A, b, c, lo, hi, pack=4, device="cpu")
    assert (got.status == int(Status.OPTIMAL)).all() and got.verified.all()
    _assert_same_answers(ref, got)
    # positionally identical to the unsorted call: lane i is LP i
    from minilp_tpu_torch.ops.kernels.packed_simplex import solve_batch_packed

    unsorted = solve_batch_packed(A, b, c, lo, hi, pack=4, device="cpu")
    _assert_same_answers(unsorted, got, same_path=False)


def _mixed_lps():
    lps = []
    for seed, m, nv, count in [(0, 4, 6, 3), (1, 6, 10, 2), (2, 8, 16, 3)]:
        A, b, c, lo, hi = ref_batched.make_random_batch_host(seed, batch=count, m=m, nv=nv)
        lps += [(A[i], b[i], c[i], lo[i], hi[i]) for i in range(count)]
    # an infeasible LP in the mix: x + s = -1 with x, s >= 0
    lps.append((np.array([[1.0, 1.0]]), np.array([-1.0]), np.array([1.0, 0.0]),
                np.zeros(2), np.full(2, np.inf), 1))
    return lps


def test_heterogeneous_matches_reference():
    """Mixed sizes: bucketed, padded (lanes replicated up to the pack),
    sorted, packed; answers in input order and each LP's own layout."""
    lps = _mixed_lps()
    kw = dict(pack=4, row_granule=4, col_granule=8)
    ref = ref_sched.solve_heterogeneous(lps, interpret=True, **kw)
    got = scheduling.solve_heterogeneous(lps, device="cpu", **kw)
    assert len(got) == len(lps)
    for lp, r, g in zip(lps, ref, got):
        assert isinstance(g, scheduling.LPResult)
        assert (g.status, g.verified, g.niter) == (r.status, r.verified, r.niter)
        assert g.x.shape == lp[2].shape
        if g.status == int(Status.OPTIMAL):
            assert rel_err(g.obj, r.obj) <= REL_OBJ
            np.testing.assert_allclose(lp[0] @ g.x, lp[1], atol=1e-7)
    assert got[-1].status == int(Status.INFEASIBLE)


def test_solve_batch_matches_reference_engine():
    """The f64 engines, the port's lane after lane and the reference's under
    vmap, take the same pivots: status, niter and basis agree per lane."""
    B, m, nv = 4, 6, 10
    A, b, c, lo, hi = ref_batched.make_random_batch_host(3, B, m, nv)
    vstat0 = np.concatenate([np.full((B, nv), int(VarStat.AT_LOWER), np.int8),
                             np.full((B, m), int(VarStat.BASIC), np.int8)], axis=1)
    basis0 = np.tile(np.arange(nv, nv + m, dtype=np.int32), (B, 1))
    ref = ref_batched.solve_batch(*(jnp.asarray(x) for x in (A, b, c, lo, hi, vstat0, basis0)),
                                  opts=minilp_tpu.DEFAULT_OPTIONS)
    got = batched.solve_batch(*f64(A, b, c, lo, hi), torch.as_tensor(vstat0),
                              torch.as_tensor(basis0), CPU)
    np.testing.assert_array_equal(got.status.numpy(), np.asarray(ref.status))
    np.testing.assert_array_equal(got.niter.numpy(), np.asarray(ref.niter))
    np.testing.assert_array_equal(got.basis.numpy(), np.asarray(ref.basis))
    assert (got.status.numpy() == int(Status.OPTIMAL)).all()
    for o_got, o_ref in zip(got.obj.numpy(), np.asarray(ref.obj)):
        assert rel_err(float(o_got), float(o_ref)) <= REL_OBJ


def test_make_random_batch_is_feasible_and_bounded():
    """Drawn from a torch.Generator (other numbers than jax.random's), with
    the reference's structure: every lane solves to OPTIMAL."""
    gen = torch.Generator().manual_seed(0)
    A, b, c, lo, hi, vstat0, basis0 = batched.make_random_batch(gen, 3, 5, 8)
    assert A.shape == (3, 5, 13) and A.dtype == torch.float64
    assert torch.equal(A[:, :, 8:], torch.eye(5, dtype=torch.float64).expand(3, 5, 5))
    assert (vstat0[:, 8:] == int(VarStat.BASIC)).all() and (basis0 == torch.arange(8, 13)).all()
    state = batched.solve_batch(A, b, c, lo, hi, vstat0, basis0, CPU)
    assert (state.status == int(Status.OPTIMAL)).all()


def test_difficulty_scores_and_pad_lp_are_the_reference_ones():
    A, b, c, lo, hi = ref_batched.make_random_batch_host(7, 12, 8, 12)
    np.testing.assert_array_equal(scheduling.difficulty_scores(A, b, c, lo, hi),
                                  ref_sched.difficulty_scores(A, b, c, lo, hi))
    one = [x[0] for x in (A, b, c, lo, hi)]
    for x, y in zip(scheduling.pad_lp(*one, 12, M=10, NV=16),
                    ref_sched.pad_lp(*one, 12, M=10, NV=16)):
        np.testing.assert_array_equal(x, y)
