"""PyTorch port, f64 engine: torch `solve_canonical` against the JAX package's.

Both run in f64 on the CPU from the same canonical arrays.  Lowest-index
tie-breaks are a design invariant, so the port must take the reference's
pivot sequence: the same status, the same iteration count and the same final
basis, with the objective within 1e-9 relative (sums run in another order).
The building blocks (pricing, the ratio test, the basis updates) are held to
the reference on random data, and a warm re-solve takes the reference's
state across through `state_from_numpy`.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import minilp_tpu
from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import basis as ref_basis
from minilp_tpu.engine.driver import _solve_jit as ref_solve
from minilp_tpu.ops.pricing import choose_entering as ref_choose
from minilp_tpu.ops.ratio import ratio_test as ref_ratio
from minilp_tpu.utils import synth as ref_synth
from minilp_tpu_torch.engine import basis
from minilp_tpu_torch.engine.primal import solve_canonical
from minilp_tpu_torch.engine.state import SimplexState, state_from_numpy, state_to_numpy
from minilp_tpu_torch.ops.pricing import choose_entering
from minilp_tpu_torch.ops.ratio import ratio_test

from .oracle import random_problem
from .torch_helpers import CPU, HAND_CASES, f64, rel_err

REF_OPTS = minilp_tpu.SolverOptions()


def _ref_state(can, opts=REF_OPTS, vstat=None, basis0=None, Binv0=None):
    args = [jnp.asarray(x) for x in (can.A, can.b, can.c, can.lo, can.hi)]
    vstat = can.vstat0 if vstat is None else vstat
    basis0 = can.basis0 if basis0 is None else basis0
    kw = {} if Binv0 is None else {"Binv0": jnp.asarray(Binv0)}
    return ref_solve(*args, jnp.asarray(vstat), jnp.asarray(basis0), opts=opts, **kw)


def _assert_same_run(can, ref, got):
    assert int(got.status) == int(ref.status)
    assert int(got.niter) == int(ref.niter)
    np.testing.assert_array_equal(got.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(got.vstat.numpy(), np.asarray(ref.vstat))
    assert rel_err(float(got.obj), float(ref.obj)) <= 1e-9


def _check_engine(can):
    ref = _ref_state(can)
    got = solve_canonical(*f64(can.A, can.b, can.c, can.lo, can.hi),
                          can.vstat0, can.basis0, opts=CPU)
    _assert_same_run(can, ref, got)
    return ref, got


@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_engine_matches_reference_hand_cases(name):
    build, _expected = HAND_CASES[name]
    _check_engine(canonicalize(build()))


@pytest.mark.parametrize("seed", range(16))
def test_engine_matches_reference_random(seed):
    rng = np.random.default_rng(1000 + seed)
    prob = random_problem(rng, int(rng.integers(2, 12)), int(rng.integers(1, 14)))
    _check_engine(canonicalize(prob))


@pytest.mark.parametrize("seed", range(4))
def test_engine_matches_reference_medium(seed):
    rng = np.random.default_rng(7000 + seed)
    prob = random_problem(rng, int(rng.integers(20, 60)), int(rng.integers(15, 40)),
                          density=0.5)
    _check_engine(canonicalize(prob))


@pytest.mark.parametrize("fn,args", [
    ("netlib_shaped_problem", (40, 100, 0.08)),
    ("degenerate_problem", (30, 60, 0.15)),
    ("ill_conditioned_problem", (24, 48, 0.2)),
    ("staircase_problem", (4, 6, 10)),
    ("network_flow_problem", (12, 40)),
    ("mixed_bounds_problem", (30, 50, 0.15)),
])
def test_engine_matches_reference_synth(fn, args):
    ref, _ = _check_engine(canonicalize(getattr(ref_synth, fn)(*args, seed=2)))
    assert int(ref.niter) > 0


def test_warm_resolve_from_reference_state():
    """The reference's optimal state crosses over through state_from_numpy;
    after a tightened bound both engines re-solve warm from it alike."""
    rng = np.random.default_rng(41)
    can = canonicalize(random_problem(rng, 30, 20, density=0.6, frac_free=0.0))
    ref0 = _ref_state(can)
    assert int(ref0.status) == int(minilp_tpu.Status.OPTIMAL)
    st = state_from_numpy(ref0, "cpu")
    assert isinstance(st, SimplexState) and st.basis.dtype == torch.int64
    back = state_to_numpy(st)
    for name in SimplexState._fields:
        np.testing.assert_array_equal(np.asarray(getattr(back, name)),
                                      np.asarray(getattr(ref0, name)))
    x = np.zeros(can.N)
    x[np.asarray(ref0.basis)] = np.asarray(ref0.xB)
    j = max((int(k) for k in np.asarray(ref0.basis) if k < can.nv),
            key=lambda k: x[k] - can.lo[k] if np.isfinite(can.lo[k]) else -1.0)
    can.hi[j] = 0.5 * (can.lo[j] + x[j])  # cut the largest basic variable
    ref = _ref_state(can, vstat=ref0.vstat, basis0=ref0.basis, Binv0=ref0.Binv)
    got = solve_canonical(*f64(can.A, can.b, can.c, can.lo, can.hi),
                          st.vstat, st.basis, opts=CPU, Binv0=st.Binv)
    _assert_same_run(can, ref, got)
    assert int(got.status) == int(minilp_tpu.Status.OPTIMAL) and int(got.niter) > 0


@pytest.mark.parametrize("seed", range(3))
def test_basis_updates_match_reference(seed):
    rng = np.random.default_rng(seed)
    m, n = 12, 30
    A = rng.normal(size=(m, n))
    A[:, n - m:] += 4.0 * np.eye(m)
    bas = rng.permutation(n)[:m]
    bas[:m] = np.arange(n - m, n)
    B = A[:, bas]
    X0 = np.linalg.inv(B) + 1e-4 * rng.normal(size=(m, m))
    X, resid = basis.newton_refresh(*f64(B, X0), 3)
    Xr, resid_r = ref_basis.newton_refresh(jnp.asarray(B), jnp.asarray(X0), 3)
    np.testing.assert_allclose(X.numpy(), np.asarray(Xr), rtol=0, atol=1e-13)
    assert float(resid) == pytest.approx(float(resid_r), rel=1e-9)
    np.testing.assert_allclose(basis.stable_inverse(f64(B)[0]).numpy(),
                               np.linalg.inv(B), rtol=0, atol=1e-12)
    w = rng.normal(size=m)
    r = int(np.argmax(np.abs(w)))
    np.testing.assert_allclose(
        basis.pfi_update(*f64(X0, w), r).numpy(),
        np.asarray(ref_basis.pfi_update(jnp.asarray(X0), jnp.asarray(w), r)),
        rtol=0, atol=1e-14)
    lo, hi = np.zeros(n), np.full(n, 2.0)
    b, c = rng.normal(size=m), rng.normal(size=n)
    vstat = np.where(rng.random(n) < 0.5, 0, 1).astype(np.int8)
    vstat[bas] = 4
    got = basis.refactorize(*f64(A, b, c, lo, hi), torch.as_tensor(bas),
                            torch.as_tensor(vstat), f64(X0)[0], newton_iters=3)
    ref = ref_basis.refactorize(*(jnp.asarray(v) for v in (A, b, c, lo, hi, bas, vstat, X0)),
                                newton_iters=3)
    for g, e in zip(got[:4], ref[:4]):
        np.testing.assert_allclose(np.asarray(g), np.asarray(e), rtol=1e-12, atol=1e-12)
    assert got[4] == bool(ref[4])


@pytest.mark.parametrize("seed", range(6))
@pytest.mark.parametrize("bland", [False, True])
def test_pricing_and_ratio_match_reference(seed, bland):
    rng = np.random.default_rng(50 + seed)
    m, n = 10, 24
    d = rng.normal(size=n)
    d[rng.random(n) < 0.2] = 0.0
    vstat = rng.integers(0, 5, size=n).astype(np.int8)
    weights = rng.uniform(0.5, 3.0, size=n)
    ch = choose_entering(*f64(d), torch.as_tensor(vstat), 1e-8, bland,
                         weights=f64(weights)[0])
    ch_r = ref_choose(jnp.asarray(d), jnp.asarray(vstat), 1e-8, jnp.bool_(bland),
                      weights=jnp.asarray(weights))
    assert (ch.q, ch.found, ch.direction) == (int(ch_r.q), bool(ch_r.found),
                                              float(ch_r.direction))
    # ratio test: some basics infeasible (phase-1 long step), ±inf bounds,
    # exact ties among degenerate rows
    w = rng.normal(size=m)
    w[:3] = 1.0
    loB = rng.uniform(-2, 0, size=m)
    hiB = loB + rng.uniform(0.5, 2, size=m)
    hiB[rng.random(m) < 0.2] = np.inf
    xB = rng.uniform(loB, np.where(np.isfinite(hiB), hiB, loB + 3))
    xB[:3] = loB[:3]
    xB[5] = loB[5] - 0.7
    bas = rng.permutation(40)[:m]
    for s in (1.0, -1.0):
        for rng_q in (0.3, np.inf):
            kw = dict(phase1=True, pivot_tol=1e-9, feas_tol=1e-9, tie_rel=1e-7,
                      tie_abs=1e-9)
            rt = ratio_test(*f64(w), s, *f64(xB, loB, hiB), f64(rng_q)[0],
                            torch.as_tensor(bas), bland, **kw)
            rt_r = ref_ratio(jnp.asarray(w), jnp.asarray(s), jnp.asarray(xB),
                             jnp.asarray(loB), jnp.asarray(hiB), jnp.asarray(rng_q),
                             jnp.asarray(bas), jnp.bool_(bland), **kw)
            assert (rt.flip, rt.unbounded) == (bool(rt_r.flip), bool(rt_r.unbounded))
            if not rt.unbounded:
                assert rt.r == int(rt_r.r)
                assert float(rt.t) == float(rt_r.t)
                assert float(rt.tgt_r) == float(rt_r.tgt_r)
