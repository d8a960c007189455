"""PyTorch port, f64 dual simplex: torch `resolve_dual` against the JAX package's.

Both run in f64 on the CPU from the same warm state `(A, b, c, lo, hi, basis,
vstat, B⁻¹)`: a solved LP after (i) one appended violated row, patched as
the JAX package's `incremental._append_row` patches it (B⁻¹'s new row
e_i − vᵀB⁻¹), or (ii) a basic variable fixed away from its value.  The rules
that decide the pivot sequence (dual steepest edge, the Harris ratio test
with its tie window, Bland, the bound flip) break ties toward the lowest
index in both packages, so the port must take the reference's pivot
sequence: the same status, `niter`, final basis and vstat, with x_B, d and
the objective within 1e-9.
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import minilp_tpu
from minilp_tpu.engine import incremental as ref_incremental
from minilp_tpu_torch.engine.dual import make_dual_step, resolve_dual
from minilp_tpu_torch.engine.state import SimplexState

from .oracle import random_problem, solve_with_oracle
from .torch_helpers import CPU, f64, rel_err

_MAX = minilp_tpu.OptimizationDirection.Maximize
_LE, _GE = minilp_tpu.ComparisonOp.Le, minilp_tpu.ComparisonOp.Ge


def _solved_handle(prob):
    """The JAX package's handle of a solved LP, its B⁻¹ materialized."""
    sol = prob.solve()
    handle = sol._engine
    handle.ensure_binv()
    return handle


def _x_full(handle):
    return np.array(handle._x_full())


def _append_violated_row(handle, rng):
    """A random row over the structural variables that cuts the optimum
    off by 0.5, appended with the JAX package's `_append_row`."""
    nv = handle.can.nv
    coeffs = rng.normal(size=nv)
    rhs = float(coeffs @ _x_full(handle)[:nv]) - 0.5
    ref_incremental._append_row(handle, coeffs, _LE, rhs)


def _fix_basic(handle):
    """Fix the basic structural variable farthest from its lower bound (or
    the first basic structural) at 0.3 of the way from its value toward the
    lower bound (or at value − 1 when that bound is infinite)."""
    can, x = handle.can, _x_full(handle)
    basic = [int(j) for j in np.asarray(handle.state.basis) if j < can.nv]
    assert basic, "no basic structural variable"
    j = basic[0]
    val = x[j] - 1.0 if not np.isfinite(can.lo[j]) else x[j] - 0.3 * (x[j] - can.lo[j])
    can.lo[j] = can.hi[j] = val


def _both(handle, **opts):
    """The reference's and the port's resolve_dual on the handle's warm
    state, both with the options `opts`."""
    can, st = handle.can, handle.state
    ref = ref_incremental._resolve_dual_jit(
        *(jnp.asarray(x) for x in (can.A, can.b, can.c, can.lo, can.hi)),
        jnp.asarray(st.basis), jnp.asarray(st.vstat), jnp.asarray(st.Binv),
        opts=minilp_tpu.SolverOptions(**opts),
    )
    got = resolve_dual(*f64(can.A, can.b, can.c, can.lo, can.hi),
                       np.array(st.basis), np.array(st.vstat),
                       torch.as_tensor(np.array(st.Binv)), dataclasses.replace(CPU, **opts))
    return ref, got


def _assert_same_run(ref, got):
    assert int(got.status) == int(ref.status)
    assert int(got.niter) == int(ref.niter)
    np.testing.assert_array_equal(got.basis.numpy(), np.asarray(ref.basis))
    np.testing.assert_array_equal(got.vstat.numpy(), np.asarray(ref.vstat))
    np.testing.assert_allclose(got.xB.numpy(), np.asarray(ref.xB), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(got.d.numpy(), np.asarray(ref.d), rtol=1e-9, atol=1e-9)
    assert rel_err(float(got.obj), float(ref.obj)) <= 1e-9


def _optimal_random(seed, nv, m):
    rng = np.random.default_rng(seed)
    prob = random_problem(rng, nv, m, density=0.6)
    outcome, _obj, _ = solve_with_oracle(prob)
    assert outcome == "optimal", (seed, outcome)
    return prob, rng


#: (seed, nv, m) of random_problem instances that are optimal
RANDOM = [(3, 30, 20), (8, 30, 20), (21, 40, 25), (55, 25, 30)]


@pytest.mark.parametrize("seed,nv,m", RANDOM)
@pytest.mark.parametrize("edit", ["append_row", "fix_basic"])
def test_resolve_dual_matches_reference(seed, nv, m, edit):
    prob, rng = _optimal_random(seed, nv, m)
    handle = _solved_handle(prob)
    if edit == "append_row":
        _append_violated_row(handle, rng)
    else:
        _fix_basic(handle)
    ref, got = _both(handle)
    _assert_same_run(ref, got)
    assert int(got.niter) > 0


def _run_counting_flips(handle):
    """The port's dual loop step by step from the same start as
    `resolve_dual`; returns (final state, bound flips taken)."""
    can, st = handle.can, handle.state
    start = resolve_dual(*f64(can.A, can.b, can.c, can.lo, can.hi),
                         np.array(st.basis), np.array(st.vstat),
                         torch.as_tensor(np.array(st.Binv)),
                         dataclasses.replace(CPU, max_iter=0))
    state = start._replace(status=torch.tensor(int(minilp_tpu.Status.RUNNING),
                                               dtype=torch.int32))
    step = make_dual_step(*f64(can.A, can.b, can.c, can.lo, can.hi), CPU)
    flips = 0
    while int(state.status) == int(minilp_tpu.Status.RUNNING):
        nxt = step(state)
        if (int(nxt.niter) > int(state.niter) and torch.equal(nxt.basis, state.basis)
                and int(nxt.status) == int(minilp_tpu.Status.RUNNING)):
            flips += 1
        state = nxt
    return state, flips


def test_bound_flip_matches_reference():
    """Five boxed variables at their upper bounds and a cut that needs 2.5
    of their range: the entering variables flip to their lower bounds before
    the last one enters the basis (presolve off: it would fix them all)."""
    prob = minilp_tpu.Problem(_MAX, minilp_tpu.SolverOptions(presolve=False))
    xs = [prob.add_var(1.0 + 0.01 * k, (0.0, 1.0)) for k in range(5)]
    prob.add_constraint([(x, 1.0) for x in xs], _LE, 10.0)
    handle = _solved_handle(prob)
    ref_incremental._append_row(handle, np.ones(5), _LE, 2.5)
    ref, got = _both(handle)
    _assert_same_run(ref, got)
    assert int(got.status) == int(minilp_tpu.Status.OPTIMAL)
    stepped, flips = _run_counting_flips(handle)
    assert flips >= 1
    assert int(stepped.niter) == int(got.niter) and torch.equal(stepped.basis, got.basis)


@pytest.mark.parametrize("bland_after,enters", [(50, 1), (0, 0)])
def test_harris_pass_and_bland_match_reference(bland_after, enters):
    """min x0 + (2 + 1e-8)·x1 at x = 0, then the cut x0 + 2·x1 >= 1: the
    dual ratios are 1 and 1 + 5e-9, inside the relaxed step of pass 1, so
    pass 2 enters x1 (the larger |α|); under Bland (`bland_after=0`) the
    lowest index, x0, enters.  Presolve is off: it would fix both columns."""
    prob = minilp_tpu.Problem(options=minilp_tpu.SolverOptions(presolve=False))
    prob.add_var(1.0, (0.0, None))
    prob.add_var(2.0 + 1e-8, (0.0, None))
    handle = _solved_handle(prob)
    ref_incremental._append_row(handle, np.array([1.0, 2.0]), _GE, 1.0)
    ref, got = _both(handle, bland_after=bland_after)
    _assert_same_run(ref, got)
    assert int(got.status) == int(minilp_tpu.Status.OPTIMAL) and int(got.niter) == 1
    assert enters in got.basis.tolist() and (1 - enters) not in got.basis.tolist()


def test_infeasible_cut_matches_reference():
    """max x, x in [0, 10], x <= 5, then x >= 6: the dual is unbounded."""
    prob = minilp_tpu.Problem(_MAX)
    x = prob.add_var(1.0, (0.0, 10.0))
    prob.add_constraint([(x, 1.0)], _LE, 5.0)
    handle = _solved_handle(prob)
    ref_incremental._append_row(handle, np.ones(1), _GE, 6.0)
    ref, got = _both(handle)
    assert int(ref.status) == int(minilp_tpu.Status.INFEASIBLE)
    _assert_same_run(ref, got)


def test_dual_state_is_a_simplex_state():
    prob, rng = _optimal_random(*RANDOM[0])
    handle = _solved_handle(prob)
    _append_violated_row(handle, rng)
    _ref, got = _both(handle)
    assert isinstance(got, SimplexState)
    assert got.basis.dtype == torch.int64 and got.vstat.dtype == torch.int8
    assert got.niter.dtype == torch.int32 and int(got.phase) == 2
