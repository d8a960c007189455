"""The plain reference agrees with SciPy's HiGHS, and its float32 control
does not; its dependent rows are dropped, contradicting ones make the LP
infeasible, and an LP without them is solved bit for bit as before."""

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from lpbench.reference import ipm
from lpbench.reference.lp import EQ, GE, LE, RowLP, standard_form, violation
from lpbench.traffic import cold, scenario

#: Netlib degen2's shape: 444 rows, 534 columns, 9 nonzeros a row
DEGEN2 = (444, 534, 9 / 534)


def highs(lp):
    ub = lp.sense != EQ
    sign = np.where(lp.sense == GE, -1.0, 1.0)[ub]
    r = linprog(lp.c, A_ub=lp.A[ub] * sign[:, None], b_ub=lp.rhs[ub] * sign,
                A_eq=lp.A[lp.sense == EQ], b_eq=lp.rhs[lp.sense == EQ],
                bounds=[(None if not np.isfinite(a) else a, None if not np.isfinite(b) else b)
                        for a, b in zip(lp.lo, lp.hi)], method="highs")
    return {0: "optimal", 2: "infeasible"}[r.status], r.fun


def rel(a, b):
    return abs(a - b) / (1.0 + abs(b))


@pytest.mark.parametrize("seed", range(6))
def test_netlib_shaped_lps_match_highs(seed):
    lp = cold.netlib_arrays(60, 150, 0.05, seed).row_lp()
    status, fun = highs(lp)
    ans = ipm.solve([lp])[0]
    assert ans.status == status == "optimal"
    assert rel(ans.obj, fun) < 1e-9
    assert violation(lp, ans.x) < 1e-9


def test_scenario_lanes_match_highs_as_one_batch():
    batch = scenario.random_batch(3, 24, 8, 24)
    lps = [scenario.lane_lp(batch, i) for i in range(24)]
    answers = ipm.solve(lps)
    for lp, ans in zip(lps, answers):
        status, fun = highs(lp)
        assert ans.status == status == "optimal"
        assert rel(ans.obj, fun) < 1e-9


def test_an_infeasible_cut_is_found_infeasible():
    lp = cold.netlib_arrays(40, 100, 0.05, 1).row_lp()
    _status, fun = highs(lp)
    # c·x <= optimum − 1 cuts off every feasible point
    cut = lp.with_row(lp.c.copy(), LE, fun - 1.0)
    assert highs(cut)[0] == "infeasible"
    assert ipm.solve([cut])[0].status == "infeasible"


def test_fixed_free_and_upper_bounded_columns():
    rng = np.random.default_rng(4)
    A = rng.normal(size=(6, 10))
    x0 = rng.uniform(0.2, 0.8, size=10)
    lo = np.zeros(10)
    hi = np.ones(10)
    lo[0] = hi[0] = 0.5           # fixed
    lo[1], hi[1] = -np.inf, np.inf  # free
    lo[2], hi[2] = -np.inf, 2.0     # bounded above only
    lp = RowLP(c=rng.normal(size=10), A=A, sense=np.array([LE, GE, EQ, LE, GE, LE]),
               rhs=A @ np.clip(x0, lo, hi) + np.array([0.3, -0.3, 0.0, 0.2, -0.2, 0.1]),
               lo=lo, hi=hi)
    lp.c[1] = 0.0  # keep the free column from making it unbounded
    s = standard_form(lp)
    assert s.A.shape[1] == 9 + 1 + 5  # 9 columns kept, the free one split, 5 slacks
    status, fun = highs(lp)
    ans = ipm.solve([lp])[0]
    assert ans.status == status
    assert rel(ans.obj, fun) < 1e-8


def test_float32_control_is_far_from_the_f64_reference():
    gaps = []
    for seed in range(3):
        lp = cold.netlib_arrays(200, 400, 0.02, seed).row_lp()
        f64, f32 = ipm.solve([lp])[0], ipm.solve([lp], dtype=torch.float32)[0]
        gaps.append(max(rel(f32.obj, f64.obj), violation(lp, f32.x)))
    assert min(gaps) > 1e-7


def dropped(lp, dtype=torch.float64):
    """Rows the reference drops from `lp`'s standard form; None where it
    finds the LP infeasible."""
    s = standard_form(lp)
    kept = ipm.independent_rows(s, lp.sense == EQ, dtype)
    return None if kept is None else s.A.shape[0] - kept.A.shape[0]


@pytest.mark.parametrize("shape, seed", [((60, 150, 0.05), seed) for seed in range(6)]
                         + [(DEGEN2, seed) for seed in range(2)])
def test_degenerate_lps_match_highs(shape, seed):
    lp = cold.degenerate_arrays(*shape, seed).row_lp()
    assert dropped(lp) > 0  # copies of equality rows
    status, fun = highs(lp)
    ans = ipm.solve([lp])[0]
    assert ans.status == status == "optimal"
    assert rel(ans.obj, fun) < 1e-9
    assert violation(lp, ans.x) < 1e-9


@pytest.mark.parametrize("shift", [0.0, 1e-3, 1.0])
def test_a_duplicated_equality_row_is_dropped_or_contradicts(shift):
    lp = cold.netlib_arrays(40, 100, 0.05, 1).row_lp()
    i = int(np.flatnonzero(lp.sense == EQ)[0])
    dup = lp.with_row(lp.A[i].copy(), EQ, lp.rhs[i] + shift)
    status, fun = highs(dup)
    ans = ipm.solve([dup])[0]
    assert ans.status == status
    if shift:
        assert status == "infeasible" and dropped(dup) is None
    else:
        assert dropped(dup) == 1
        assert rel(ans.obj, fun) < 1e-9 and violation(dup, ans.x) < 1e-9


def _row_lp(prob):
    """A `minilp_tpu_torch` Problem's rows as a RowLP."""
    ops = {"<=": LE, "=": EQ, ">=": GE}
    A = np.zeros((prob.num_constraints, prob.num_vars))
    for i, (terms, _op, _rhs) in enumerate(prob._constraints):
        for j, coeff in terms:
            A[i, j] += coeff
    return RowLP(c=np.array(prob._obj), A=A,
                 sense=np.array([ops[op.value] for _t, op, _r in prob._constraints]),
                 rhs=np.array([rhs for _t, _op, rhs in prob._constraints]),
                 lo=np.array(prob._lo), hi=np.array(prob._hi))


@pytest.mark.parametrize("seed", range(10))
def test_near_parallel_rows_are_kept(seed):
    """`ill_conditioned_problem`'s rows scaled and perturbed by 1e-7 are
    independent, and the reference keeps them.  Where two of them are both
    equalities (seeds 0, 5 and 7), the optimum moves by about 1e-3 under a
    residual of 1e-9 along the pair, inside HiGHS's feasibility tolerance
    (1e-7), so neither solver fixes the objective to 1e-9: there only the
    status and the answer's feasibility are compared."""
    from minilp_tpu_torch.utils.synth import ill_conditioned_problem

    lp = _row_lp(ill_conditioned_problem(60, 150, 0.05, seed=seed, parallel_eps=1e-7))
    assert dropped(lp) == 0
    eq = lp.A[lp.sense == EQ] != 0
    equal_pair = len({r.tobytes() for r in eq}) < len(eq)  # a pair keeps its pattern
    status, fun = highs(lp)
    ans = ipm.solve([lp])[0]
    assert ans.status == status == "optimal"
    assert violation(lp, ans.x) < 1e-9
    if not equal_pair:
        assert rel(ans.obj, fun) < 1e-9


def failed_factors(monkeypatch) -> list:
    """The number of LPs whose Cholesky factor failed, a call each."""
    failed = []
    cholesky = torch.linalg.cholesky_ex

    def spy(M):
        L, info = cholesky(M)
        failed.append(int((info != 0).sum()))
        return L, info

    monkeypatch.setattr(torch.linalg, "cholesky_ex", spy)
    return failed


def test_a_failed_factor_is_solved_through_eigenvectors(monkeypatch):
    """degen2-shaped seed 15 loses its Cholesky factor near the optimum; the
    IPM goes on and converges (it used to stop there, at a merit of 4.8e-9)."""
    lp = cold.degenerate_arrays(*DEGEN2, 15).row_lp()
    s = ipm.independent_rows(standard_form(lp), lp.sense == EQ, torch.float64)
    failed = failed_factors(monkeypatch)
    A, b, c, u = (torch.as_tensor(a[None]) for a in (s.A, s.b, s.c, s.u))
    _x, converged, merit = ipm.ipm(A, b, c, u)
    assert sum(failed) > 0
    assert bool(converged[0]) and float(merit[0]) < torch.finfo(torch.float64).eps ** 0.6


@pytest.mark.parametrize("shape, seeds", [((60, 150, 0.05), range(4)),
                                          ((821, 1571, 0.008), range(2))])
def test_lps_without_dependent_rows_are_solved_as_before(shape, seeds, monkeypatch):
    """The answers are those of the path without the row step, bit for bit,
    also beside a degenerate LP in the same call; no Cholesky factor fails,
    so the eigenvector path does not run."""
    lps = [cold.netlib_arrays(*shape, seed).row_lp() for seed in seeds]
    failed = failed_factors(monkeypatch)
    degenerate = cold.degenerate_arrays(60, 150, 0.05, 0).row_lp()
    repaired = ipm.solve(lps + [degenerate])[:len(lps)]
    failed.clear()
    monkeypatch.setattr(ipm, "independent_rows", lambda s, eq, dtype: s)
    plain = ipm.solve(lps)
    assert sum(failed) == 0
    for a, b in zip(repaired, plain):
        assert a.status == b.status == "optimal" and a.obj == b.obj
        np.testing.assert_array_equal(a.x, b.x)


@pytest.mark.parametrize("shape, seed", [((60, 150, 0.05), seed) for seed in range(6)]
                         + [(DEGEN2, seed) for seed in range(2)])
def test_float32_control_fails_on_degenerate_lps(shape, seed):
    """The control drops the same rows, and breaks the limits that a cell
    sets as `25fv47-cold` does: `primal_viol` 1e-9 or `obj_gap` 1e-7."""
    lp = cold.degenerate_arrays(*shape, seed).row_lp()
    assert dropped(lp, torch.float32) == dropped(lp)
    f64, f32 = ipm.solve([lp])[0], ipm.solve([lp], dtype=torch.float32)[0]
    assert f64.status == "optimal"
    if f32.status == "optimal":
        gap = max(rel(f32.obj, f64.obj), rel(float(lp.c @ f32.x), f64.obj))
        assert gap > 1e-7 or violation(lp, f32.x) > 1e-9
