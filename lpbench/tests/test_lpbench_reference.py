"""The plain reference agrees with SciPy's HiGHS, and its float32 control
does not."""

import numpy as np
import pytest
import torch
from scipy.optimize import linprog

from lpbench.reference import ipm
from lpbench.reference.lp import EQ, GE, LE, RowLP, standard_form, violation
from lpbench.traffic import cold, scenario


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
