"""The copied generators give the port's generators' LPs at the same seed."""

import numpy as np
import pytest

from lpbench import spec
from lpbench.reference.lp import EQ, GE, LE
from lpbench.traffic import cold, scenario
from minilp_tpu_torch.utils.synth import degenerate_problem, netlib_shaped_problem, random_batch

OPS = {"<=": LE, "=": EQ, ">=": GE}


def assert_same_lp(lp, prob):
    np.testing.assert_array_equal(lp.c, prob._obj)
    np.testing.assert_array_equal(lp.lo, prob._lo)
    np.testing.assert_array_equal(lp.hi, prob._hi)
    assert lp.A.shape == (prob.num_constraints, prob.num_vars)
    for i, (terms, op, rhs) in enumerate(prob._constraints):
        row = np.zeros(prob.num_vars)
        for j, coeff in terms:
            row[j] += coeff
        np.testing.assert_array_equal(lp.A[i], row)
        assert lp.sense[i] == OPS[op.value] and lp.rhs[i] == rhs


@pytest.mark.parametrize("shape", [(40, 100, 0.05), (821, 1571, 0.008)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_netlib_arrays_match_netlib_shaped_problem(shape, seed):
    assert_same_lp(cold.netlib_arrays(*shape, seed).row_lp(),
                   netlib_shaped_problem(*shape, seed=seed))


@pytest.mark.parametrize("shape", [(40, 100, 0.05), (444, 534, 9 / 534)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_degenerate_arrays_match_degenerate_problem(shape, seed):
    prob = degenerate_problem(*shape, seed=seed)
    inst = cold.degenerate_arrays(*shape, seed)
    assert_same_lp(inst.row_lp(), prob)
    for cols, vals, (terms, _op, _rhs) in zip(inst.cols, inst.vals, prob._constraints):
        assert [(int(j), v) for j, v in zip(cols, vals)] == list(terms)  # the API's terms


def test_the_configuration_chooses_the_generator():
    shape = {"rows": 40, "cols": 100, "density": 0.05}
    params = {"pool": 4, "pool_seed": 9}
    order = cold.prepare({"shape": shape}, params, 3)
    key = [9, order[2], 0]
    ours = cold.instance({"generator": "degenerate", "shape": dict(shape, frac_dup_row=0.25)},
                         params, order, 2).row_lp()
    assert_same_lp(ours, degenerate_problem(40, 100, 0.05, seed=key, frac_dup_row=0.25))
    plain = cold.instance({"generator": "netlib_shaped", "shape": shape}, params, order, 2)
    assert_same_lp(plain.row_lp(), netlib_shaped_problem(40, 100, 0.05, seed=key))


def test_the_25fv47_pool_is_netlib_arrays_bit_for_bit():
    """No `generator` key: every LP of the pool and the warm-up's are
    `netlib_arrays`', and `row_lp` builds A as it always did."""
    cell = spec.cell("25fv47-cold")
    assert "generator" not in cell.config
    shape, params = cell.config["shape"], cell.traffic["params"]
    order = cold.prepare(cell.config, params, 2**31 + 9)
    for i in range(-1, params["pool"]):
        key = [params["pool_seed"], order[i], 0] if i >= 0 else [params["pool_seed"], 0, 1]
        got = cold.instance(cell.config, params, order, i)
        want = cold.netlib_arrays(shape["rows"], shape["cols"], shape["density"], key)
        for field in ("obj", "hi", "cols", "vals", "sense", "rhs"):
            a, b = getattr(got, field), getattr(want, field)
            assert a.dtype == b.dtype and a.shape == b.shape and np.array_equal(a, b)
        m, k = want.cols.shape
        A = np.zeros((m, shape["cols"]))
        np.add.at(A, (np.repeat(np.arange(m), k), want.cols.ravel()), want.vals.ravel())
        np.testing.assert_array_equal(got.row_lp().A, A)


@pytest.mark.parametrize("seed", [0, 7, 2**31 + 11])
def test_random_batch_matches_the_port(seed):
    ours, port = scenario.random_batch(seed, 16, 8, 24), random_batch(seed, 16, 8, 24)
    for a, b in zip(ours, port):
        np.testing.assert_array_equal(a, b)


def test_every_seed_gets_the_pool_in_its_own_order():
    config = {"shape": {"rows": 20, "cols": 50, "density": 0.1}}
    params = {"pool": 8, "pool_seed": 3}
    one, two = cold.prepare(config, params, 2**31 + 5), cold.prepare(config, params, 6)
    assert sorted(one) == sorted(two) == list(range(8)) and one != two
    objs = [cold.instance(config, params, one, i).obj for i in range(8)]
    assert len({o.tobytes() for o in objs}) == 8  # distinct within a pass
    again = cold.instance(config, params, two, two.index(one[0]))
    np.testing.assert_array_equal(objs[0], again.obj)  # the same LP in another order
    assert not np.array_equal(cold.instance(config, params, one, -1).obj, objs[0])
