"""The copied generators give the port's generators' LPs at the same seed."""

import numpy as np
import pytest

from lpbench.reference.lp import EQ, GE, LE
from lpbench.traffic import cold, scenario
from minilp_tpu_torch.utils.synth import netlib_shaped_problem, random_batch

OPS = {"<=": LE, "=": EQ, ">=": GE}


@pytest.mark.parametrize("shape", [(40, 100, 0.05), (821, 1571, 0.008)])
@pytest.mark.parametrize("seed", [0, 5, 2**31 + 3])
def test_netlib_arrays_match_netlib_shaped_problem(shape, seed):
    prob = netlib_shaped_problem(*shape, seed=seed)
    lp = cold.netlib_arrays(*shape, seed).row_lp()
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
