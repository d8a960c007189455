"""PyTorch port, the slice end to end: `Problem.solve()` in both packages.

The port runs on the CPU (`device="cpu"`) with the megakernel forced
("always": K1's plain version, then the host f64 check and polish) and
disabled ("never": the f64 torch engine); the reference runs its default
route.  Outcomes must match — the same exception for infeasible and
unbounded LPs, objectives within 1e-9 relative, certified solutions — and
the objective must be the known optimum.
"""

import dataclasses
import json

import numpy as np
import pytest

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu.utils.synth import netlib_shaped_problem

from .oracle import random_problem, solve_with_oracle
from .torch_helpers import HAND_CASES, as_torch_problem, rel_err

ROUTES = ["always", "never"]


def _check_outcome(ref_prob, route, expected=None):
    """Solve in both packages; returns the port's Solution (None if raised)."""
    port_prob = as_torch_problem(ref_prob, use_megakernel=route)
    try:
        ref_sol, ref_exc = ref_prob.solve(), None
    except minilp_tpu.Error as exc:
        ref_sol, ref_exc = None, exc
    if ref_exc is not None:
        with pytest.raises(getattr(minilp_tpu_torch, type(ref_exc).__name__)):
            port_prob.solve()
        assert expected in (None, type(ref_exc).__name__.lower())
        return None
    sol = port_prob.solve()
    assert sol._engine.certified
    assert rel_err(sol.objective(), ref_sol.objective()) <= 1e-9
    if expected is not None:
        assert rel_err(sol.objective(), expected) <= 1e-9
    x = np.array([v for _, v in sol.iter()])
    x_ref = np.array([v for _, v in ref_sol.iter()])
    assert x.shape == x_ref.shape
    return sol


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("name", sorted(HAND_CASES))
def test_hand_cases_match_reference(name, route):
    build, expected = HAND_CASES[name]
    _check_outcome(build(), route, expected)


@pytest.mark.parametrize("route", ROUTES)
@pytest.mark.parametrize("seed", range(12))
def test_random_lps_match_reference(seed, route):
    rng = np.random.default_rng(1000 + seed)
    prob = random_problem(rng, int(rng.integers(2, 12)), int(rng.integers(1, 14)))
    outcome, obj, _ = solve_with_oracle(prob)
    sol = _check_outcome(prob, route, obj if outcome == "optimal" else outcome)
    assert (sol is None) == (outcome != "optimal")


@pytest.mark.parametrize("route", ROUTES)
def test_medium_netlib_shaped_matches_reference(route):
    prob = netlib_shaped_problem(60, 150, 0.06, seed=11)
    outcome, obj, _ = solve_with_oracle(prob)
    assert outcome == "optimal"
    sol = _check_outcome(prob, route)
    assert rel_err(sol.objective(), obj) <= 1e-7
    assert sol._engine.iterations() > 0


def test_megakernel_route_records_event(tmp_path, monkeypatch):
    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    build, expected = HAND_CASES["simple_minimize_with_ge"]
    for route, event in (("always", "cold_solve_megakernel"), ("never", "cold_solve")):
        sol = as_torch_problem(build(), use_megakernel=route).solve()
        assert sol.objective() == pytest.approx(expected, abs=1e-12)
        assert json.loads(log.read_text().splitlines()[-1])["event"] == event


def test_unported_engines_raise():
    build, _ = HAND_CASES["doc_example_maximize"]
    with pytest.raises(NotImplementedError, match="Queue 1 item 9"):
        as_torch_problem(build(), engine="pdhg").solve()


def _wide_problem():
    """An LP whose padded form passes 2048 rows (spare row capacity), the
    size at which a cold solve starts with the crossover."""
    build, _ = HAND_CASES["simple_minimize_with_ge"]
    prob = build()
    prob.options = dataclasses.replace(prob.options, row_capacity_slack=2100,
                                       crossover="never")
    return prob


def test_crossover_route_not_ported():
    prob = as_torch_problem(_wide_problem(), row_capacity_slack=2100,
                            use_megakernel="never")
    with pytest.raises(NotImplementedError, match="crossover"):
        prob.solve()


def test_host_cold_route_above_2048_rows_matches_reference():
    ref_prob = _wide_problem()
    port = as_torch_problem(ref_prob, row_capacity_slack=2100, crossover="never",
                            use_megakernel="never")
    ref_sol, sol = ref_prob.solve(), port.solve()
    assert sol._engine.can.M > 2048
    assert sol._engine.certified
    assert rel_err(sol.objective(), ref_sol.objective()) <= 1e-12
    assert sol._engine.iterations() == ref_sol._engine.iterations()
