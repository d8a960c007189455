"""PyTorch port, degenerate LPs with duplicated rows (Netlib's degen class):
presolve merges rows with the same coefficients, and K1 (its plain version
on the CPU) then answers `Problem.solve()` as the plain reference
(`lpbench/reference`) and HiGHS do.

The merge is a recorded deviation from the JAX package's presolve, which
keeps every duplicate: two copies of a row make a basis that holds both
slacks out singular, and an f32 simplex pivots on the noise there.
"""

import numpy as np
import pytest

import minilp_tpu_torch
from lpbench.reference import ipm
from lpbench.reference.lp import EQ, GE, LE, RowLP
from minilp_tpu.utils import synth as ref_synth
from minilp_tpu_torch import ComparisonOp, Infeasible, SolverOptions
from minilp_tpu_torch.presolve import presolve_problem
from minilp_tpu_torch.utils import profiling, synth

from .oracle import solve_with_oracle
from .torch_helpers import rel_err

K1 = SolverOptions(device="cpu", use_megakernel="always")
SENSE = {ComparisonOp.Le: LE, ComparisonOp.Eq: EQ, ComparisonOp.Ge: GE}


def _row_lp(prob) -> RowLP:
    """The port's `Problem` as the reference's arrays (a minimization)."""
    A = np.zeros((prob.num_constraints, prob.num_vars))
    for i, (terms, _, _) in enumerate(prob._constraints):
        for j, a in terms:
            A[i, j] += a
    return RowLP(c=np.array(prob._obj), A=A,
                 sense=np.array([SENSE[op] for _, op, _ in prob._constraints]),
                 rhs=np.array([r for _, _, r in prob._constraints]),
                 lo=np.array(prob._lo), hi=np.array(prob._hi))


def _solve_counted(prob):
    """(objective or "infeasible", the solve's stage counters)."""
    profiling.reset_stages()
    try:
        obj = prob.solve().objective()
    except Infeasible:
        obj = "infeasible"
    return obj, profiling.stages(None)


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("shape", [(40, 100, 0.08), (60, 150, 0.06)])
def test_k1_answers_degenerate_lps_as_the_reference_and_highs(shape, seed):
    prob = synth.degenerate_problem(*shape, seed=seed, frac_dup_row=0.15)
    prob.options = K1
    assert presolve_problem(prob)[1].parallel_rows == int(0.15 * shape[0])
    obj, stages = _solve_counted(prob)
    assert stages["route.megakernel"] == 1 and "route.engine" not in stages
    assert stages["megakernel_pivots"] > 0
    ref = ipm.solve([_row_lp(prob)])[0]
    status, highs, _ = solve_with_oracle(
        ref_synth.degenerate_problem(*shape, seed=seed, frac_dup_row=0.15))
    assert ref.status == status == "optimal"
    assert rel_err(obj, highs) <= 1e-9 and rel_err(obj, ref.obj) <= 1e-9


#: each merge rule on two or three copies of the row x + 2y, x and y in
#: [0, 10] (its activity spans [0, 30]): the senses and right-hand sides
#: given, and the rows presolve keeps, or Infeasible
LE_, GE_, EQ_ = ComparisonOp.Le, ComparisonOp.Ge, ComparisonOp.Eq
MERGES = {
    "le_le_tighter": ([(LE_, 12.0), (LE_, 9.0)], [(LE_, 9.0)]),
    "ge_ge_tighter": ([(GE_, 4.0), (GE_, 7.0), (GE_, 5.0)], [(GE_, 7.0)]),
    "le_ge_equal": ([(LE_, 8.0), (GE_, 8.0 + 1e-12)], [(EQ_, 0.5 * (8.0 + (8.0 + 1e-12)))]),
    "le_ge_range_kept": ([(GE_, 3.0), (LE_, 8.0)], [(GE_, 3.0), (LE_, 8.0)]),
    "le_ge_empty": ([(LE_, 3.0), (GE_, 8.0)], Infeasible),
    "eq_eq_agree": ([(EQ_, 6.0), (EQ_, 6.0)], [(EQ_, 6.0)]),
    "eq_eq_disagree": ([(EQ_, 6.0), (EQ_, 6.5)], Infeasible),
    "eq_drops_held_inequalities": ([(LE_, 9.0), (EQ_, 6.0), (GE_, 2.0)], [(EQ_, 6.0)]),
    "eq_breaks_inequality": ([(EQ_, 6.0), (LE_, 5.0)], Infeasible),
}


@pytest.mark.parametrize("case", sorted(MERGES))
def test_presolve_merges_duplicated_rows(case):
    given, want = MERGES[case]
    prob = minilp_tpu_torch.Problem(minilp_tpu_torch.OptimizationDirection.Minimize, K1)
    x, y, z = (prob.add_var(1.0, (0.0, 10.0)) for _ in range(3))
    prob.add_constraint(x + z, LE_, 15.0)  # another row, never merged
    for op, rhs in given:
        prob.add_constraint(x + 2.0 * y, op, rhs)
    prob.add_constraint(2.0 * x + 4.0 * y, LE_, 20.0)  # a multiple: not merged
    if want is Infeasible:
        with pytest.raises(Infeasible):
            presolve_problem(prob)
        return
    red, stats = presolve_problem(prob)
    assert stats.parallel_rows == len(given) - len(want)
    assert stats.rows_out == len(want) + 2
    assert red._constraints[0] == ([(0, 1.0), (2, 1.0)], LE_, 15.0)
    assert red._constraints[-1] == ([(0, 2.0), (1, 4.0)], LE_, 20.0)
    assert [(op, rhs) for _, op, rhs in red._constraints[1:-1]] == want


def test_presolve_leaves_lps_without_duplicates_as_they_were(monkeypatch):
    """Without duplicated rows the merge changes nothing: the reduced LP is
    the one presolve gives without the merge (the JAX package's)."""
    from minilp_tpu_torch import presolve

    prob = synth.netlib_shaped_problem(60, 150, 0.06, seed=11)
    red, stats = presolve_problem(prob)
    assert stats.parallel_rows == 0
    monkeypatch.setattr(presolve, "_merge_parallel_rows", lambda *a: None)
    plain, _ = presolve_problem(prob)
    assert red._constraints == plain._constraints
    assert (red._lo, red._hi) == (plain._lo, plain._hi)


def test_a_false_k1_claim_is_declined_and_the_engine_answers():
    """Presolve off, the duplicated rows stay: K1's plain version claims
    other than optimal on this LP (its basis went singular), the claim is
    counted as declined, and the f64 engine gives the right answer."""
    shape, seed = (60, 150, 0.06), 0
    prob = synth.degenerate_problem(*shape, seed=seed)
    prob.options = SolverOptions(device="cpu", use_megakernel="always", presolve=False)
    obj, stages = _solve_counted(prob)
    assert stages["route.megakernel.declined"] == 1 and stages["route.engine"] == 1
    assert "presolve_parallel_rows" not in stages
    status, highs, _ = solve_with_oracle(ref_synth.degenerate_problem(*shape, seed=seed))
    assert status == "optimal" and rel_err(obj, highs) <= 1e-9


@pytest.mark.parametrize("max_iter", [40, 80])
def test_a_k1_max_iter_claim_is_declined_and_the_engine_answers(monkeypatch, max_iter):
    """K1 stopped by its pivot limit: K1's route polishes OPTIMAL claims
    only, as the JAX package's does, so the claim is counted as declined
    and the f64 engine gives the right answer."""
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs

    real = bs.megakernel_rows
    monkeypatch.setattr(bs, "megakernel_rows",
                        lambda *a, **kw: real(*a, **dict(kw, max_iter=max_iter)))
    shape, seed = (40, 100, 0.08), 0
    prob = synth.degenerate_problem(*shape, seed=seed)
    prob.options = K1
    obj, stages = _solve_counted(prob)
    assert stages["megakernel_pivots"] == max_iter
    assert stages["route.megakernel.declined"] == 1 and stages["route.engine"] == 1
    assert "route.megakernel.polished" not in stages
    status, highs, _ = solve_with_oracle(ref_synth.degenerate_problem(*shape, seed=seed))
    assert status == "optimal" and rel_err(obj, highs) <= 1e-9


@pytest.mark.parametrize("clustered", [False, True])
def test_the_driver_counts_a_k1_launch_on_a_cluster(monkeypatch, clustered):
    """`megakernel_cluster` counts each K1 solve whose launch ran in
    thread-block clusters, as `batched_simplex.cluster_launches` saw it (a
    one-LP launch on the card; the CPU's plain version runs none, so the
    patched call poses one)."""
    from minilp_tpu_torch.ops.kernels import batched_simplex as bs

    real = bs.megakernel_rows

    def rows(*a, **kw):
        out = real(*a, **kw)
        bs.cluster_launches += int(clustered)
        return out

    monkeypatch.setattr(bs, "megakernel_rows", rows)
    monkeypatch.setattr(bs, "cluster_launches", bs.cluster_launches)
    prob = synth.degenerate_problem(40, 100, 0.08, seed=0)
    prob.options = K1
    _, stages = _solve_counted(prob)
    assert stages["route.megakernel"] == 1
    assert stages.get("megakernel_cluster", 0) == int(clustered)


def test_the_jax_package_keeps_duplicated_rows():
    """The deviation, recorded: the reference's presolve keeps the 6 copies
    that the port's merges."""
    from minilp_tpu.presolve import presolve_problem as ref_presolve

    ref_out = ref_presolve(ref_synth.degenerate_problem(40, 100, 0.08, seed=0))[1].rows_out
    _, stats = presolve_problem(synth.degenerate_problem(40, 100, 0.08, seed=0))
    assert stats.parallel_rows == 6 and stats.rows_out == ref_out - 6
