"""PyTorch port, the incremental re-solve API against the JAX package's.

Every scenario of `tests/test_incremental.py` runs through both packages edit
by edit (`Pair`): the same LP solved in each, then the same
`add_constraint` / `fix_var` / `unfix_var` / `add_gomory_cut` on both.  After
every edit both give the same outcome (the same exception class, or a
solution), the same solve-record event and, where a solution comes back, a
certified objective and every variable's value within 1e-9 relative, and the
same `changed` flag from `unfix_var`.

Routes (the port on the CPU, `device="cpu"`):
- "host", the default options: both packages run the same `hostlp` code,
  so the pivot counts (`iterations()`) and final bases are equal too;
- "engine": the host resolver declines (both packages' `solve_host_dual`
  and `solve_host_sparse` return None), so the f64 engines run
  (`resolve_dual` / warm `solve_canonical`) and must take the reference's
  pivot sequence;
- "megakernel", `use_megakernel="always"`: the reference's Pallas K1 in
  interpret mode against the port's `simplex_plain`, warm; f32 iterates, so
  status, the certified flag and the objective are held, not the pivots;
- "streaming", `use_streaming="always"`: the Pallas K2 (interpret mode)
  against `stream_plain`, warm, on one small instance (the reference pads
  rows to 128).
Also: warm state carried across packages through the `.npz` checkpoint.
"""

import math

import numpy as np
import pytest

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu.engine import hostlp as ref_hostlp
from minilp_tpu.utils import checkpoint as ref_checkpoint
from minilp_tpu.utils import records as ref_records
from minilp_tpu.utils.synth import netlib_shaped_problem
from minilp_tpu_torch.engine import hostlp
from minilp_tpu_torch.utils import checkpoint, records
from minilp_tpu_torch.utils.node_chain import highs_outcome, run_chain

from .oracle import random_problem, solve_with_oracle
from .torch_helpers import as_torch_problem, rel_err

_MAX = minilp_tpu.OptimizationDirection.Maximize
_LE, _GE = minilp_tpu.ComparisonOp.Le, minilp_tpu.ComparisonOp.Ge
Var = minilp_tpu.Variable

#: route -> the options both packages take
ROUTES = {
    "host": {},
    "engine": {},
    "megakernel": {"use_megakernel": "always"},
    "streaming": {"use_streaming": "always", "use_megakernel": "never"},
}
#: the events each route's re-solves record
EVENTS = {route: {edit + suffix for edit in ("dual_resolve", "primal_resolve")}
          for route, suffix in (("host", "_host"), ("engine", ""),
                                ("megakernel", "_megakernel"), ("streaming", "_streaming"))}


def _port_arg(a):
    """An argument of a reference edit in the port's terms."""
    if isinstance(a, minilp_tpu.Variable):
        return minilp_tpu_torch.Variable(a.idx)
    if isinstance(a, minilp_tpu.LinearExpr):
        return minilp_tpu_torch.LinearExpr(
            [(c, minilp_tpu_torch.Variable(i)) for i, c in a.terms()])
    if isinstance(a, minilp_tpu.ComparisonOp):
        return minilp_tpu_torch.ComparisonOp(a.value)
    return a


class Pair:
    """One LP solved in both packages and edited in lockstep; every edit is
    held to the reference (module docstring)."""

    def __init__(self, route, ref_prob, events):
        self.route, self.events = route, events
        ref_prob.options = minilp_tpu.SolverOptions(**ROUTES[route])
        port_prob = as_torch_problem(ref_prob, **ROUTES[route])
        self.ref, self.port = ref_prob.solve(), port_prob.solve()
        self.resolves = 0
        self._check(None)

    def _check(self, event):
        ref, port = self.ref, self.port
        assert port._engine.certified == ref._engine.certified
        assert rel_err(port.objective(), ref.objective()) <= 1e-9
        if self.route in ("host", "engine"):
            # the same f64 code or engine: the same pivots and basis
            assert port._engine.iterations() == ref._engine.iterations()
            np.testing.assert_array_equal(np.asarray(port._engine._state.basis),
                                          np.asarray(ref._engine._state.basis))
        if event is None or self.route in ("host", "engine"):
            # f32 kernels may stop at another optimal vertex
            for (_, got), (_, want) in zip(port.iter(), ref.iter()):
                assert rel_err(got, want) <= 1e-9
        if event is not None:
            assert event in EVENTS[self.route], event

    def edit(self, method, *args):
        """Apply one edit to both; returns the reference's result, or the
        exception class both raised."""
        n_ref, n_port = len(self.events["ref"]), len(self.events["port"])
        try:
            want = getattr(self.ref, method)(*args)
        except minilp_tpu.Error as exc:
            with pytest.raises(getattr(minilp_tpu_torch, type(exc).__name__)):
                getattr(self.port, method)(*map(_port_arg, args))
            assert self.events["port"][n_port:] == self.events["ref"][n_ref:]
            return type(exc)
        got = getattr(self.port, method)(*map(_port_arg, args))
        if method == "unfix_var":
            assert got[0] == want[0], "unfix_var's changed flag"
            (self.ref, self.port), want = (want[1], got[1]), want
        else:
            self.ref, self.port = want, got
        new = self.events["ref"][n_ref:]
        assert self.events["port"][n_port:] == new
        assert len(new) == 1, new
        self.resolves += 1
        self._check(new[0])
        return want

    def values(self):
        return [(var, v) for var, v in self.ref.iter()]


@pytest.fixture
def events(tmp_path, monkeypatch):
    """Each package's solve-record events, in order."""
    monkeypatch.setenv("MINILP_TPU_LOG", str(tmp_path / "records.jsonl"))
    seen = {"ref": [], "port": []}
    monkeypatch.setattr(ref_records, "emit", lambda r: seen["ref"].append(r.event))
    monkeypatch.setattr(records, "emit", lambda r: seen["port"].append(r.event))
    return seen


@pytest.fixture
def decline_host(monkeypatch):
    """Make both packages' host resolvers decline."""
    def install():
        for mod in (ref_hostlp, hostlp):
            monkeypatch.setattr(mod, "solve_host_dual", lambda *a, **k: None)
            monkeypatch.setattr(mod, "solve_host_sparse", lambda *a, **k: None)
    return install


# -- the scenarios of tests/test_incremental.py ---------------------------------

def _tighten(pair_of):
    prob = minilp_tpu.Problem(_MAX)
    x, y = prob.add_var(1.0, (0.0, 3.0)), prob.add_var(1.0, (0.0, 3.0))
    prob.add_constraint(x + y, _LE, 4.0)
    pair = pair_of(prob)
    pair.edit("add_constraint", 1.0 * x, _LE, 1.0)
    pair.edit("add_constraint", 1.0 * y, _LE, 2.0)
    assert rel_err(pair.port.objective(), 3.0) <= 1e-9
    return pair


def _infeasible_cut(pair_of):
    prob = minilp_tpu.Problem(_MAX)
    x = prob.add_var(1.0, (0.0, 10.0))
    prob.add_constraint(1.0 * x, _LE, 5.0)
    pair = pair_of(prob)
    assert pair.edit("add_constraint", 1.0 * x, _GE, 6.0) is minilp_tpu.Infeasible
    return pair


def _growth(pair_of):
    prob = minilp_tpu.Problem(_MAX)
    x, y = prob.add_var(1.0, (0.0, 100.0)), prob.add_var(1.0, (0.0, 100.0))
    prob.add_constraint(x + y, _LE, 100.0)
    pair = pair_of(prob)
    M0 = pair.port._engine.can.M
    for k in range(20):
        pair.edit("add_constraint", x + y, _LE, 90.0 - 4.0 * k)
        assert rel_err(pair.port.objective(), 90.0 - 4.0 * k) <= 1e-9
    assert pair.port._engine.can.M > M0  # grown past the padding
    assert pair.port._engine.can.M == pair.ref._engine.can.M
    return pair


def _fix_and_unfix(pair_of):
    prob = minilp_tpu.Problem(_MAX)
    x, y = prob.add_var(1.0, (0.0, 3.0)), prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, _LE, 4.0)
    pair = pair_of(prob)
    pair.edit("fix_var", y, 1.0)
    assert pair.edit("unfix_var", y)[0]
    pair.edit("fix_var", x, 1.0)
    assert not pair.edit("unfix_var", x)[0]
    return pair


def _fix_infeasible(pair_of):
    prob = minilp_tpu.Problem()
    x, y = prob.add_var(1.0, (0.0, 10.0)), prob.add_var(1.0, (0.0, 10.0))
    prob.add_constraint(x + y, _LE, 5.0)
    pair = pair_of(prob)
    assert pair.edit("fix_var", x, 7.0) is minilp_tpu.Infeasible
    return pair


def _fix_basic(pair_of):
    prob = minilp_tpu.Problem()
    x, y = prob.add_var(1.0, (0.0, None)), prob.add_var(1.0, (0.0, None))
    prob.add_constraint(x + 2 * y, _GE, 4.0)
    prob.add_constraint(3 * x + y, _GE, 6.0)
    pair = pair_of(prob)
    pair.edit("fix_var", x, 0.0)
    assert rel_err(pair.port.objective(), 6.0) <= 1e-9
    assert pair.edit("unfix_var", x)[0]
    return pair


def _warm_cost(pair_of):
    prob = random_problem(np.random.default_rng(42), 30, 25, density=0.7)
    assert solve_with_oracle(prob)[0] == "optimal"
    pair = pair_of(prob)
    cold = pair.port._engine.iterations()
    vs = pair.values()[:5]
    cur = sum(v for _, v in vs)
    expr = sum((1.0 * var for var, _ in vs[1:]), start=1.0 * vs[0][0])
    pair.edit("add_constraint", expr, _LE, cur + 1.0)
    assert pair.port._engine.iterations() <= max(3, cold // 4)
    return pair


def _oracle_after_edits(pair_of):
    rng = np.random.default_rng(7)
    pairs = []
    for _trial in range(5):
        prob = random_problem(rng, 8, 6)
        if solve_with_oracle(prob)[0] != "optimal":
            continue
        pair = pair_of(prob)
        coeffs = rng.normal(size=prob.num_vars)
        xcur = np.array([v for _, v in pair.values()])
        rhs = float(coeffs @ xcur - 0.5)
        expr = minilp_tpu.LinearExpr([(float(coeffs[j]), Var(j)) for j in range(prob.num_vars)])
        prob.add_constraint(expr, _GE, rhs)  # the extended cold problem
        outcome, obj, _ = solve_with_oracle(prob)
        got = pair.edit("add_constraint", expr, _GE, rhs)
        if outcome == "optimal":
            assert rel_err(pair.port.objective(), obj) <= 1e-6
        else:
            assert got is getattr(minilp_tpu, outcome.capitalize())
        pairs.append(pair)
    assert pairs
    return pairs[-1]


def _is_frac(v, tol=1e-6):
    return min(v - math.floor(v), math.ceil(v) - v) > tol


def _gomory(pair_of):
    prob = minilp_tpu.Problem(_MAX)
    x1, x2 = prob.add_var(5.0, (0.0, 10.0)), prob.add_var(4.0, (0.0, 10.0))
    prob.add_constraint(6 * x1 + 4 * x2, _LE, 24.0)
    prob.add_constraint(x1 + 2 * x2, _LE, 6.0)
    pair = pair_of(prob)
    for _round in range(20):
        frac = [var for var, v in pair.values() if _is_frac(v)]
        if not frac:
            break
        pair.edit("add_gomory_cut", frac[0])
    assert not any(_is_frac(v) for _, v in pair.port.iter())
    assert rel_err(pair.port.objective(), 20.0) <= 1e-6
    return pair


def _branch_and_bound(pair_of):
    prob = minilp_tpu.Problem(_MAX)
    a, b, c = (prob.add_var(obj, (0.0, 1.0)) for obj in (10.0, 6.0, 4.0))
    prob.add_constraint(a + b + c, _LE, 2.0)
    pair = pair_of(prob)
    best = [-math.inf]

    def branch(depth):
        frac = [var for var, v in pair.values() if _is_frac(v)]
        if not frac:
            best[0] = max(best[0], pair.ref.objective())
            return
        if pair.ref.objective() <= best[0] + 1e-9:
            return
        var = frac[0]
        for val in (1.0, 0.0):
            if pair.edit("fix_var", var, val) is minilp_tpu.Infeasible:
                continue
            branch(depth + 1)
            pair.edit("unfix_var", var)

    branch(0)
    assert rel_err(best[0], 16.0) <= 1e-6
    return pair


def _csc_invalidated(pair_of):
    prob = netlib_shaped_problem(24, 60, 0.2, seed=3)
    pair = pair_of(prob)
    h = pair.port._engine
    csc0 = h.can.csc()
    assert h.can.csc() is csc0  # cached
    pair.edit("add_constraint", minilp_tpu.LinearExpr([(1.0, Var(0))]), _LE,
              pair.ref[Var(0)] + 1.0)
    assert h.can.csc() is not csc0  # invalidated by the row write
    np.testing.assert_array_equal(h.can.csc().toarray(), h.can.A)
    return pair


SCENARIOS = {
    "tighten": _tighten,
    "infeasible_cut": _infeasible_cut,
    "growth_20_cuts": _growth,
    "fix_and_unfix": _fix_and_unfix,
    "fix_infeasible": _fix_infeasible,
    "fix_basic": _fix_basic,
    "warm_cost": _warm_cost,
    "oracle_after_edits": _oracle_after_edits,
    "gomory_progression": _gomory,
    "branch_and_bound": _branch_and_bound,
    "csc_invalidated": _csc_invalidated,
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_default_route_matches_reference(name, events):
    pair = SCENARIOS[name](lambda prob: Pair("host", prob, events))
    assert pair.resolves == 0 or any(e.endswith("_host") for e in events["port"])


@pytest.mark.parametrize("name", ["tighten", "infeasible_cut", "growth_20_cuts",
                                  "fix_and_unfix", "fix_basic", "gomory_progression",
                                  "oracle_after_edits"])
def test_f64_engine_route_matches_reference(name, events, decline_host):
    """The host resolver declines: the dual and primal engines re-solve in
    both packages and take the same pivot sequence (iterations and basis,
    held by `Pair`).  Their states keep B⁻¹, so the 20 cuts also take the
    analytic row of `_append_row` and the identity block of a grown form."""
    decline_host()
    SCENARIOS[name](lambda prob: Pair("engine", prob, events))
    engine = [e for e in events["port"] if e in ("dual_resolve", "primal_resolve")]
    assert "dual_resolve" in engine


@pytest.mark.parametrize("name", ["tighten", "fix_basic", "growth_20_cuts"])
def test_forced_k1_route_matches_reference(name, events):
    """use_megakernel="always": re-solves launch K1 warm (Pallas in
    interpret mode; the port's `simplex_plain` on the CPU)."""
    SCENARIOS[name](lambda prob: Pair("megakernel", prob, events))
    assert events["port"][0] == "cold_solve_megakernel"
    assert "dual_resolve_megakernel" in events["port"]


def test_forced_k2_route_matches_reference(events):
    """use_streaming="always": re-solves launch K2 warm (Pallas in interpret
    mode; the port's `stream_plain` on the CPU), at M = 8."""
    _tighten(lambda prob: Pair("streaming", prob, events))
    assert events["port"] == ["cold_solve_streaming"] + ["dual_resolve_streaming"] * 2


def test_append_row_keeps_the_warm_inverse_exact():
    """`_append_row`'s analytic B⁻¹ row (e_i − vᵀB⁻¹) and the identity block
    of a grown form keep B⁻¹·B = I, and equal the reference's patch."""
    from minilp_tpu.engine import incremental as ref_incremental
    from minilp_tpu_torch.engine import incremental

    rng = np.random.default_rng(3)
    prob = netlib_shaped_problem(20, 40, 0.2, seed=3)
    ref, port = prob.solve()._engine, as_torch_problem(prob).solve()._engine
    ref.ensure_binv()
    port.ensure_binv()
    M0 = port.can.M
    for k in range(port.can.M - port.can.m + 2):  # through the growth
        coeffs = rng.normal(size=prob.num_vars)
        ref_incremental._append_row(ref, coeffs, _LE, 1.0)
        incremental._append_row(port, coeffs, minilp_tpu_torch.ComparisonOp.Le, 1.0)
        assert not port.binv_stale
        B = port.can.A[:, np.asarray(port.state.basis)]
        np.testing.assert_allclose(port.state.Binv @ B, np.eye(port.can.M), atol=1e-9)
        np.testing.assert_allclose(port.state.Binv, np.asarray(ref.state.Binv), atol=1e-12)
    assert port.can.M > M0


# -- warm state across packages -------------------------------------------------

def _tighten_problem():
    prob = minilp_tpu.Problem(_MAX)
    x, y = prob.add_var(1.0, (0.0, 3.0)), prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, _LE, 4.0)
    return prob, x


def test_reference_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX package's `save_state` of its handle's state, read by the
    port's `load_state` into the port's handle of the same LP: the same
    `add_constraint` then gives the same outcome, objective and pivots."""
    rng = np.random.default_rng(8)
    prob = random_problem(rng, 30, 20, density=0.6)
    assert solve_with_oracle(prob)[0] == "optimal"
    ref = prob.solve()
    port = as_torch_problem(prob).solve()
    path = str(tmp_path / "ref_state.npz")
    ref_checkpoint.save_state(path, ref._engine.state)
    port._engine.state = checkpoint.load_state(path)
    assert not port._engine.binv_stale
    coeffs = rng.normal(size=prob.num_vars)
    rhs = float(coeffs @ np.array([v for _, v in ref.iter()])) - 0.5
    expr = [(Var(j), float(coeffs[j])) for j in range(prob.num_vars)]
    want = ref.add_constraint(expr, _LE, rhs)
    got = port.add_constraint([(minilp_tpu_torch.Variable(j), c) for j, c in
                               ((v.idx, c) for v, c in expr)],
                              minilp_tpu_torch.ComparisonOp.Le, rhs)
    assert got._engine.certified and want._engine.certified
    assert rel_err(got.objective(), want.objective()) <= 1e-9
    assert got._engine.iterations() == want._engine.iterations() > 0


def test_port_checkpoint_roundtrip_and_resume(tmp_path):
    """The port's own `save_state` / `load_state`, as tests/test_checkpoint.py
    holds the reference's: the fields round-trip and the incremental API
    resumes from the restored state."""
    prob, x = _tighten_problem()
    sol = as_torch_problem(prob).solve()
    path = str(tmp_path / "state.npz")
    checkpoint.save_state(path, sol._engine.state)
    restored = checkpoint.load_state(path)
    for f in restored._fields:
        np.testing.assert_array_equal(np.asarray(getattr(restored, f)),
                                      np.asarray(getattr(sol._engine.state, f)), err_msg=f)
    sol._engine.state = restored
    sol2 = sol.add_constraint(1.0 * _port_arg(x), minilp_tpu_torch.ComparisonOp.Le, 0.5)
    assert abs(sol2.objective() - 6.5) < 1e-9


def test_port_checkpoint_refuses_a_lazy_inverse(tmp_path):
    prob, _x = _tighten_problem()
    sol = as_torch_problem(prob, use_megakernel="always").solve()
    assert sol._engine.binv_stale  # K1's certified state leaves B⁻¹ lazy
    with pytest.raises(ValueError, match="materializes"):
        checkpoint.save_state(str(tmp_path / "s.npz"), sol._engine._state)


# -- the node chain of chip_smoke.py phase 6, at a small size --------------------

@pytest.mark.parametrize("route,suffix", [("host", "_host"), ("megakernel", "_megakernel"),
                                          ("streaming", "_streaming")])
def test_node_chain_on_the_cpu(route, suffix, tmp_path, monkeypatch):
    """`utils/node_chain.run_chain` as phase 6 drives it, on the port alone:
    6 cuts, fix, unfix and a Gomory cut, each node certified, recorded on
    the route's event and within 1e-9 relative of HiGHS on the edited LP."""
    log = tmp_path / "records.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    prob = as_torch_problem(netlib_shaped_problem(60, 150, 0.06, seed=11), **ROUTES[route])
    nodes = run_chain(prob.solve(), log_path=log)
    assert [n.edit for n in nodes] == ["add_constraint"] * 6 + ["fix_var", "unfix_var",
                                                                "add_gomory_cut"]
    for n in nodes:
        outcome, want = highs_outcome(n.problem)
        assert n.outcome == outcome == "optimal" and n.certified
        assert rel_err(n.objective, want) <= 1e-9
        edit = "primal_resolve" if n.edit == "unfix_var" else "dual_resolve"
        assert n.events == [edit + suffix]
        assert n.pivots >= 0 and n.wall_s > 0 and "certify_s" in n.stages


@pytest.mark.parametrize("route", ["megakernel", "streaming"])
def test_warm_start_takes_a_fortran_ordered_inverse(route):
    """Above 1024 padded rows `ensure_binv` builds B⁻¹ from the sparse LU's
    solve, a Fortran-ordered array; the kernels' warm starts upload it in
    C order (the wrappers refuse a non-contiguous tensor)."""
    import scipy.sparse as sp
    import scipy.sparse.linalg as spl

    from minilp_tpu_torch.engine import driver

    prob = as_torch_problem(netlib_shaped_problem(40, 100, 0.08, seed=2), **ROUTES[route])
    handle = prob.solve()._engine
    can = handle.can
    basis = np.asarray(handle._state.basis)
    Binv = spl.splu(sp.csc_matrix(can.A[:, basis])).solve(np.eye(can.M))
    assert Binv.flags.f_contiguous and not Binv.flags.c_contiguous
    solve = driver._try_megakernel_solve if route == "megakernel" else driver._try_streaming_solve
    state = solve(can, handle.opts, warm_state=(basis, np.asarray(handle._state.vstat), Binv))
    assert state is not None and int(state.niter) == 0  # warm at the optimum
