"""PyTorch port, the bench entry point: `minilp_tpu_torch/bench.py` (`python3
-m minilp_tpu_torch.bench`) held against the JAX package and against
`bench.py` itself, on the CPU at small sizes.

- The batched line on the same numpy batches as the JAX package's
  `solve_batches_pipelined` (Pallas in interpret mode): the same
  `n_optimal`, `n_verified` and mean pivots; within 1e-6 of HiGHS.
- The single-LP line's cold solve and chain of cuts against the JAX
  package's `Problem.solve()` and `add_constraint`, driven here with
  bench.py's draws (`default_rng(5)`, 8 columns, margin 0.05).
- The whole line at small sizes: one JSON line whose keys are a superset of
  bench.py's, read from bench.py's source with `ast`.
- Faults: a RuntimeError inside a line leaves `main` and prints nothing;
  an infeasible cut ends a chain, another solver error fails the line; no
  card without `--device cpu` raises; the module imports no JAX.
- The PDHG line's `over_budget_s` at a tiny budget, and the device PDHG
  stage's restored `budget_s` against the reference's on a scripted clock.
- The maros line through the crossover (`driver._CROSSOVER_M` patched) and
  the pivot-rate line on the driver's own K2 launch.
"""

import ast
import contextlib
import io
import itertools
import json
import pathlib
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minilp_tpu
from minilp_tpu.api import ComparisonOp, LinearExpr, Variable
from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import crossover as ref_x
from minilp_tpu.engine import pdhg as ref_pdhg
from minilp_tpu.parallel import batched as ref_batched
from minilp_tpu.utils.synth import netlib_shaped_problem
from minilp_tpu_torch import SolverOptions, api, bench
from minilp_tpu_torch.engine import crossover, driver, pdhg
from minilp_tpu_torch.utils.synth import netlib_shaped_problem as port_problem

from .torch_helpers import rel_err

ROOT = pathlib.Path(__file__).resolve().parents[1]
#: every line of the bench at a size the CPU runs in seconds
SMALL = {
    "_batched_metrics": dict(batch=64, m=8, nv=16, n_batches=2),
    "_single_lp_and_incremental_metrics": dict(shapes={"120x400": (120, 400, 0.05)}),
    "_netlib_shape_metric": dict(shape=(40, 120, 0.08)),
    "_streaming_pivot_rate": dict(shape=(40, 120, 0.08)),
    "_incremental_routing_metric": dict(shape=(40, 120, 0.08)),
    "_maros_shape_metric": dict(shape=(60, 150, 0.08)),
    "_pdhg_maros_metric": dict(shape=(60, 150, 0.08), budget_s=2.0),
}


@pytest.fixture(scope="module")
def small_line():
    """`bench.main(device="cpu")` at the small sizes: (its line, stdout)."""
    with contextlib.redirect_stdout(io.StringIO()) as out:
        line = bench.main("cpu", SMALL)
    return line, out.getvalue()


# -- the batched line -----------------------------------------------------------

def test_batched_line_matches_reference():
    kw = SMALL["_batched_metrics"]
    got = bench._batched_metrics(device="cpu", **kw)
    batches = [ref_batched.make_random_batch_host(1 + k, batch=kw["batch"], m=kw["m"],
                                                  nv=kw["nv"]) for k in range(kw["n_batches"])]
    ref = ref_batched.solve_batches_pipelined(batches, pack=8, max_iter=2000,
                                              structural_cols=kw["nv"])
    status = np.concatenate([np.asarray(r.status) for r in ref])
    verified = np.concatenate([np.asarray(r.verified) for r in ref])
    niter = np.concatenate([np.asarray(r.niter) for r in ref])
    assert got["n_optimal"] == int((status == int(minilp_tpu.Status.OPTIMAL)).sum())
    assert got["n_verified"] == int(verified.sum()) == kw["batch"] * kw["n_batches"]
    assert got["mean_simplex_iters"] == pytest.approx(float(niter.mean()), rel=1e-12)
    assert got["max_rel_gap_vs_highs"] <= 1e-6
    assert (got["batch"], got["n_batches"]) == (kw["batch"], kw["n_batches"])
    assert len(got["reps_lps_per_sec"]) == 3 and got["value"] == got["reps_lps_per_sec"][1]


# -- the single-LP line and its chain of cuts --------------------------------------

def test_single_lp_chain_matches_reference():
    (tag, shape), = SMALL["_single_lp_and_incremental_metrics"]["shapes"].items()
    got = bench._single_lp_and_incremental_metrics(
        device="cpu", **SMALL["_single_lp_and_incremental_metrics"])[tag]
    sol = netlib_shaped_problem(*shape, seed=11).solve()
    cold_iters, certified = sol._engine.iterations(), bool(sol._engine.certified)
    rng = np.random.default_rng(5)  # bench.py:51-70
    pivots, cur = [], sol
    for _k in range(6):
        js = rng.choice(shape[1], size=8, replace=False)
        coeffs = rng.normal(size=8)
        val = sum(float(cf) * cur[Variable(int(j))] for cf, j in zip(coeffs, js))
        expr = LinearExpr((float(cf), Variable(int(j))) for cf, j in zip(coeffs, js))
        try:
            cur = cur.add_constraint(expr, ComparisonOp.Le, val - 0.05)
        except minilp_tpu.Infeasible:
            break
        pivots.append(cur._engine.iterations())
    # the cold solve's, before the chain's re-solves update the shared handle
    assert got["cold_iters"] == cold_iters != sol._engine.iterations()
    assert got["certified"] is certified is True
    assert got["resolve_nodes"] == len(pivots) >= 1
    assert got["mean_resolve_pivots"] == pytest.approx(float(np.mean(pivots)), rel=1e-12)
    assert got["cold_s"] > 0.0 and got["mean_resolve_s"] > 0.0


@pytest.mark.parametrize("error,ends", [(api.Infeasible, True), (api.SolverFailure, False)])
def test_a_cut_that_raises(monkeypatch, error, ends):
    """The third cut raises `error`: an infeasible cut ends the chain after
    two nodes, any other solver error leaves the line."""
    calls = itertools.count(1)
    add = api.Solution.add_constraint

    def third_raises(self, *args):
        if next(calls) == 3:
            raise error()
        return add(self, *args)

    monkeypatch.setattr(api.Solution, "add_constraint", third_raises)
    run = lambda: bench._single_lp_and_incremental_metrics(
        device="cpu", shapes={"40x120": (40, 120, 0.08)})
    if ends:
        assert run()["40x120"]["resolve_nodes"] == 2
    else:
        with pytest.raises(error):
            run()


# -- the whole line ----------------------------------------------------------------

def _bench_py_line():
    """bench.py's JSON line from its source: {key: (keys of the dicts its
    line function returns, keys of each per-tag dict) or None}, from the
    dict that `_main_locked` dumps and the functions that fill it.  A dict
    with an "error" key is bench.py's error report, not counted."""
    tree = ast.parse((ROOT / "bench.py").read_text())
    funcs = {f.name: f for f in tree.body if isinstance(f, ast.FunctionDef)}
    keys = lambda d: {k.value for k in d.keys if isinstance(k, ast.Constant)}

    def line_keys(fn):
        flat, per_tag = set(), set()
        for node in ast.walk(funcs[fn]):
            if isinstance(node, ast.Return) and isinstance(node.value, ast.Dict):
                flat |= set() if "error" in keys(node.value) else keys(node.value)
            elif isinstance(node, ast.Assign):
                (t,), v = node.targets, node.value
                if isinstance(t, ast.Name) and t.id == "out" and isinstance(v, ast.Dict):
                    flat |= keys(v)
                elif isinstance(t, ast.Subscript) and getattr(t.value, "id", None) == "out":
                    if isinstance(t.slice, ast.Constant):
                        flat.add(t.slice.value)
                    elif isinstance(v, ast.Dict) and "error" not in keys(v):
                        per_tag |= keys(v)
        return flat, per_tag

    main = funcs["_main_locked"]
    made_by = {n.targets[0].id: n.value.func.id for n in ast.walk(main)
               if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
               and isinstance(n.value, ast.Call) and isinstance(n.value.func, ast.Name)
               and n.value.func.id in funcs}
    dumped, = [n.args[0] for n in ast.walk(main) if isinstance(n, ast.Call)
               and getattr(n.func, "attr", None) == "dumps"]
    return {k.value: (line_keys(made_by[v.id]) if getattr(v, "id", None) in made_by else None)
            for k, v in zip(dumped.keys, dumped.values)}


def test_line_keys_are_a_superset_of_bench_py(small_line):
    line, out = small_line
    assert out.count("\n") == 1 and json.loads(out) == json.loads(json.dumps(line))
    ref = _bench_py_line()
    assert len(ref) >= 20 and "single_lp" in ref and ref["single_lp"][1]
    assert set(ref) <= set(line), sorted(set(ref) - set(line))
    for key, sub in ref.items():
        if sub is None:
            continue
        flat, per_tag = sub
        assert flat <= set(line[key]), (key, sorted(flat - set(line[key])))
        for tag, entry in line[key].items() if per_tag else ():
            assert per_tag <= set(entry), (key, tag, sorted(per_tag - set(entry)))
    assert (line["backend"], line["device"]) == ("cpu", "cpu")
    assert line["launches"] == {"batched_simplex": 0, "streaming_simplex": 0,
                                "packed_simplex": 0, "certify_f64": 0, "basis_f64": 0}
    assert "error" not in json.dumps(line) and None not in _leaves(line)


def _leaves(x):
    if isinstance(x, dict):
        return [v for item in x.values() for v in _leaves(item)]
    if isinstance(x, list):
        return [v for item in x for v in _leaves(item)]
    return [x]


def test_batched_line_carries_its_stages(small_line):
    """The batched line's `batch_stages`: the pipeline's host stages over
    the median repetition (2 batches of 64 here, none re-solved), with the
    call's root span and its self time; the device stages come from CUDA
    events, so the CPU line has none, and `chip_smoke.check_bench_line`
    (phase 9) refuses it for that."""
    line, _ = small_line
    stages = line["batch_stages"]
    host = {"batch_prep_s", "batch_wait_s", "batch_verify_s", "batch_resolve_s",
            "batch_call_s", "batch_call_self_s"}
    assert set(stages) == host | {"batch_resolved"}
    assert stages["batch_resolved"] == 0 and all(stages[k] >= 0.0 for k in host)
    assert stages["batch_verify_s"] > 0.0  # the plain certificate, whole, on the CPU
    sys.path.insert(0, str(ROOT))
    import chip_smoke

    check = lambda ln: chip_smoke.check_bench_line(
        ln, "cpu", line["streaming_pivot_rate"]["pivots"], n_lps=128,
        maros_obj=line["netlib_shape_maros_r7"]["objective"])
    with pytest.raises(AssertionError, match="the batched line's stages"):
        check(line)
    # with the device stages (the batched line's, and the basis kernel's in
    # the 25fv47 and maros breakdowns) and a launch of each kernel, every
    # check holds
    on_card = lambda key: dict(line[key], breakdown=dict(line[key]["breakdown"],
                                                         basis_dev_s=0.005))
    check(dict(line, batch_stages=dict(stages, batch_upload_dev_s=0.001,
                                       batch_kernel_dev_s=0.002, batch_verify_dev_s=0.0001),
               launches={name: 1 for name in line["launches"]},
               netlib_shape_25fv47=on_card("netlib_shape_25fv47"),
               netlib_shape_maros_r7=on_card("netlib_shape_maros_r7")))


def test_small_line_is_certified(small_line):
    line, _ = small_line
    assert line["n_optimal"] == line["n_verified"] == 128
    for entry in line["single_lp"].values():
        assert entry["certified"] and entry["resolve_nodes"] >= 1
    assert line["netlib_shape_25fv47"]["certified"]
    assert line["netlib_shape_maros_r7"]["certified"]
    assert line["streaming_pivot_rate"]["status_optimal"]
    assert min(e["nodes"] for e in line["incremental_routing"].values()) >= 1
    pd = line["pdhg_maros_shape"]
    assert np.isfinite(pd["kkt_err"]) and np.isfinite(pd["rel_gap_vs_certified"])
    assert pd["over_budget_s"] == max(0.0, pd["wall_s"] - pd["wall_bounded_s"])


def test_runtime_error_inside_a_line_leaves_main(monkeypatch):
    def fails(**_kw):
        raise RuntimeError("a fault inside the maros line")

    fails.__name__ = "_maros_shape_metric"
    monkeypatch.setattr(bench, "_maros_shape_metric", fails)
    with contextlib.redirect_stdout(io.StringIO()) as out:
        with pytest.raises(RuntimeError, match="maros line"):
            bench.main("cpu", SMALL)
    assert out.getvalue() == ""


def test_no_card_raises_and_no_jax_is_imported():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main()
    run = lambda *args: subprocess.run([sys.executable, *args], cwd=ROOT, capture_output=True,
                                       text=True, timeout=120)
    res = run("-m", "minilp_tpu_torch.bench")
    assert res.returncode != 0 and res.stdout == "" and "no CUDA device" in res.stderr
    res = run("-c", "import sys, minilp_tpu_torch.bench; print(sorted({m.split('.')[0] "
                    "for m in sys.modules} & {'jax', 'jaxlib', 'minilp_tpu'}))")
    assert res.returncode == 0 and res.stdout.strip() == "[]", res.stderr


# -- the PDHG line and the device stage's budget -------------------------------------

def test_pdhg_line_reports_over_budget_at_a_tiny_budget():
    got = bench._pdhg_maros_metric(-1.0, device="cpu", shape=(60, 150, 0.08), budget_s=0.0)
    assert (got["f32_head_iters"], got["f32_head_kkt"]) == (0, None)  # no head chunk began
    assert (got["tail_chunks"], got["iters"]) == (1, 256)  # the first tail chunk always runs
    assert got["wall_bounded_s"] == 0.0 and got["over_budget_s"] == got["wall_s"] > 0.0
    assert np.isfinite(got["kkt_err"]) and np.isfinite(got["rel_gap_vs_certified"])


@pytest.mark.parametrize("budget_s,launches", [(0.0, 0), (9500.0, 3), (20500.0, 6), (None, 8)])
def test_device_stage_budget_matches_reference(monkeypatch, budget_s, launches):
    """The stage's launches stubbed (each advances to its cap, MAX_ITER),
    the host's f64 KKT scripted (halving: no stall, never at `tol`) and a
    clock that moves 1000 s at each read by the stage itself: both packages
    start no chunk once the budget has passed (the reference's
    crossover.py:272-275) and take the same launches and result; without a
    budget the stage runs to `pdhg_max_iter`."""
    can = canonicalize(netlib_shaped_problem(60, 150, 0.08, seed=4), dtype=np.float64)
    popts = SolverOptions(device="cpu", pdhg_max_iter=8704)
    ropts = minilp_tpu.SolverOptions(pdhg_max_iter=8704)
    every = popts.pdhg_check_every
    seen = {"ref": [], "port": []}

    def stub(name, mod, arr, i32):
        def solve(A, b, c, lo, hi, opts, state0=None, stop_at=None):
            n = -(-int(stop_at) // every) * every
            seen[name].append(n)
            z = lambda k: arr(np.zeros(k, np.float32))
            return mod.PdhgState(
                x=z(can.N), y=z(can.M), x_sum=z(can.N), y_sum=z(can.M), x_rst=z(can.N),
                y_rst=z(can.M), omega=arr(np.float32(1.0)), inner=arr(np.float32(0.0)),
                last_err=arr(np.float32(1.0)), niter=i32(n),
                status=i32(int(minilp_tpu.Status.MAX_ITER)), err=arr(np.float32(1.0)))
        return solve

    monkeypatch.setattr(ref_pdhg, "solve_pdhg", stub("ref", ref_pdhg, jnp.asarray, jnp.int32))
    monkeypatch.setattr(pdhg, "solve_pdhg", stub(
        "port", pdhg, torch.as_tensor, lambda n: torch.tensor(n, dtype=torch.int32)))
    for name, xmod in (("ref", ref_x), ("port", crossover)):
        monkeypatch.setattr(xmod, "kkt_error_f64", lambda *a, _n=name: 0.5 ** len(seen[_n]))
    reads = [0]
    stages = {ref_x.__file__, crossover.__file__}

    def clock():
        if sys._getframe(1).f_code.co_filename in stages:
            reads[0] += 1
        return 1000.0 * reads[0]

    monkeypatch.setattr(time, "perf_counter", clock)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ref = ref_x._device_pdhg_stage(can, ropts, 1e-9, False, budget_s=budget_s)
    reads[0] = 0
    got = crossover._device_pdhg_stage(can, popts, 1e-9, device="cpu", budget_s=budget_s)
    assert seen["port"] == seen["ref"] and len(seen["port"]) == launches
    if launches == 0:
        assert got is ref is None
    else:
        assert (got[2], got[3]) == (ref[2], ref[3]) == (seen["port"][-1], 0.5 ** launches)


# -- the maros and pivot-rate lines ------------------------------------------------------

def test_maros_line_goes_through_the_crossover(monkeypatch):
    monkeypatch.setattr(driver, "_CROSSOVER_M", 32)
    shape = (60, 150, 0.08)
    got = bench._maros_shape_metric(device="cpu", shape=shape)
    ref = netlib_shaped_problem(*shape, seed=1).solve()
    assert got["certified"] and ref._engine.certified
    assert rel_err(got["objective"], ref.objective()) <= 1e-9
    assert {"crossover_pdhg_s", "crossover_identify_s", "crossover_polish_s",
            "unattributed_s"} <= set(got["breakdown"])


def test_pivot_rate_line_is_the_drivers_k2_launch():
    shape = (40, 120, 0.08)
    got = bench._streaming_pivot_rate(device="cpu", shape=shape)
    prob = port_problem(*shape, seed=1)
    prob.options = SolverOptions(device="cpu", use_streaming="always")  # the driver's K2 route
    sol = prob.solve()
    assert got["status_optimal"] and got["pivots"] == sol._engine.iterations() > 0
    assert got["shape"] == f"{sol._engine.can.M}x{sol._engine.can.N}"
    assert len(got["warm_wall_reps_s"]) == 3 and len(got["device_pivots_per_sec_reps"]) == 3
