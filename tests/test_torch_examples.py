"""PyTorch port, the examples against the JAX package's (`examples/`).

* TSP (`minilp_tpu_torch/examples/tsp.py`): branch-and-cut on the
  incremental API, the JAX example loaded from `examples/tsp.py` on the same
  distance matrices: the same optimal length (1e-9), equal to the brute
  force, the same tour and the same number of B&B nodes.  n = 8, seed 19
  branches (5 nodes: `fix_var` / `unfix_var` warm re-solves); at seed 24 a
  subtour cut in a branch makes the child infeasible, which both examples
  raise after 4 nodes (the JAX example catches `Infeasible` around
  `fix_var` only; ROADMAP Queue 3).
* Scenario batch: the same numpy batch through the reference's
  `solve_batch_pallas(interpret=True)` plus its f64 fallback, and through
  `solve_scenarios` on the CPU (K1's plain version): the same statuses,
  `verified` flags and objectives (1e-9); the fallback path forced on two
  lanes against the reference's `solve_batch` on them.
* Netlib runner: `write_mps` files of two synthetic shapes under non-Netlib
  names, through both runners' command lines: the same records (status,
  rows, cols, objective 1e-9, `pass_1e-6` against HiGHS by `--expected`),
  `--engine pdhg` on one file, and the exit code.
"""

import importlib.util
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu.ops.kernels.batched_simplex import solve_batch_pallas
from minilp_tpu.options import SolverOptions as RefOptions
from minilp_tpu.parallel.batched import solve_batch as ref_solve_batch
from minilp_tpu.status import Status, VarStat
from minilp_tpu.utils import synth as ref_synth
from minilp_tpu_torch.examples import netlib_runner, scenario_batch, tsp
from minilp_tpu_torch.parallel.batched import make_random_batch_host

from .oracle import solve_with_oracle
from .torch_helpers import rel_err

ROOT = pathlib.Path(__file__).resolve().parent.parent


def _load_reference(name):
    spec = importlib.util.spec_from_file_location(f"ref_example_{name}",
                                                  ROOT / "examples" / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _dist(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    return np.sqrt(((pts[:, None, :] - pts[None, :, :]) ** 2).sum(-1))


@pytest.mark.parametrize("n,seed", [(6, 0), (7, 1), (8, 19)])
def test_tsp_matches_reference(n, seed):
    dist = _dist(n, seed)
    ref = _load_reference("tsp").TspSolver(dist)
    ref_obj, ref_tour = ref.solve()
    port = tsp.TspSolver(dist, device="cpu")
    obj, tour = port.solve()
    assert rel_err(obj, ref_obj) <= 1e-9
    assert abs(obj - tsp.tour_length_brute_force(dist)) <= 1e-9
    assert sorted(tour) == sorted(ref_tour)
    assert port.nodes == ref.nodes


def test_tsp_infeasible_cut_in_a_branch_is_parity():
    dist = _dist(8, 24)
    ref = _load_reference("tsp").TspSolver(dist)
    with pytest.raises(minilp_tpu.Infeasible):
        ref.solve()
    port = tsp.TspSolver(dist, device="cpu")
    with pytest.raises(minilp_tpu_torch.Infeasible):
        port.solve()
    assert port.nodes == ref.nodes == 4


def _reference_scenarios(A, b, c, lo, hi, bad=None):
    """The JAX example's two steps: the Pallas kernel (interpret mode), then
    `solve_batch` on the unverified lanes (or on `bad`)."""
    res = solve_batch_pallas(*map(jnp.asarray, (A, b, c, lo, hi)), interpret=True)
    status, obj = np.array(res.status), np.array(res.obj)
    verified = np.asarray(res.verified)
    bad = np.flatnonzero(~verified) if bad is None else np.asarray(bad)
    if bad.size:
        B, m, n = A.shape
        vstat0 = np.full((bad.size, n), int(VarStat.AT_LOWER), np.int8)
        vstat0[:, n - m:] = int(VarStat.BASIC)
        basis0 = np.tile(np.arange(n - m, n, dtype=np.int32), (bad.size, 1))
        fb = ref_solve_batch(*(jnp.asarray(x[bad]) for x in (A, b, c, lo, hi)),
                             jnp.asarray(vstat0), jnp.asarray(basis0), opts=RefOptions())
        status[bad], obj[bad] = np.asarray(fb.status), np.asarray(fb.obj)
    return dict(status=status, verified=verified, obj=obj, niter=np.asarray(res.niter))


def _assert_same_scenarios(got, ref):
    np.testing.assert_array_equal(got["status"], ref["status"])
    np.testing.assert_array_equal(got["verified"], ref["verified"])
    for a, b in zip(got["obj"], ref["obj"]):
        assert rel_err(float(a), float(b)) <= 1e-9


def test_scenario_batch_matches_reference():
    batch = make_random_batch_host(3, 16, 8, 12)
    got = scenario_batch.solve_scenarios(*batch, device="cpu")
    _assert_same_scenarios(got, _reference_scenarios(*batch))
    assert (got["status"] == int(Status.OPTIMAL)).all()


def test_scenario_batch_fallback_matches_reference(monkeypatch):
    # two lanes sent to the f64 engine, as an uncertified basis sends them
    batch = make_random_batch_host(3, 16, 8, 12)
    k1 = scenario_batch.solve_batch_megakernel

    def unverify(*args, **kwargs):
        res = k1(*args, **kwargs)
        verified = np.array(res.verified)
        verified[[1, 5]] = False
        return res._replace(verified=verified)

    monkeypatch.setattr(scenario_batch, "solve_batch_megakernel", unverify)
    got = scenario_batch.solve_scenarios(*batch, device="cpu")
    ref = _reference_scenarios(*batch, bad=[1, 5])
    ref["verified"][[1, 5]] = False
    np.testing.assert_array_equal(got["fallback"], [1, 5])
    _assert_same_scenarios(got, ref)


@pytest.fixture(scope="module")
def mps_files(tmp_path_factory):
    """Two synthetic shapes as MPS files under non-Netlib names, with
    HiGHS's optimum of each."""
    from minilp_tpu.io.mps import write_mps

    out = tmp_path_factory.mktemp("netlib")
    files = {}
    for name, shape in [("shape_60x150", (60, 150, 0.08, 4)),
                        ("shape_25fv47_cut", (164, 314, 0.04, 1))]:
        m, nv, dens, seed = shape
        prob = ref_synth.netlib_shaped_problem(m, nv, dens, seed=seed)
        path = out / f"{name}.mps"
        path.write_text(write_mps(prob, name=name.upper()))
        kind, opt, _ = solve_with_oracle(prob)
        assert kind == "optimal"
        files[name] = (str(path), opt)
    return files


def _records(module, argv, capsys):
    rc = module.main(argv)
    return rc, [json.loads(line) for line in capsys.readouterr().out.splitlines()]


@pytest.mark.parametrize("engine", ["simplex", "pdhg"])
def test_netlib_runner_matches_reference(mps_files, capsys, engine):
    names = list(mps_files) if engine == "simplex" else ["shape_60x150"]
    argv = [mps_files[n][0] for n in names] + ["--engine", engine]
    argv += [f"--expected={n}={mps_files[n][1]!r}" for n in names]
    rc_ref, ref = _records(_load_reference("netlib_runner"), argv, capsys)
    rc, got = _records(netlib_runner, argv + ["--device", "cpu"], capsys)
    assert rc == rc_ref == 0
    assert len(got) == len(ref) == len(names)
    for g, r in zip(got, ref):
        for key in ("name", "status", "rows", "cols", "engine", "pass_1e-6",
                    "canonical_optimum"):
            assert g[key] == r[key], key
        assert g["pass_1e-6"] is True
        assert rel_err(g["objective"], r["objective"]) <= 1e-9
        assert g["certified"] == r["certified"]


def test_netlib_runner_known_optimum_and_exit_code(mps_files, capsys):
    # a file named like a Netlib instance is held against that instance's
    # canonical optimum: the synthetic shape fails it, and the run exits 1
    path, _opt = mps_files["shape_60x150"]
    renamed = pathlib.Path(path).with_name("afiro.mps")
    renamed.write_text(pathlib.Path(path).read_text().replace("SHAPE_60X150", "AFIRO"))
    rc, got = _records(netlib_runner, [str(renamed), "--device", "cpu"], capsys)
    assert rc == 1
    assert got[0]["canonical_optimum"] == netlib_runner.KNOWN_OPTIMA["afiro"]
    assert got[0]["pass_1e-6"] is False
