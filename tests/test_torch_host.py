"""PyTorch port, host layer: the port against the JAX package on the same LPs.

`canonicalize` arrays bit-equal, presolve statistics equal, the host sparse
engine (`solve_host_sparse`) on the same pivot path; plus the package
surface: no jax import, the explicit device, each incremental edit against
the reference's, records and stage timers.
"""

import dataclasses
import json
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.engine import hostlp as ref_hostlp
from minilp_tpu.presolve import presolve_problem as ref_presolve
from minilp_tpu.utils import synth as ref_synth
from minilp_tpu_torch.canonical import canonicalize
from minilp_tpu_torch.engine import hostlp
from minilp_tpu_torch.presolve import presolve_problem
from minilp_tpu_torch.utils import profiling, records, synth

from .oracle import random_problem
from .torch_helpers import CPU, as_torch_problem

#: synth generators at small shapes (m ≤ 64), by name: (function, args)
SYNTH = {
    "netlib_shaped": ("netlib_shaped_problem", (40, 120, 0.08)),
    "degenerate": ("degenerate_problem", (30, 60, 0.15)),
    "ill_conditioned": ("ill_conditioned_problem", (24, 48, 0.2)),
    "staircase": ("staircase_problem", (4, 6, 10)),
    "network_flow": ("network_flow_problem", (12, 40)),
    "mixed_bounds": ("mixed_bounds_problem", (30, 50, 0.15)),
}


def _synth_pair(name, seed):
    fn, args = SYNTH[name]
    return getattr(ref_synth, fn)(*args, seed=seed), getattr(synth, fn)(*args, seed=seed)


def _assert_canonical_equal(a, b):
    for field in ("A", "b", "c", "lo", "hi", "vstat0", "basis0"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)
    for field in ("m", "nv", "M", "N", "obj_sign"):
        assert getattr(a, field) == getattr(b, field), field
    assert [op.value for op in a.row_ops] == [op.value for op in b.row_ops]


def _assert_presolve_equal(ref_prob, port_prob):
    r_red, r_stats = ref_presolve(ref_prob)
    p_red, p_stats = presolve_problem(port_prob)
    assert dataclasses.asdict(r_stats) == dataclasses.asdict(p_stats)
    assert r_red._lo == p_red._lo and r_red._hi == p_red._hi
    assert len(r_red._constraints) == len(p_red._constraints)
    return r_red, p_red


@pytest.mark.parametrize("seed", range(10))
def test_canonicalize_and_presolve_match_on_oracle_instances(seed):
    rng = np.random.default_rng(300 + seed)
    prob = random_problem(rng, nv=int(rng.integers(2, 30)), m=int(rng.integers(1, 30)),
                          density=0.6)
    twin = as_torch_problem(prob)
    _assert_canonical_equal(ref_canonicalize(prob), canonicalize(twin))
    try:
        r_red, p_red = _assert_presolve_equal(prob, twin)
    except minilp_tpu.Error as exc:  # presolve proved a status: the port must too
        with pytest.raises(getattr(minilp_tpu_torch, type(exc).__name__)):
            presolve_problem(twin)
        return
    for extra, dtype in ((0, np.float64), (5, np.float32)):
        _assert_canonical_equal(
            ref_canonicalize(r_red, extra_row_capacity=extra, dtype=dtype),
            canonicalize(p_red, extra_row_capacity=extra, dtype=dtype),
        )


@pytest.mark.parametrize("name", sorted(SYNTH))
def test_synth_canonical_forms_match(name):
    ref_prob, port_prob = _synth_pair(name, seed=3)
    _assert_canonical_equal(ref_canonicalize(ref_prob), canonicalize(port_prob))
    r_red, p_red = _assert_presolve_equal(ref_prob, port_prob)
    _assert_canonical_equal(ref_canonicalize(r_red), canonicalize(p_red))


@pytest.mark.parametrize("name", sorted(SYNTH))
def test_solve_host_sparse_same_path(name):
    ref_prob, _ = _synth_pair(name, seed=5)
    can = ref_canonicalize(ref_presolve(ref_prob)[0])
    args = (can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0)
    ref = ref_hostlp.solve_host_sparse(*args, opts=minilp_tpu.SolverOptions())
    got = hostlp.solve_host_sparse(*args, opts=CPU)
    assert got.status == ref.status
    assert got.niter == ref.niter and got.bland_iters == ref.bland_iters
    np.testing.assert_array_equal(got.basis, ref.basis)
    np.testing.assert_array_equal(got.vstat, ref.vstat)
    assert got.obj == ref.obj


def test_random_batch_is_the_reference_generator():
    from minilp_tpu.parallel.batched import make_random_batch_host

    for ours, theirs in zip(synth.random_batch(4, 3, 5, 7),
                            make_random_batch_host(4, 3, 5, 7)):
        np.testing.assert_array_equal(ours, theirs)


@pytest.mark.parametrize("seed", range(6))
def test_solve_host_sparse_same_path_random(seed):
    rng = np.random.default_rng(seed)
    prob = random_problem(rng, nv=40, m=25, density=0.5)
    can = ref_canonicalize(prob)
    args = (can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0)
    ref = ref_hostlp.solve_host_sparse(*args, opts=minilp_tpu.SolverOptions())
    got = hostlp.solve_host_sparse(*args, opts=CPU)
    assert (got is None) == (ref is None)
    if ref is not None:
        assert (got.status, got.niter) == (ref.status, ref.niter)
        np.testing.assert_array_equal(got.basis, ref.basis)


def test_package_never_imports_jax():
    """Every module of the port imports, and a solve runs, with jax and the
    JAX package blocked."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        sys.modules["jax"] = None
        sys.modules["minilp_tpu"] = None
        import minilp_tpu_torch as pkg
        for mod in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
            importlib.import_module(mod.name)
        from minilp_tpu_torch import ComparisonOp, OptimizationDirection, Problem, SolverOptions
        for mk in ("always", "never"):
            prob = Problem(OptimizationDirection.Maximize,
                           SolverOptions(device="cpu", use_megakernel=mk))
            x = prob.add_var(1.0, (0.0, None))
            y = prob.add_var(2.0, (0.0, 3.0))
            prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
            assert abs(prob.solve().objective() - 7.0) < 1e-12
        assert sys.modules["jax"] is None
        print("ok")
    """)
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().endswith("ok")


def test_options_device_field():
    opts = minilp_tpu_torch.SolverOptions()
    assert opts.device == "cuda"
    assert hash(opts) == hash(minilp_tpu_torch.SolverOptions())
    assert hash(CPU) != hash(opts)
    with pytest.raises(dataclasses.FrozenInstanceError):
        opts.device = "cpu"
    # every option of the reference exists in the port, with the same default
    ref = {f.name: f.default for f in dataclasses.fields(minilp_tpu.SolverOptions)}
    port = {f.name: f.default for f in dataclasses.fields(minilp_tpu_torch.SolverOptions)}
    assert ref == {k: v for k, v in port.items() if k != "device"}


def test_cuda_device_without_card_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    prob = minilp_tpu_torch.Problem()
    x = prob.add_var(1.0, (0.0, 1.0))
    prob.add_constraint(x + x, minilp_tpu_torch.ComparisonOp.Ge, 0.5)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        prob.solve()


@pytest.mark.parametrize("method", ["add_constraint", "fix_var", "unfix_var",
                                    "add_gomory_cut"])
def test_incremental_api_not_ported(method):
    """Named for when these four edits raised NotImplementedError in the
    port: each now runs on the CPU and gives the JAX package's objective,
    values and pivots on the same LP."""
    ref_prob = minilp_tpu.Problem(minilp_tpu.OptimizationDirection.Maximize)
    x = ref_prob.add_var(1.0, (0.0, 3.0))
    y = ref_prob.add_var(2.0, (0.0, 3.0))
    ref_prob.add_constraint(2 * x + 2 * y, minilp_tpu.ComparisonOp.Le, 7.0)
    sols = [ref_prob.solve(), as_torch_problem(ref_prob).solve()]
    for pkg, k in ((minilp_tpu, 0), (minilp_tpu_torch, 1)):
        v = pkg.Variable(0)
        if method == "unfix_var":
            sols[k] = sols[k].fix_var(v, 0.5).unfix_var(v)[1]
        else:
            args = {"add_constraint": (v, pkg.ComparisonOp.Le, 0.25),
                    "fix_var": (v, 0.25), "add_gomory_cut": (v,)}[method]
            sols[k] = getattr(sols[k], method)(*args)
    ref, got = sols
    assert got._engine.certified
    assert got.objective() == pytest.approx(ref.objective(), rel=1e-9, abs=1e-9)
    assert [v for _, v in got.iter()] == pytest.approx([v for _, v in ref.iter()],
                                                       rel=1e-9, abs=1e-9)
    assert got._engine.iterations() == ref._engine.iterations()


def test_records_and_stage_timers(tmp_path, monkeypatch):
    log = tmp_path / "records.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    prob = minilp_tpu_torch.Problem(
        minilp_tpu_torch.OptimizationDirection.Maximize,
        dataclasses.replace(CPU, use_megakernel="always"),
    )
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, minilp_tpu_torch.ComparisonOp.Le, 4.0)
    profiling.reset_stages()
    assert records.enabled()
    with profiling.trace(str(tmp_path / "trace")) as prof:
        sol = prob.solve()
    assert (tmp_path / "trace" / "trace.json").exists()
    assert len(prof.key_averages()) > 0
    rec = [json.loads(line) for line in log.read_text().splitlines()]
    assert [r["event"] for r in rec] == ["cold_solve_megakernel"]
    assert rec[0]["backend"] == "cpu" and rec[0]["status"] == "OPTIMAL"
    assert rec[0]["objective"] == pytest.approx(sol.objective(), abs=1e-12)
    stages = profiling.stages()
    assert {"presolve_s", "canonicalize_s", "megakernel_s", "certify_s"} <= set(stages)
