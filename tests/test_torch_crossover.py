"""PyTorch port, the PDHG → simplex crossover: `minilp_tpu_torch/engine/
crossover.py` and the driver's crossover branch held against
`minilp_tpu/engine/crossover.py` on the same inputs, on the CPU.

- `identify_basis` gives the identical basis and vstat on the cases of
  `tests/test_hostlp.py` (the exact vertex, and a garbage iterate);
  `kkt_error_f64` agrees to 1e-12.
- The three hand-offs after the device stage (identify directly, the host
  stage warm, the host stage cold), with the stage patched as in
  `tests/test_crossover_device.py`: the same branch, status, pivots and
  certified objective (1e-9) in both packages.
- `solve_cold_crossover` at the netlib-shaped 60×150 instance and the
  25fv47 shape: the same status, PDHG iterations and polish pivots, and a
  certified objective within 1e-9 of the reference's.
- `_device_pdhg_stage(..., device="cpu")` against the reference's stage
  run on the CPU as it runs on a TPU: iterates within 1e-4 relative after
  the first f32 chunk (f32 sums in another order over 2000 iterations) and
  the same hand-off branch; at an A of 2²² entries the same launches
  through the bf16 phase, its adapted chunk and the switch to f32 (within
  5e-4, see the test); and on a scripted KKT sequence the same chunk
  adaptation and three-launch stall rule.
- `Problem.solve()` reaches the crossover branch (`cold_solve_crossover`)
  at a small shape with `_CROSSOVER_M` patched, and above 2048 padded rows
  as the reference does.
"""

import dataclasses
import json

import numpy as np
import pytest
import scipy.sparse as sp
import torch

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import crossover as ref_x, hostlp
from minilp_tpu.engine import pdhg as ref_pdhg
from minilp_tpu.utils import profiling as ref_profiling
from minilp_tpu.utils.synth import NETLIB_SHAPES, netlib_shaped_problem
from minilp_tpu_torch.engine import crossover, driver
from minilp_tpu_torch.engine import pdhg
from minilp_tpu_torch.utils import profiling

from .oracle import random_problem, solve_with_oracle
from .torch_helpers import as_torch_problem, rel_err

ROPTS = minilp_tpu.SolverOptions()
POPTS = minilp_tpu_torch.SolverOptions(device="cpu")
#: the reference's certified objective at the 25fv47 shape (seed 1), which
#: chip_smoke.py holds K2's main path to
OBJ_25FV47 = -685.0486724425741


def _branch(err, tol):
    return "identify" if err <= 10.0 * tol else ("cold" if err > 1e-2 else "warm")


@pytest.fixture(scope="module")
def inst():
    """The 60×150 instance of tests/test_crossover_device.py, its HiGHS
    objective, and the reference's sparse PDHG iterate at 1e-6."""
    prob = netlib_shaped_problem(60, 150, 0.08, seed=4)
    outcome, obj, _ = solve_with_oracle(prob)
    assert outcome == "optimal"
    can = canonicalize(prob, dtype=np.float64)
    p_opts = dataclasses.replace(ROPTS, feas_tol=1e-6, pdhg_matrix="sparse")
    st = ref_pdhg.solve_pdhg_sparse(
        jsparse.BCOO.fromdense(jnp.asarray(can.A)), jnp.asarray(can.b),
        jnp.asarray(can.c), jnp.asarray(can.lo), jnp.asarray(can.hi), opts=p_opts,
    )
    assert int(st.status) == int(minilp_tpu.Status.OPTIMAL)
    return can, obj, np.asarray(st.x), np.asarray(st.y)


# -- identify_basis and kkt_error_f64 -----------------------------------------

def _exact_vertex_case():
    rng = np.random.default_rng(21)
    prob = random_problem(rng, nv=40, m=25, density=0.5)
    can = canonicalize(prob, dtype=np.float64)
    res = hostlp.solve_host_sparse(can.A, can.b, can.c, can.lo, can.hi,
                                   can.basis0, can.vstat0, opts=ROPTS)
    A = np.asarray(can.A, np.float64)
    lu = hostlp.BasisLU(sp.csc_matrix(A), np.asarray(res.basis))
    xN = hostlp._nonbasic_x(np.asarray(res.vstat, dtype=np.int64), can.lo, can.hi)
    x = np.array(xN)
    x[np.asarray(res.basis)] = lu.ftran(can.b - A @ xN)
    d = can.c - lu.btran(can.c[np.asarray(res.basis)]) @ A
    return can, x, d


def _garbage_case():
    rng = np.random.default_rng(22)
    can = canonicalize(random_problem(rng, nv=50, m=30, density=0.4), dtype=np.float64)
    return can, rng.normal(size=can.N), rng.normal(size=can.N)


@pytest.mark.parametrize("case", ["exact_vertex", "garbage_iterate"])
def test_identify_basis_matches_reference(case):
    can, x, d = {"exact_vertex": _exact_vertex_case, "garbage_iterate": _garbage_case}[case]()
    A = np.asarray(can.A, np.float64)
    rb, rv = ref_x.identify_basis(A, can.lo, can.hi, x, d, np.asarray(can.basis0))
    pb, pv = crossover.identify_basis(A, can.lo, can.hi, x, d, np.asarray(can.basis0))
    assert np.array_equal(pb, rb) and pb.dtype == rb.dtype
    assert np.array_equal(pv, rv) and pv.dtype == rv.dtype
    assert crossover.hostlp.factorize_basis(A, pb) is not None


@pytest.mark.parametrize("sparse_a", [False, True])
def test_kkt_error_f64_matches_reference(inst, sparse_a):
    can, _obj, x, y = inst
    rng = np.random.default_rng(3)
    A = can.csc() if sparse_a else can.A
    for scale in (0.0, 1e-4, 1e-2):
        xp = x + scale * rng.normal(size=x.shape)
        yp = y + scale * rng.normal(size=y.shape)
        ref = ref_x.kkt_error_f64(A, can.b, can.c, can.lo, can.hi, xp, yp, 1e-4)
        got = crossover.kkt_error_f64(A, can.b, can.c, can.lo, can.hi, xp, yp, 1e-4)
        assert abs(got - ref) <= 1e-12 * ref


# -- the hand-offs after the device stage --------------------------------------

def _degraded_dual(can, x, y, tol):
    """The dual iterate degraded until the f64 KKT error lands between
    10·tol and 1e-2 (the floor window): the reference test's recipe."""
    rng = np.random.default_rng(0)
    for scale in (6e-4, 1e-3, 2e-3, 3e-3, 4e-4):
        yt = y + rng.normal(scale=scale * (1 + np.abs(y)))
        e = ref_x.kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi, x, yt, tol)
        if 10.0 * tol < e <= 1e-2:
            return yt, e
    raise AssertionError("no perturbation landed in the floor window")


@pytest.mark.parametrize("branch", ["identify", "warm", "cold"])
def test_handoffs_match_reference(inst, branch, monkeypatch):
    can, obj, x, y = inst
    tol = max(POPTS.crossover_tol, POPTS.feas_tol)
    if branch == "identify":
        xd, yd = x, y
    elif branch == "warm":
        xd, (yd, _e) = x, _degraded_dual(can, x, y, tol)
    else:
        xd, yd = np.zeros_like(x), np.zeros_like(y)
    err = ref_x.kkt_error_f64(can.A, can.b, can.c, can.lo, can.hi, xd, yd, tol)
    assert _branch(err, tol) == branch
    stage = lambda *a, **k: (xd, yd, 777, err, 1.0)
    monkeypatch.setattr(ref_x, "_device_pdhg_stage", stage)
    monkeypatch.setattr(crossover, "_device_pdhg_stage", stage)
    ref_profiling.reset_stages()
    profiling.reset_stages()
    ref = ref_x.solve_cold_crossover(can, ROPTS)
    got = crossover.solve_cold_crossover(can, POPTS)
    stages = profiling.stages()
    assert (int(got.status), got.niter) == (int(ref.status), ref.niter)
    assert int(got.status) == int(minilp_tpu_torch.Status.OPTIMAL)
    assert rel_err(can.obj_sign * got.obj, can.obj_sign * ref.obj) <= 1e-9
    assert rel_err(can.obj_sign * got.obj, obj) <= 1e-7
    assert stages["crossover_pdhg_device_iters"] == 777
    # the host stage runs exactly when the device iterate is not identified from
    assert ("crossover_pdhg_s" in stages) == (branch != "identify")
    assert stages["crossover_pdhg_iters"] == ref_profiling.stages()["crossover_pdhg_iters"]


def test_device_stage_declines_on_a_cpu_solve(inst):
    can, *_ = inst
    assert crossover._device_pdhg_stage(can, POPTS, 1e-4) is None


# -- solve_cold_crossover end to end -------------------------------------------

@pytest.mark.parametrize("shape", ["netlib_shaped_60x150", "25fv47"])
def test_cold_crossover_matches_reference(shape):
    if shape == "25fv47":
        prob = netlib_shaped_problem(*NETLIB_SHAPES["25fv47"], seed=1)
    else:
        prob = netlib_shaped_problem(60, 150, 0.08, seed=4)
    can = canonicalize(prob, dtype=np.float64)
    ref_profiling.reset_stages()
    profiling.reset_stages()
    ref = ref_x.solve_cold_crossover(can, ROPTS)
    got = crossover.solve_cold_crossover(can, POPTS)
    assert int(got.status) == int(ref.status) == int(minilp_tpu_torch.Status.OPTIMAL)
    assert (profiling.stages()["crossover_pdhg_iters"]
            == ref_profiling.stages()["crossover_pdhg_iters"])
    assert got.niter == ref.niter  # polish pivots
    assert rel_err(can.obj_sign * got.obj, can.obj_sign * ref.obj) <= 1e-9
    if shape == "25fv47":
        assert rel_err(can.obj_sign * got.obj, OBJ_25FV47) <= 1e-12


def test_device_stage_on_cpu_matches_reference_stage(inst, monkeypatch):
    """The port's stage run on the CPU (`device="cpu"`) against the
    reference's stage run as on a TPU (`jax.default_backend` patched): the
    first f32 chunk's iterates within 1e-4, then the same hand-off."""
    can, *_ = inst
    tol = max(POPTS.crossover_tol, POPTS.feas_tol)
    chunks = {"ref": [], "port": []}
    ref_solve, port_solve = ref_pdhg.solve_pdhg, pdhg.solve_pdhg

    def ref_spy(*a, **k):
        st = ref_solve(*a, **k)
        chunks["ref"].append((np.asarray(st.x), np.asarray(st.y), int(st.niter)))
        return st

    def port_spy(*a, **k):
        st = port_solve(*a, **k)
        chunks["port"].append((st.x.numpy(), st.y.numpy(), int(st.niter)))
        return st

    monkeypatch.setattr(ref_pdhg, "solve_pdhg", ref_spy)
    monkeypatch.setattr(pdhg, "solve_pdhg", port_spy)
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ref = ref_x._device_pdhg_stage(can, ROPTS, tol, False)
    got = crossover._device_pdhg_stage(can, POPTS, tol, device="cpu")
    (rx, ry, rn), (px, py, pn) = chunks["ref"][0], chunks["port"][0]
    assert rn == pn <= crossover.FIRST_CHUNK  # the same windows (here it converges in one chunk)
    for p, r in ((px, rx), (py, ry)):
        assert np.linalg.norm(p - r) <= 1e-4 * (1.0 + np.linalg.norm(r))
    assert _branch(got[3], tol) == _branch(ref[3], tol)


def _spy_chunks(monkeypatch):
    """Record each launch of the device stage (the operator's dtype, niter,
    x, y) and the host's f64 KKT after it, in both packages, on a clock
    that makes every launch look slow: each later chunk is the rule's floor
    of 500 iterations in both, whatever the machine's speed."""
    import itertools
    import time

    chunks = {"ref": [], "port": []}
    for name, mod, xmod, to_np in (
            ("ref", ref_pdhg, ref_x, np.asarray),
            ("port", pdhg, crossover, lambda t: t.numpy())):
        solve, kkt = mod.solve_pdhg, xmod.kkt_error_f64

        def spy(A, *a, _solve=solve, _name=name, _np=to_np, **k):
            st = _solve(A, *a, **k)
            chunks[_name].append(dict(dtype=str(A.dtype).split(".")[-1], niter=int(st.niter),
                                      x=_np(st.x), y=_np(st.y)))
            return st

        def kkt_spy(*a, _kkt=kkt, _name=name):
            err = _kkt(*a)
            chunks[_name][-1]["kkt"] = err
            return err

        monkeypatch.setattr(mod, "solve_pdhg", spy)
        monkeypatch.setattr(xmod, "kkt_error_f64", kkt_spy)
    clock = itertools.count()
    monkeypatch.setattr(time, "perf_counter", lambda: 1000.0 * next(clock))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    return chunks


def test_device_stage_chunks_match_reference_through_the_bf16_phase(monkeypatch):
    """At an A of 2²² entries and more (1000 × 4224), both packages' stages
    run the bf16 phase in four launches (2048, 2048, 2048, then the adapted
    512) down to 4e-3, reset the averaging window and go on in f32 until
    `pdhg_max_iter`: the same launches, operator dtypes and phase boundary
    and hand-off branch.  The iterates agree within 5e-4 relative after
    every launch and the host's f64 KKT within 1e-2 relative: f32 sums run
    in another order over up to 8704 iterations, and the two packages'
    f32 Ruiz scalings (3.2e-7 apart) round 5 of the 94000 scaled entries
    to the other bf16 neighbour (measured: y 1.3e-4, x 1.9e-6, KKT
    2.5e-3)."""
    can = canonicalize(netlib_shaped_problem(1000, 3100, 0.03, seed=2), dtype=np.float64)
    assert can.A.size >= crossover.BF16_MIN_ENTRIES == 1 << 22
    kw = dict(pdhg_max_iter=8704)
    tol = max(POPTS.crossover_tol, POPTS.feas_tol)
    chunks = _spy_chunks(monkeypatch)
    ref = ref_x._device_pdhg_stage(can, dataclasses.replace(ROPTS, **kw), tol, False)
    got = crossover._device_pdhg_stage(can, dataclasses.replace(POPTS, **kw), tol, device="cpu")
    rc, pc = chunks["ref"], chunks["port"]
    schedule = lambda cs: [(c["dtype"], c["niter"]) for c in cs]
    assert schedule(pc) == schedule(rc) == [
        ("bfloat16", 2048), ("bfloat16", 4096), ("bfloat16", 6144), ("bfloat16", 6656),
        ("float32", 8704)]
    for p, r in zip(pc, rc):
        for k in ("x", "y"):
            assert np.linalg.norm(p[k] - r[k]) <= 5e-4 * (1.0 + np.linalg.norm(r[k])), (p["niter"], k)
        assert abs(p["kkt"] - r["kkt"]) <= 1e-2 * r["kkt"], p["niter"]
    assert got[2] == ref[2] == 8704
    assert _branch(got[3], tol) == _branch(ref[3], tol)


def test_device_stage_stall_rule_matches_reference(inst, monkeypatch):
    """The chunk adaptation and the three-launch stall rule take the same
    decisions in both packages on the same host KKT sequence.  Each launch
    is a stub that advances to its cap (MAX_ITER), and each launch's f64
    error is scripted, so only the stage's own control flow runs: 2048 a
    launch, then the floor of 500 (512, whole windows); the small gains
    after 4.9e-3 and 4.8e-3 are reset by 2e-3, and the third small gain in
    a row after it (1.97e-3) ends the stage."""
    import itertools
    import time

    can, *_ = inst
    tol = 1e-9
    every = POPTS.pdhg_check_every
    script = [1e-2, 5e-3, 4.9e-3, 4.8e-3, 2e-3, 1.99e-3, 1.98e-3, 1.97e-3, 1e-9]
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
        monkeypatch.setattr(xmod, "kkt_error_f64", lambda *a, _n=name: script[len(seen[_n]) - 1])
    clock = itertools.count()  # every launch looks slow: later chunks are the floor
    monkeypatch.setattr(time, "perf_counter", lambda: 1000.0 * next(clock))
    monkeypatch.setattr(jax, "default_backend", lambda: "tpu")
    ref = ref_x._device_pdhg_stage(can, ROPTS, tol, False)
    got = crossover._device_pdhg_stage(can, POPTS, tol, device="cpu")
    assert seen["port"] == seen["ref"] == [2048, 4096, 6144, 6656, 7168, 7680, 8192, 8704]
    assert (got[2], got[3]) == (ref[2], ref[3]) == (8704, 1.97e-3)


# -- the driver's crossover branch ---------------------------------------------

def test_driver_crossover_branch_at_a_small_shape(tmp_path, monkeypatch):
    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    monkeypatch.setattr(driver, "_CROSSOVER_M", 32)
    ref_prob = netlib_shaped_problem(60, 150, 0.08, seed=4)
    profiling.reset_stages()
    sol = as_torch_problem(ref_prob).solve()
    assert [json.loads(l)["event"] for l in log.read_text().splitlines()] == [
        "cold_solve_crossover"]
    assert sol._engine.certified
    assert sol._engine.can.M > 32
    assert rel_err(sol.objective(), ref_prob.solve().objective()) <= 1e-9
    assert "crossover_pdhg_iters" in profiling.stages()
