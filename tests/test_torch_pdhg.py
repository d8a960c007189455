"""PyTorch port, the PDHG engine: `minilp_tpu_torch/engine/pdhg.py` and
`engine="pdhg"` held against `minilp_tpu/engine/pdhg.py` on the same inputs.

The instances are those of `tests/test_pdhg.py` (seeds 3000+, 4200+ and
9000+, the infeasible system, the unbounded LP and the badly scaled Ruiz
instance), made with numpy and run through both packages on the CPU, dense
and sparse (BCOO / CSR), vanilla and halpern.  Tolerances, in f64: Ruiz
scalings and ‖A‖₂ within 1e-12 relative (the same arithmetic, summed in
another order); iterates within 1e-9 relative in norm (‖Δ‖ ≤ 1e-9·(1 +
‖ref‖), the repo's `rel_err` on norms) after 4 windows and at termination, where the status and the iteration count must be equal
(every restart and stop decision the same); 1e-5 for the bf16-rounded
matrix with f32 vectors after 2 windows (f32 sums in another order).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.experimental import sparse as jsparse

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu.canonical import canonicalize
from minilp_tpu.engine import pdhg as ref_pdhg
from minilp_tpu_torch.engine import pdhg

from .oracle import random_problem, solve_with_oracle
from .torch_helpers import as_torch_problem, rel_err

ROPTS = minilp_tpu.SolverOptions
POPTS = minilp_tpu_torch.SolverOptions


def _canonical_arrays(prob):
    can = canonicalize(prob, dtype=np.float64)
    return can.A, can.b, can.c, can.lo, can.hi


def _random(k):
    rng = np.random.default_rng(3000 + k)
    return random_problem(rng, nv=int(rng.integers(5, 20)), m=int(rng.integers(3, 15)),
                          frac_free=0.0)


def _sparse_ish(k):
    rng = np.random.default_rng(4200 + k)
    m, nv = 10, 24
    A_s = rng.normal(size=(m, nv)) * (rng.random((m, nv)) < 0.3)
    x0 = rng.uniform(0.2, 0.8, size=nv)
    b = A_s @ x0 + rng.uniform(0.1, 1.0, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv), np.zeros(m)])
    return A, b, c, np.zeros(nv + m), np.concatenate([np.ones(nv), np.full(m, np.inf)])


def _near_degenerate(k):
    rng = np.random.default_rng(9000 + k)
    m, nv = 10, 18
    U, _ = np.linalg.qr(rng.normal(size=(m, m)))
    V, _ = np.linalg.qr(rng.normal(size=(nv, nv)))
    A_s = U @ np.diag(10.0 ** np.linspace(0, -3, m)) @ V[:m]
    x0 = rng.uniform(0.3, 0.7, size=nv)
    b = A_s @ x0 + rng.uniform(0.05, 0.3, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv), np.zeros(m)])
    return A, b, c, np.zeros(nv + m), np.concatenate([np.ones(nv), np.full(m, np.inf)])


def _badly_scaled():
    rng = np.random.default_rng(31337)
    m, nv = 12, 24
    scales = 10.0 ** rng.uniform(-4, 4, size=nv)
    A_s = rng.normal(size=(m, nv)) * scales[None, :]
    x0 = rng.uniform(0.2, 0.8, size=nv) / scales
    b = A_s @ x0 + rng.uniform(0.1, 1.0, size=m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    c = np.concatenate([rng.normal(size=nv) * scales, np.zeros(m)])
    return A, b, c, np.zeros(nv + m), np.concatenate([2.0 / scales, np.full(m, np.inf)])


def _infeasible_system():
    prob = minilp_tpu.Problem(options=ROPTS(presolve=False))
    x = prob.add_var(1.0, (None, None))
    y = prob.add_var(1.0, (None, None))
    prob.add_constraint(x + y, minilp_tpu.ComparisonOp.Eq, 1.0)
    prob.add_constraint(x + y, minilp_tpu.ComparisonOp.Eq, 3.0)
    return _canonical_arrays(prob)


def _unbounded():
    prob = minilp_tpu.Problem(minilp_tpu.OptimizationDirection.Maximize)
    x = prob.add_var(1.0, (0.0, None))
    prob.add_constraint(1.0 * x, minilp_tpu.ComparisonOp.Ge, 1.0)
    return _canonical_arrays(prob)


#: name -> (canonical arrays, the options of tests/test_pdhg.py)
CASES = {
    **{f"random{3000 + k}": (lambda k=k: _canonical_arrays(_random(k)),
                             dict(feas_tol=1e-7, pdhg_max_iter=400_000)) for k in range(5)},
    **{f"sparse{4200 + k}": (lambda k=k: _sparse_ish(k), dict(feas_tol=1e-7))
       for k in range(3)},
    **{f"degenerate{9000 + k}": (lambda k=k: _near_degenerate(k),
                                 dict(feas_tol=1e-7, pdhg_max_iter=150_000)) for k in range(4)},
    "ruiz31337": (_badly_scaled, dict(feas_tol=1e-7, pdhg_max_iter=40_000)),
    "infeasible_system": (_infeasible_system, dict(feas_tol=1e-7)),
    "unbounded": (_unbounded, dict(feas_tol=1e-7, pdhg_max_iter=400_000)),
}
#: the cases also run through the sparse entry points
SPARSE_CASES = ["random3000", "sparse4200", "sparse4201", "sparse4202",
                "infeasible_system", "unbounded"]
#: the reference's helpers, compiled once per shape
_ref_ruiz_dense = jax.jit(ref_pdhg._ruiz_dense, static_argnums=1)
_ref_ruiz_bcoo = jax.jit(ref_pdhg._ruiz_bcoo, static_argnums=1)
_ref_spectral_norm = jax.jit(ref_pdhg._spectral_norm, static_argnums=(2, 3))


def _run_both(name, variant, matrix, stop_at=None):
    """(reference state, port state) as numpy dicts on the same inputs; no
    `stop_at` runs to termination (the reference is given its max_iter as
    the cap, which stops where None does and reuses the capped compile)."""
    make, kw = CASES[name]
    A, b, c, lo, hi = make()
    kw = dict(kw, engine="pdhg", pdhg_variant=variant)
    vecs = (b, c, lo, hi)
    ref_stop = jnp.int32(ROPTS(**kw).pdhg_max_iter if stop_at is None else stop_at)
    if matrix == "sparse":
        ref = ref_pdhg.solve_pdhg_sparse(
            jsparse.BCOO.fromdense(jnp.asarray(A)), *map(jnp.asarray, vecs),
            opts=ROPTS(**kw), stop_at=ref_stop)
        port = pdhg.solve_pdhg_sparse(
            torch.as_tensor(A).to_sparse_csr(), *map(torch.as_tensor, vecs),
            opts=POPTS(device="cpu", **kw), stop_at=stop_at)
    else:
        ref = ref_pdhg.solve_pdhg(*map(jnp.asarray, (A, *vecs)), opts=ROPTS(**kw),
                                  stop_at=ref_stop)
        port = pdhg.solve_pdhg(*map(torch.as_tensor, (A, *vecs)),
                               opts=POPTS(device="cpu", **kw), stop_at=stop_at)
    as_np = lambda st: {k: np.asarray(v) for k, v in st._asdict().items()}
    return as_np(ref), {k: v.numpy() for k, v in port._asdict().items()}


def _close(a, b, tol):
    """‖a − b‖ ≤ tol·(1 + ‖b‖): relative as `rel_err` counts it, so that a
    dual that is zero up to rounding (‖y‖ ~ 1e-9) is held absolutely."""
    return np.linalg.norm(a - b) <= tol * (1.0 + np.linalg.norm(b))


def _params(cases):
    return [(n, v, mat) for n in cases for v in ("vanilla", "halpern")
            for mat in (("dense", "sparse") if n in SPARSE_CASES else ("dense",))]


@pytest.mark.parametrize("name", sorted(CASES))
def test_ruiz_scalings_match_reference(name):
    A = CASES[name][0]()[0]
    dr_r, dc_r = _ref_ruiz_dense(jnp.asarray(A), 10)
    dr_p, dc_p = pdhg._ruiz_dense(torch.as_tensor(A), 10)
    for p, r in ((dr_p, dr_r), (dc_p, dc_r)):
        assert np.max(np.abs(p.numpy() - np.asarray(r)) / np.asarray(r)) <= 1e-12
    if name in SPARSE_CASES:
        dr_s, dc_s = _ref_ruiz_bcoo(jsparse.BCOO.fromdense(jnp.asarray(A)), 10)
        dr_q, dc_q = pdhg._ruiz_sparse(torch.as_tensor(A).to_sparse_csr(), 10)
        for p, r in ((dr_q, dr_s), (dc_q, dc_s)):
            assert np.max(np.abs(p.numpy() - np.asarray(r)) / np.asarray(r)) <= 1e-12


@pytest.mark.parametrize("name", sorted(CASES))
def test_spectral_norm_matches_reference(name):
    A = CASES[name][0]()[0]
    ref = float(_ref_spectral_norm(jnp.asarray(A), jnp.asarray(A).T, A.shape[1],
                                   jnp.float64))
    At = torch.as_tensor(A)
    got = float(pdhg._spectral_norm(At, At.T, A.shape[1], torch.float64, At.device))
    assert abs(got - ref) <= 1e-12 * ref
    S = At.to_sparse_csr()
    crow, col, val = pdhg.csr_transpose(S.crow_indices(), S.col_indices(), S.values(),
                                        A.shape)
    ST = torch.sparse_csr_tensor(crow, col, val, size=(A.shape[1], A.shape[0]))
    got_s = float(pdhg._spectral_norm(S, ST, A.shape[1], torch.float64, At.device))
    assert abs(got_s - ref) <= 1e-12 * ref


@pytest.mark.parametrize("name,variant,matrix", _params(CASES))
def test_four_windows_match_reference(name, variant, matrix):
    ref, port = _run_both(name, variant, matrix, stop_at=4 * 64)
    assert int(port["niter"]) == int(ref["niter"]) == 4 * 64
    assert int(port["status"]) == int(ref["status"])
    assert _close(port["x"], ref["x"], 1e-9)
    assert _close(port["y"], ref["y"], 1e-9)


@pytest.mark.parametrize("name,variant,matrix", _params(CASES))
def test_termination_matches_reference(name, variant, matrix):
    ref, port = _run_both(name, variant, matrix)
    assert int(port["status"]) == int(ref["status"])
    assert int(port["niter"]) == int(ref["niter"])
    assert _close(port["x"], ref["x"], 1e-9)
    assert _close(port["y"], ref["y"], 1e-9)


def test_termination_statuses_are_the_references():
    """The certificates fire where the reference's do: INFEASIBLE on the
    infeasible system, UNBOUNDED on the unbounded LP, OPTIMAL (never a
    false certificate) on the near-degenerate instances."""
    want = {"infeasible_system": minilp_tpu_torch.Status.INFEASIBLE,
            "unbounded": minilp_tpu_torch.Status.UNBOUNDED,
            **{f"degenerate{9000 + k}": minilp_tpu_torch.Status.OPTIMAL for k in range(4)}}
    for name, status in want.items():
        _ref, port = _run_both(name, "vanilla", "dense")
        assert int(port["status"]) == int(status), name


@pytest.mark.parametrize("variant", ["vanilla", "halpern"])
@pytest.mark.parametrize("matrix", ["dense", "sparse"])
def test_chunked_launches_equal_one_launch(variant, matrix):
    """Warm re-entry through `state0` / `stop_at` in chunks of 700
    iterations reproduces the single launch: the windows are the same, and
    only the original-space round trip of the iterate between chunks
    rounds.  The reference's chunked run is held to the port's."""
    make, kw = CASES["random3001"]
    A, b, c, lo, hi = make()
    opts = POPTS(device="cpu", engine="pdhg", pdhg_variant=variant, **kw)
    Am = torch.as_tensor(A)
    Am = Am.to_sparse_csr() if matrix == "sparse" else Am
    solver = pdhg.solve_pdhg_sparse if matrix == "sparse" else pdhg.solve_pdhg
    vecs = tuple(map(torch.as_tensor, (b, c, lo, hi)))
    single = solver(Am, *vecs, opts=opts)
    st, done = None, 0
    while True:
        st = solver(Am, *vecs, opts=opts, state0=st,
                    stop_at=min(done + 700, opts.pdhg_max_iter))
        done = int(st.niter)
        if int(st.status) != int(minilp_tpu_torch.Status.MAX_ITER):
            break
    assert int(st.status) == int(single.status) == int(minilp_tpu_torch.Status.OPTIMAL)
    assert int(st.niter) == int(single.niter)
    assert _close(st.x.numpy(), single.x.numpy(), 1e-9)
    assert _close(st.y.numpy(), single.y.numpy(), 1e-9)
    ref_st, rdone = None, 0
    rsolver = ref_pdhg.solve_pdhg_sparse if matrix == "sparse" else ref_pdhg.solve_pdhg
    RA = jsparse.BCOO.fromdense(jnp.asarray(A)) if matrix == "sparse" else jnp.asarray(A)
    while True:
        ref_st = rsolver(RA, *map(jnp.asarray, (b, c, lo, hi)),
                         opts=ROPTS(engine="pdhg", pdhg_variant=variant, **kw),
                         state0=ref_st, stop_at=jnp.int32(rdone + 700))
        rdone = int(ref_st.niter)
        if int(ref_st.status) != int(minilp_tpu.Status.MAX_ITER):
            break
    assert rdone == done
    assert _close(st.x.numpy(), np.asarray(ref_st.x), 1e-9)


@pytest.mark.parametrize("variant", ["vanilla", "halpern"])
@pytest.mark.parametrize("name", ["random3001", "sparse4200", "ruiz31337"])
@pytest.mark.parametrize("mat_dtype,tol", [("bfloat16", 1e-5), ("float32", 1e-4)])
def test_low_precision_matrix_two_windows(name, variant, mat_dtype, tol):
    """`solve_pdhg` with f32 vectors and a bf16 (the device stage's first
    phase) or f32 matrix (its second): the scaled matrix is rounded once,
    and the products run in f32, as in the reference on the CPU.  The f32
    matrix is held as one f32 chunk of the device stage is (1e-4): in
    halpern the f32 rounding of the two packages' sums moves y by about
    1e-5 within the first window already (random3001)."""
    make, kw = CASES[name]
    A, b, c, lo, hi = make()
    kw = dict(kw, engine="pdhg", pdhg_variant=variant, dtype="float32")
    f32 = lambda v: np.asarray(v, np.float32)
    ref = ref_pdhg.solve_pdhg(jnp.asarray(f32(A)).astype(getattr(jnp, mat_dtype)),
                              *(jnp.asarray(f32(v)) for v in (b, c, lo, hi)),
                              opts=ROPTS(**kw), stop_at=jnp.int32(2 * 64))
    port = pdhg.solve_pdhg(torch.as_tensor(f32(A)).to(getattr(torch, mat_dtype)),
                           *(torch.as_tensor(f32(v)) for v in (b, c, lo, hi)),
                           opts=POPTS(device="cpu", **kw), stop_at=2 * 64)
    assert port.x.dtype == torch.float32
    assert _close(port.x.numpy(), np.asarray(ref.x), tol)
    assert _close(port.y.numpy(), np.asarray(ref.y), tol)


# -- engine="pdhg" through Problem.solve() ------------------------------------

PDHG_OPTS = dict(engine="pdhg", feas_tol=1e-7, pdhg_max_iter=400_000)


@pytest.mark.parametrize("matrix", ["auto", "sparse"])
@pytest.mark.parametrize("seed", range(5))
def test_driver_objective_matches_reference(seed, matrix):
    prob = _random(seed)
    outcome, obj, _ = solve_with_oracle(prob)
    prob.options = ROPTS(pdhg_matrix=matrix, **PDHG_OPTS)
    port = as_torch_problem(prob, pdhg_matrix=matrix, **PDHG_OPTS)
    if outcome != "optimal":
        with pytest.raises(minilp_tpu.Error) as ref_exc:
            prob.solve()
        with pytest.raises(getattr(minilp_tpu_torch, type(ref_exc.value).__name__)):
            port.solve()
        return
    ref_sol, sol = prob.solve(), port.solve()
    assert rel_err(sol.objective(), ref_sol.objective()) <= 1e-9
    assert rel_err(sol.objective(), obj) <= 1e-5
    assert sol._engine.iterations() == ref_sol._engine.iterations()


def test_driver_records_pdhg_solve(tmp_path, monkeypatch):
    import json

    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    prob = minilp_tpu_torch.Problem(minilp_tpu_torch.OptimizationDirection.Maximize,
                                    POPTS(device="cpu", **PDHG_OPTS))
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, minilp_tpu_torch.ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert rel_err(sol.objective(), 7.0) <= 1e-5
    rec = json.loads(log.read_text().splitlines()[-1])
    assert (rec["event"], rec["status"], rec["backend"]) == ("pdhg_solve", "OPTIMAL", "cpu")


@pytest.mark.parametrize("edit", ["add_constraint", "fix_var", "unfix_var",
                                  "add_gomory_cut"])
def test_pdhg_handle_edits_raise(edit):
    prob = minilp_tpu_torch.Problem(options=POPTS(device="cpu", **PDHG_OPTS))
    x = prob.add_var(1.0, (0.0, 5.0))
    prob.add_constraint(1.0 * x, minilp_tpu_torch.ComparisonOp.Ge, 1.0)
    sol = prob.solve()
    args = {"add_constraint": (1.0 * x, minilp_tpu_torch.ComparisonOp.Le, 3.0),
            "fix_var": (x, 2.0), "unfix_var": (x,), "add_gomory_cut": (x,)}[edit]
    with pytest.raises(minilp_tpu_torch.SolverFailure, match="simplex"):
        getattr(sol, edit)(*args)


# -- restart decisions at chip_smoke.py phase 7(b)'s instance ------------------

#: windows of the prefix held to the reference's decisions (the packages'
#: KKT errors drift apart from rounding: 4.3e-9 relative by window 500 dense,
#: 1.4e-5 by window 1000; ROADMAP.md Queue 3)
PREFIX_WINDOWS = 500


def _windows_instance():
    """Phase 7(b)'s LP (`utils/pdhg_windows.py`), presolved and canonical,
    as the driver hands it to the engine."""
    from minilp_tpu_torch.canonical import canonicalize as port_canonicalize
    from minilp_tpu_torch.presolve import presolve_problem
    from minilp_tpu_torch.utils import pdhg_windows
    from minilp_tpu_torch.utils.synth import netlib_shaped_problem as port_problem

    prob = port_problem(*pdhg_windows.INSTANCE, seed=pdhg_windows.SEED)
    can = port_canonicalize(presolve_problem(prob)[0], dtype=np.float64)
    return can.A, can.b, can.c, can.lo, can.hi


def reference_windows(matrix, stop_at=None):
    """The reference's window trace on `_windows_instance()`: rows of
    `pdhg_windows.FIELDS`, one per window, recorded by a debug callback in
    the PdhgState its loop builds (a fresh compile; the callback only reads,
    and the full run keeps the reference's iterations and objective)."""
    from minilp_tpu_torch.utils import pdhg_windows

    A, b, c, lo, hi = _windows_instance()
    real, rows = ref_pdhg.PdhgState, []

    def record(**kw):
        jax.debug.callback(lambda *v: rows.append([float(t) for t in v]),
                           *[kw[f] for f in pdhg_windows.FIELDS], ordered=True)
        return real(**kw)

    opts = ROPTS(pdhg_matrix=matrix, **pdhg_windows.OPTIONS)
    RA = jsparse.BCOO.fromdense(jnp.asarray(A)) if matrix == "sparse" else jnp.asarray(A)
    solver = ref_pdhg.solve_pdhg_sparse if matrix == "sparse" else ref_pdhg.solve_pdhg
    jax.clear_caches()
    ref_pdhg.PdhgState = record
    try:
        st = solver(RA, *map(jnp.asarray, (b, c, lo, hi)), opts=opts,
                    stop_at=jnp.int32(opts.pdhg_max_iter if stop_at is None else stop_at))
        jax.effects_barrier()
    finally:
        ref_pdhg.PdhgState = real
        jax.clear_caches()
    return np.asarray(rows[1:]), st


def port_windows(matrix, stop_at=None):
    """The port's window trace on the same inputs, on the CPU."""
    from minilp_tpu_torch.utils import pdhg_windows

    A, b, c, lo, hi = _windows_instance()
    opts = POPTS(device="cpu", pdhg_matrix=matrix, **pdhg_windows.OPTIONS)
    Am = torch.as_tensor(A)
    solver = pdhg.solve_pdhg_sparse if matrix == "sparse" else pdhg.solve_pdhg
    with pdhg_windows.recording_windows(torch) as rows:
        st = solver(Am.to_sparse_csr() if matrix == "sparse" else Am,
                    *map(torch.as_tensor, (b, c, lo, hi)), opts=opts, stop_at=stop_at)
    return torch.stack(rows[1:]).numpy(), st


@pytest.mark.parametrize("matrix", ["dense", "sparse"])
def test_restart_windows_match_reference_at_256x1024(matrix):
    """The first PREFIX_WINDOWS windows of engine="pdhg" at phase 7(b)'s
    instance take the reference's restart decisions and statuses, each
    package's trace obeys the vanilla restart rule, and the KKT errors
    agree within 1e-7 relative."""
    from minilp_tpu_torch.utils import pdhg_windows

    stop = PREFIX_WINDOWS * POPTS().pdhg_check_every
    ref, _ = reference_windows(matrix, stop)
    port, _ = port_windows(matrix, stop)
    assert ref.shape == port.shape == (PREFIX_WINDOWS, len(pdhg_windows.FIELDS))
    opts = POPTS(**pdhg_windows.OPTIONS)
    pdhg_windows.check_rule(ref, opts)
    pdhg_windows.check_rule(port, opts)
    assert pdhg_windows.parting(port, ref, opts)["parting_window"] is None
    col = pdhg_windows.FIELDS.index("err")
    assert np.all(np.abs(port[:, col] - ref[:, col]) <= 1e-7 * np.abs(ref[:, col]))


if __name__ == "__main__":
    # The reference's full trace at phase 7(b)'s instance, for
    # `python -m minilp_tpu_torch.utils.pdhg_windows --with OUT.npz`:
    #     JAX_PLATFORMS=cpu python -m tests.test_torch_pdhg {dense|sparse} OUT.npz
    import sys

    trace, state = reference_windows(sys.argv[1])
    np.savez(sys.argv[2], trace=trace)
    print(f"reference {sys.argv[1]}: {len(trace)} windows, {int(state.niter)} iterations, "
          f"status {int(state.status)}")
