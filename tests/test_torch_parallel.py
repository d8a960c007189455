"""PyTorch port, the multi-device engines against the single-device ones.

The cases of `tests/test_parallel.py`, on the same instances (the JAX
package's generators, as numpy), run through the port's sharded engines in
ONE local world of 4 CPU ranks under gloo (`parallel.launch.run_world`,
module-scoped): a (1, 4) mesh for the column-sharded cases, (4, 1) for
the sharded batch, (2, 2) for the dry run.  The row-sharded PDHG cases run
at the same time in a world of their own, 2 ranks on a (1, 2) mesh (its
rows over a model axis of 2, as `tests/test_parallel.py` shards them): one
gloo all-reduce costs 0.3 ms over 2 ranks here against 0.8 ms over 4, and
seed 502 takes 65792 iterations, each with one.  Each sharded result is held
against the port's single-device engine on the same inputs (the same pivot
sequence: status, niter, basis; objectives within 1e-9) and against the JAX
package's single-device engine.  `tests/test_parallel.py` holds the JAX
package's column-sharded engines against that same single-device engine on
these instances; its sharded simplex calls take 12–24 s each here, so this
file does not repeat them.  The row-sharded PDHG cases are also held
against the JAX package's `solve_pdhg_sharded` on a (1, 2) mesh of this
process's virtual CPU devices (a few seconds in all).  The dual re-solve is
also fed the JAX package's own warm state (basis, vstat, B⁻¹ as numpy).
The launcher's failure paths get worlds of their own.
"""

from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import minilp_tpu
import minilp_tpu_torch
from minilp_tpu import Status, VarStat
from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.engine import incremental as ref_incremental
from minilp_tpu.engine.driver import EngineHandle as RefHandle
from minilp_tpu.engine.dual import resolve_dual as ref_resolve_dual
from minilp_tpu.engine.primal import solve_canonical as ref_solve_canonical
from minilp_tpu.ops.pricing import choose_entering as ref_choose_entering
from minilp_tpu.parallel import batched as ref_batched
from minilp_tpu.parallel import mesh as ref_mesh
from minilp_tpu.parallel.pdhg_sharded import solve_pdhg_sharded as ref_solve_pdhg_sharded
from minilp_tpu_torch.engine import incremental
from minilp_tpu_torch.engine.driver import EngineHandle
from minilp_tpu_torch.engine.dual import resolve_dual
from minilp_tpu_torch.engine.pdhg import solve_pdhg
from minilp_tpu_torch.engine.primal import solve_canonical
from minilp_tpu_torch.ops.pricing import choose_entering
from minilp_tpu_torch.parallel import batched
from minilp_tpu_torch.parallel.distributed import _OPTS, _random_batch
from minilp_tpu_torch.parallel.launch import run_world

from .oracle import random_problem
from .torch_helpers import as_torch_problem, f64, rel_err

WORLD = 4
COLS, ROWS, BATCH, DRY = (1, 4), (1, 2), (4, 1), None
TIMEOUT_S = 600.0
OPTS = minilp_tpu_torch.SolverOptions(device="cpu")
PDHG_OPTS = minilp_tpu_torch.SolverOptions(engine="pdhg", feas_tol=1e-7, device="cpu")
M = "minilp_tpu_torch.parallel."


def _np(*xs):
    """Copies as numpy (an edit mutates the canonical arrays in place)."""
    return [np.array(x) for x in xs]


def _jax_batch(seed, B, m, nv):
    return _np(*ref_batched.make_random_batch(jax.random.PRNGKey(seed), B, m, nv))


def _pricing_input(seed, n, choices):
    rng = np.random.default_rng(seed)
    return rng.normal(size=n), rng.choice(choices, size=n).astype(np.int8)


def _degenerate():
    m, nv = 8, 24
    n = nv + m
    A_s = np.zeros((m, nv))
    for k in range(3):  # three identical copies of each of 8 base columns
        A_s[:, 8 * k: 8 * (k + 1)] = np.eye(m)
    A = np.concatenate([A_s, np.eye(m)], axis=1)
    vstat0 = np.concatenate([np.full(nv, int(VarStat.AT_LOWER), np.int8),
                             np.full(m, int(VarStat.BASIC), np.int8)])
    return (A, np.ones(m), np.concatenate([-np.ones(nv), np.zeros(m)]), np.zeros(n),
            np.concatenate([np.full(nv, 2.0), np.full(m, np.inf)]), vstat0,
            np.arange(nv, nv + m))


def _port_edit(can_arrays, prob, coeffs, rhs_shift, opts):
    """The port's single-device cold solve, then one `<=` row appended through
    `incremental._append_row` (as the JAX test does): (can2 arrays, warm
    state after the edit, cold state)."""
    can = minilp_tpu_torch.canonical.canonicalize(prob, extra_row_capacity=4)
    for mine, ref in zip((can.A, can.b, can.c, can.lo, can.hi), can_arrays):
        np.testing.assert_array_equal(mine, ref)
    state = solve_canonical(*f64(can.A, can.b, can.c, can.lo, can.hi),
                            torch.as_tensor(can.vstat0), torch.as_tensor(can.basis0), opts)
    handle = EngineHandle(can, state, prob, opts)
    val = float(coeffs @ handle._x_full()[: can.nv]) if rhs_shift is not None else None
    incremental._append_row(handle, coeffs, minilp_tpu_torch.ComparisonOp.Le,
                            val - rhs_shift if rhs_shift is not None else -1.0)
    c2 = handle.can
    warm = _np(handle.state.basis, handle.state.vstat, handle.state.Binv)
    return _np(c2.A, c2.b, c2.c, c2.lo, c2.hi), warm, state


def _ref_edit(prob, coeffs, rhs_shift, opts):
    """The same edit in the JAX package: (can arrays, can2 arrays, its warm
    state after the edit, its dual re-solve)."""
    can = ref_canonicalize(prob, extra_row_capacity=4, dtype=np.float64)
    arrays = _np(can.A, can.b, can.c, can.lo, can.hi)
    state = ref_solve_canonical(*map(jnp.asarray, arrays), jnp.asarray(can.vstat0),
                                jnp.asarray(can.basis0), opts)
    handle = RefHandle(can, state, prob, opts)
    val = float(coeffs @ handle._x_full()[: can.nv]) if rhs_shift is not None else None
    ref_incremental._append_row(handle, coeffs, minilp_tpu.ComparisonOp.Le,
                                val - rhs_shift if rhs_shift is not None else -1.0)
    c2 = handle.can
    arrays2 = _np(c2.A, c2.b, c2.c, c2.lo, c2.hi)
    warm = _np(handle.state.basis, handle.state.vstat, handle.state.Binv)
    dual = ref_resolve_dual(*map(jnp.asarray, arrays2), *warm, opts)
    return arrays, arrays2, warm, state, dual


def _infeasible_problem(pkg):
    prob = pkg.Problem(pkg.OptimizationDirection.Maximize)
    x = prob.add_var(1.0, (0.0, 5.0))
    y = prob.add_var(1.0, (0.0, 5.0))
    prob.add_constraint(x + y, pkg.ComparisonOp.Ge, 2.0)
    return prob


@pytest.fixture(scope="module")
def world():
    """Every case's inputs, one 4-rank world computing every sharded call
    (in a thread, while this process computes the references), and the
    references: {case: (sharded result per rank, reference dict)}."""
    from minilp_tpu.options import SolverOptions as RefOptions

    calls, refs, keys = {WORLD: [], 2: []}, {}, {WORLD: [], 2: []}

    def call(key, shape, fn, *args, **kwargs):
        world = 2 if shape == ROWS else WORLD
        keys[world].append(key)
        calls[world].append((shape, M + fn, args, kwargs))

    batch = _jax_batch(1, 32, 5, 7)
    call("batch", BATCH, "batched:solve_batch_sharded", *batch, opts=OPTS)
    states = [0, 1, 2, 3, 4]  # AT_LOWER, AT_UPPER, FREE, FIXED, BASIC
    pricing = {f"pricing{s}": (_pricing_input(s, 256, states), False) for s in range(6)}
    pricing["bland"] = (_pricing_input(99, 128, states), True)
    d_tie = np.zeros(128)
    d_tie[10] = d_tie[100] = -5.0  # same |d| on the first and the last rank
    pricing["tie"] = ((d_tie, np.full(128, int(VarStat.AT_LOWER), np.int8)), False)
    for key, ((d, vstat), bland) in pricing.items():
        call(key, COLS, "pricing:choose_entering_sharded", d, vstat, 1e-8, bland=bland)
    full = {seed: [x[0] for x in _jax_batch(100 + seed, 1, 16, 48)] for seed in range(4)}
    for seed, args in full.items():
        call(f"full{seed}", COLS, "sharded_engine:solve_canonical_sharded", *args,
             minilp_tpu_torch.SolverOptions(max_iter=2000, device="cpu"))
    degenerate = _degenerate()
    call("degenerate", COLS, "sharded_engine:solve_canonical_sharded", *degenerate,
         minilp_tpu_torch.SolverOptions(max_iter=200, device="cpu"))
    warm_opts = minilp_tpu_torch.SolverOptions(presolve=False, max_iter=2000, device="cpu")
    for seed in range(3):
        rng = np.random.default_rng(7100 + seed)
        prob = random_problem(rng, nv=12, m=6, frac_free=0.0, frac_boxed=1.0, frac_fixed=0.0)
        coeffs = rng.normal(size=prob.num_vars)
        arrays, arrays2, ref_warm, ref_state, ref_dual = _ref_edit(
            prob, coeffs, 0.25, RefOptions(presolve=False, max_iter=2000))
        twin = as_torch_problem(prob, presolve=False, max_iter=2000)
        can2, warm, state = _port_edit(arrays, twin, coeffs, 0.25, warm_opts)
        np.testing.assert_array_equal(can2[0], arrays2[0])
        can0 = minilp_tpu_torch.canonical.canonicalize(twin, extra_row_capacity=4)
        call(f"warm{seed}", COLS, "sharded_engine:solve_canonical_sharded",
             *arrays, can0.vstat0, can0.basis0, warm_opts)
        call(f"dual{seed}", COLS, "sharded_engine:resolve_dual_sharded", *can2, *warm,
             warm_opts)
        call(f"dual_ref_state{seed}", COLS, "sharded_engine:resolve_dual_sharded",
             *arrays2, *ref_warm, warm_opts)
        refs[f"warm{seed}"] = dict(state=state, ref_state=ref_state,
                                   dual=resolve_dual(*f64(*can2), *warm, warm_opts),
                                   ref_dual=ref_dual,
                                   dual_from_ref=resolve_dual(*f64(*arrays2), *ref_warm, warm_opts))
    inf_opts = minilp_tpu_torch.SolverOptions(presolve=False, device="cpu")
    arrays, arrays2, ref_warm, _, ref_dual = _ref_edit(
        _infeasible_problem(minilp_tpu), np.array([1.0, 1.0]), None, RefOptions(presolve=False))
    twin = _infeasible_problem(minilp_tpu_torch)
    twin.options = inf_opts
    can2, warm, _ = _port_edit(arrays, twin, np.array([1.0, 1.0]), None, inf_opts)
    call("infeasible_cut", COLS, "sharded_engine:resolve_dual_sharded", *can2, *warm, inf_opts)
    refs["infeasible_cut"] = dict(dual=resolve_dual(*f64(*can2), *warm, inf_opts),
                                  ref_dual=ref_dual)
    pdhg_in = {seed: [x[0] for x in _jax_batch(500 + seed, 1, 11, 20)][:5] for seed in range(3)}
    for seed, args in pdhg_in.items():
        call(f"pdhg{seed}", ROWS, "pdhg_sharded:solve_pdhg_sharded", *args, PDHG_OPTS)
    repeat = [x[0] for x in _jax_batch(900, 1, 12, 16)][:5]
    call("pdhg_repeat_a", ROWS, "pdhg_sharded:solve_pdhg_sharded", *repeat, PDHG_OPTS)
    call("pdhg_repeat_b", ROWS, "pdhg_sharded:solve_pdhg_sharded", *repeat, PDHG_OPTS)
    farkas = (np.array([[1.0, 1.0], [0.0, 1.0]]), np.array([-1.0, 5.0]), np.array([1.0, 0.0]),
              np.zeros(2), np.full(2, np.inf))
    call("pdhg_farkas", ROWS, "pdhg_sharded:solve_pdhg_sharded", *farkas, PDHG_OPTS)
    call("scaling", DRY, "distributed:measure_scaling", 2, batch_per_device=8, m=6, nv=8)
    call("dryrun", DRY, "distributed:dryrun_multichip", WORLD)

    with ThreadPoolExecutor(2) as pool:
        futs = {n: pool.submit(run_world, M + "launch:run_calls", n, backend="gloo",
                               device="cpu", args=(calls[n],), timeout_s=TIMEOUT_S)
                for n in calls}
        refs["batch"] = dict(port=batched.solve_batch(*f64(*batch[:5]), *map(torch.as_tensor, batch[5:]),
                                                      opts=OPTS),
                             ref=ref_batched.solve_batch(*map(jnp.asarray, batch),
                                                         opts=RefOptions()))
        for key, ((d, vstat), bland) in pricing.items():
            refs[key] = dict(port=choose_entering(torch.as_tensor(d), torch.as_tensor(vstat),
                                                  1e-8, bland),
                             ref=ref_choose_entering(jnp.asarray(d), jnp.asarray(vstat), 1e-8,
                                                     jnp.bool_(bland)))
        for seed, args in full.items():
            refs[f"full{seed}"] = dict(
                port=solve_canonical(*f64(*args[:5]), *map(torch.as_tensor, args[5:]),
                                     minilp_tpu_torch.SolverOptions(max_iter=2000, device="cpu")),
                ref=ref_solve_canonical(*map(jnp.asarray, args), RefOptions(max_iter=2000)))
        refs["degenerate"] = dict(
            port=solve_canonical(*f64(*degenerate[:5]), *map(torch.as_tensor, degenerate[5:]),
                                 minilp_tpu_torch.SolverOptions(max_iter=200, device="cpu")),
            ref=ref_solve_canonical(*map(jnp.asarray, degenerate), RefOptions(max_iter=200)))
        # the JAX package's row-sharded PDHG, its rows over 2 devices as here
        mesh2 = ref_mesh.make_mesh(1, 2, devices=jax.devices()[:2])
        ref_pdhg = lambda args: ref_solve_pdhg_sharded(
            *map(jnp.asarray, args), RefOptions(engine="pdhg", feas_tol=1e-7), mesh2)
        for seed, args in pdhg_in.items():
            refs[f"pdhg{seed}"] = dict(port=solve_pdhg(*f64(*args), opts=PDHG_OPTS),
                                       ref=ref_pdhg(args))
        refs["pdhg_repeat_a"] = dict(ref=ref_pdhg(repeat))
        refs["pdhg_farkas"] = dict(ref=ref_pdhg(farkas))
        refs["dryrun"] = _dryrun_references()
        out = {}
        for n, fut in futs.items():
            ranks = fut.result()
            out.update({key: ([r[i] for r in ranks], refs.get(key))
                        for i, key in enumerate(keys[n])})
    return out


def _dryrun_references():
    """The dry run's steps on its own instances through the port's
    single-device engines and the JAX package's (statuses)."""
    A1, b1, c1, lo1, hi1, vs1, bs1 = [x[0] for x in _random_batch(3, 1, 8, 16)]
    tp = solve_canonical(A1, b1, c1, lo1, hi1, vs1, bs1, _OPTS)
    hi2 = hi1.clone()
    hi2[:16] = torch.clamp(hi2[:16], max=0.35)
    dual = resolve_dual(A1, b1, c1, lo1, hi2, tp.basis, tp.vstat, tp.Binv, _OPTS)
    from minilp_tpu.options import SolverOptions as RefOptions
    ref_tp = ref_solve_canonical(*map(jnp.asarray, _np(A1, b1, c1, lo1, hi1, vs1, bs1)),
                                 RefOptions(max_iter=500))
    ref_dual = ref_resolve_dual(*map(jnp.asarray, _np(A1, b1, c1, lo1, hi2)),
                                ref_tp.basis, ref_tp.vstat, ref_tp.Binv, RefOptions(max_iter=500))
    return dict(tp=tp, dual=dual, ref_tp=ref_tp, ref_dual=ref_dual)


def _same_solve(got, port, ref, *, exact_basis=False):
    """The sharded solve took the single-device pivot sequence."""
    assert int(got["status"]) == int(port.status) == int(ref.status)
    assert int(got["niter"]) == int(port.niter) == int(ref.niter)
    order = (lambda v: np.asarray(v)) if exact_basis else (lambda v: np.sort(np.asarray(v)))
    np.testing.assert_array_equal(order(got["basis"]), order(port.basis))
    np.testing.assert_array_equal(order(got["basis"]), order(ref.basis))
    assert rel_err(float(got["obj"]), float(port.obj)) <= 1e-9
    assert rel_err(float(got["obj"]), float(ref.obj)) <= 1e-9


def test_every_rank_returns_the_whole_result(world):
    for key, (ranks, _ref) in world.items():
        for other in ranks[1:]:
            a, b = ranks[0]["result"], other["result"]
            if isinstance(a, dict):
                for field in a:
                    np.testing.assert_array_equal(np.asarray(a[field]), np.asarray(b[field]),
                                                  err_msg=f"{key}.{field}")
            elif key != "dryrun":
                assert a == b, key


def test_batched_sharded_equals_unsharded(world):
    ranks, ref = world["batch"]
    got, port = ranks[0]["result"], ref["port"]
    # bit-identical results lane by lane (same program, partitioned data)
    for field in ("obj", "niter", "basis", "status", "xB", "vstat"):
        np.testing.assert_array_equal(got[field], getattr(port, field).numpy())
    np.testing.assert_array_equal(got["niter"], np.asarray(ref["ref"].niter))
    np.testing.assert_array_equal(got["basis"], np.asarray(ref["ref"].basis))
    for a, b in zip(got["obj"], np.asarray(ref["ref"].obj)):
        assert rel_err(float(a), float(b)) <= 1e-9


@pytest.mark.parametrize("key", [f"pricing{s}" for s in range(6)] + ["bland", "tie"])
def test_sharded_pricing_matches_single_device(world, key):
    ranks, ref = world[key]
    got = ranks[0]["result"]
    port, jref = ref["port"], ref["ref"]
    assert bool(got["found"]) == port.found == bool(jref.found)
    if port.found:
        assert int(got["q"]) == port.q == int(jref.q)
        assert float(got["direction"]) == port.direction == float(jref.direction)
    if key == "tie":
        assert int(got["q"]) == 10  # the lower global index wins


@pytest.mark.parametrize("seed", range(4))
def test_column_sharded_full_solve_matches_engine(world, seed):
    ranks, ref = world[f"full{seed}"]
    _same_solve(ranks[0]["result"], ref["port"], ref["ref"])


def test_column_sharded_degenerate_ties_deterministic(world):
    # all non-basic values are 0, so even refactorize's partial sums are
    # exact: the basis in order and the objective bit for bit, against the
    # port's single-device engine and the JAX package's
    ranks, ref = world["degenerate"]
    got, port, jref = ranks[0]["result"], ref["port"], ref["ref"]
    assert int(got["status"]) == int(port.status) == int(jref.status) == int(Status.OPTIMAL)
    assert int(got["niter"]) == int(port.niter) == int(jref.niter)
    np.testing.assert_array_equal(got["basis"], port.basis.numpy())
    np.testing.assert_array_equal(got["basis"], np.asarray(jref.basis))
    assert float(got["obj"]) == float(port.obj) == float(jref.obj)


@pytest.mark.parametrize("seed", range(3))
def test_sharded_warm_state_and_dual_resolve(world, seed):
    cold = world[f"warm{seed}"][0][0]["result"]
    dual = world[f"dual{seed}"][0][0]["result"]
    ref = world[f"warm{seed}"][1]
    state = ref["state"]
    assert int(state.status) == int(Status.OPTIMAL)
    assert int(cold["status"]) == int(Status.OPTIMAL)
    assert cold["Binv"].shape == tuple(state.Binv.shape)
    np.testing.assert_allclose(cold["xB"], state.xB.numpy(), rtol=1e-9, atol=1e-9)
    np.testing.assert_allclose(cold["xB"], np.asarray(ref["ref_state"].xB), rtol=1e-9, atol=1e-9)
    _same_solve(dual, ref["dual"], ref["ref_dual"])


@pytest.mark.parametrize("seed", range(3))
def test_sharded_dual_resolve_from_reference_state(world, seed):
    # the JAX package's warm state after the edit, carried across packages
    got = world[f"dual_ref_state{seed}"][0][0]["result"]
    ref = world[f"warm{seed}"][1]
    _same_solve(got, ref["dual_from_ref"], ref["ref_dual"])


def test_sharded_dual_resolve_detects_infeasible(world):
    ranks, ref = world["infeasible_cut"]
    assert int(ref["ref_dual"].status) == int(Status.INFEASIBLE)
    assert int(ref["dual"].status) == int(Status.INFEASIBLE)
    assert int(ranks[0]["result"]["status"]) == int(Status.INFEASIBLE)


@pytest.mark.parametrize("seed", range(3))
def test_row_sharded_pdhg_matches_unsharded(world, seed):
    # M = 11 does not divide over 2 ranks: the inert zero-row padding
    # against the port's single-device PDHG and the JAX package's
    # row-sharded one
    ranks, ref = world[f"pdhg{seed}"]
    got = ranks[0]["result"]
    A, b, c, lo, hi = [x[0] for x in _jax_batch(500 + seed, 1, 11, 20)][:5]
    for other in (ref["port"], ref["ref"]):
        x, y = np.asarray(other.x), np.asarray(other.y)
        assert int(other.status) == int(got["status"]) == int(Status.OPTIMAL)
        assert int(other.niter) == int(got["niter"])
        obj_ref = float(c @ x)
        assert abs(float(c @ got["x"]) - obj_ref) <= 1e-6 * (1 + abs(obj_ref))
        np.testing.assert_allclose(got["x"], x, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(got["y"], y, rtol=1e-4, atol=1e-6)
    assert got["y"].shape == (11,)


def test_row_sharded_pdhg_deterministic(world):
    (ranks, ref), b = world["pdhg_repeat_a"], world["pdhg_repeat_b"][0][0]["result"]
    a = ranks[0]["result"]
    np.testing.assert_array_equal(a["x"], b["x"])
    np.testing.assert_array_equal(a["y"], b["y"])
    assert int(a["niter"]) == int(b["niter"])
    # and the JAX package's row-sharded run on the same input
    assert int(a["status"]) == int(ref["ref"].status)
    assert int(a["niter"]) == int(ref["ref"].niter)
    np.testing.assert_allclose(a["x"], np.asarray(ref["ref"].x), rtol=1e-4, atol=1e-6)
    np.testing.assert_allclose(a["y"], np.asarray(ref["ref"].y), rtol=1e-4, atol=1e-6)


def test_row_sharded_pdhg_detects_infeasible(world):
    ranks, ref = world["pdhg_farkas"]
    assert int(ref["ref"].status) == int(Status.INFEASIBLE)
    assert int(ranks[0]["result"]["status"]) == int(Status.INFEASIBLE)


def test_scaling_harness_smoke(world):
    # numbers are meaningless on ranks that share cores; assert structure
    r = world["scaling"][0][0]["result"]
    assert r["n_devices"] == 2 and r["backend"] == "cpu/gloo"
    assert r["lps_per_sec_1dev"] > 0 and r["lps_per_sec_ndev"] > 0
    assert 0 < r["efficiency"] < 4


def test_dryrun_multichip_matches_single_device(world):
    ranks, ref = world["dryrun"]
    line = ranks[0]["result"]
    assert all(r["result"] == line for r in ranks)
    assert line.startswith("dryrun_multichip OK: mesh={'data': 2, 'model': 2} ")
    assert (f"tp_solve=(status={int(ref['tp'].status)}, obj={float(ref['tp'].obj):.6f}, "
            f"iters={int(ref['tp'].niter)})") in line
    assert int(ref["tp"].status) == int(ref["ref_tp"].status) == int(Status.OPTIMAL)
    # the boxed instance is infeasible (HiGHS); the dual re-solve of both
    # packages runs to MAX_ITER on it (ROADMAP Queue 3)
    assert (f"tp_dual_resolve=(status={int(ref['dual'].status)}, "
            f"iters={int(ref['dual'].niter)})") in line
    assert int(ref["dual"].status) == int(ref["ref_dual"].status)
    assert int(ref["dual"].niter) == int(ref["ref_dual"].niter)
    assert f"pdhg_rowsharded=(status={int(Status.OPTIMAL)}," in line


@pytest.mark.parametrize("fail_rank,skip_rank", [(1, None), (None, 1)],
                         ids=["raising_rank", "rank_skips_a_collective"])
def test_launcher_fails_fast(fail_rank, skip_rank):
    with pytest.raises(RuntimeError) as err:
        run_world(M + "launch:world_probe", 2, backend="gloo", device="cpu",
                  args=(fail_rank, skip_rank), timeout_s=20.0)
    want = "fails on purpose" if fail_rank is not None else "rank 0 of 2"
    assert want in str(err.value)
