"""PyTorch port on the card: the CUDA kernels (K1, K2, K3) against their plain
versions, and the main path through each.  Every test here needs a CUDA
device and skips without one.

This file imports neither jax nor the JAX package, so that it runs on a
machine with the card and no jax; `tests/conftest.py` imports jax, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

from minilp_tpu_torch import (ComparisonOp, Infeasible, LinearExpr, OptimizationDirection,
                              Problem, SolverOptions, Variable)
from minilp_tpu_torch.canonical import canonicalize
from minilp_tpu_torch.engine import driver, hostlp
from minilp_tpu_torch.ops.kernels import basis_f64
from minilp_tpu_torch.ops.kernels import batched_simplex as bs
from minilp_tpu_torch.ops.kernels import certify
from minilp_tpu_torch.ops.kernels import packed_simplex as ps
from minilp_tpu_torch.ops.kernels import streaming_simplex as ss
from minilp_tpu_torch.parallel import batched, scheduling
from minilp_tpu_torch.presolve import presolve_problem
from minilp_tpu_torch.utils import profiling
from minilp_tpu_torch.utils.synth import (degenerate_problem, netlib_shaped_problem,
                                          network_flow_problem,
                                          random_batch)

pytestmark = pytest.mark.cuda

KW = dict(refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
          bland_after=200)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_and_plain(cuda, A, b, c, lo, hi, slack0, warm=None, **options):
    t = lambda x, dt=np.float32: torch.tensor(np.asarray(x, dtype=dt), device=cuda)
    args = [t(x) for x in (A, b, c, lo, hi)]
    if warm is not None:
        warm = (t(warm[0], np.int32), t(warm[1], np.int32), t(warm[2]))
    before = bs.launches
    kw = {**KW, "max_iter": 4000, **options}
    outs = [fn(*args, warm, slack0=slack0, **kw)
            for fn in (bs.simplex_kernel_call, bs.simplex_plain)]
    torch.cuda.synchronize()
    assert bs.launches == before + 1  # the plain version is no launch
    B, m, n = A.shape
    res = []
    for out in outs:
        h = out.cpu().numpy()
        obj, ver, _ = bs._verify_f64(A, b, c, lo, hi, h[:, :m], h[:, m:m + n], h[:, m + n])
        res.append((h[:, m + n], obj, ver))
    (st_k, obj_k, ver_k), (st_p, obj_p, ver_p) = res
    np.testing.assert_array_equal(st_k, st_p)
    np.testing.assert_array_equal(ver_k, ver_p)
    assert ver_k.all()
    assert np.all(np.abs(obj_k - obj_p) <= 1e-9 * (1.0 + np.abs(obj_p)))
    return outs[0].cpu().numpy()


def test_kernel_matches_plain_batch(cuda):
    A, b, c, lo, hi = random_batch(5, 16, 16, 48)
    _kernel_and_plain(cuda, A, b, c, lo, hi, slack0=48)


def test_kernel_matches_plain_warm_start(cuda):
    A, b, c, lo, hi = random_batch(6, 4, 12, 36)
    cold = bs.solve_batch_megakernel(A, b, c, lo, hi, device=cuda)
    assert cold.verified.all()
    Binv0 = np.stack([np.linalg.inv(A[i][:, cold.basis[i]]) for i in range(4)])
    hi2 = hi.copy()
    hi2[:, :36] = np.minimum(hi2[:, :36], 0.5)  # cut every structural box
    _kernel_and_plain(cuda, A, b, c, lo, hi2, slack0=36,
                      warm=(cold.basis, cold.vstat, Binv0))


@pytest.mark.parametrize("case", ["cold", "warm", "phase1"])
def test_k1_wide_matches_one_block(cuda, case):
    """A one-LP K1 launch on its default cooperative grid and on one block:
    the out rows (basis, vstat, status, niter) and the bits of the final
    B⁻¹ are equal.  "phase1" is an all-equality network flow, whose slack
    basis is infeasible everywhere."""
    if case == "phase1":
        prob = network_flow_problem(60, 200, seed=4)
    else:
        prob = netlib_shaped_problem(70, 150, 0.08, seed=2)
    can = canonicalize(presolve_problem(prob)[0])
    kw = dict(KW, slack0=can.nv, max_iter=4000, refactor_period=16)
    hi, warm = can.hi, None
    if case == "warm":
        cold = bs.solve_batch_megakernel(can.A[None], can.b[None], can.c[None], can.lo[None],
                                         can.hi[None], device=cuda, **kw)
        assert cold.verified.all()
        basis = cold.basis[0]
        j = max((int(k) for k in basis if k < can.nv), key=lambda k: cold.x[0][k] - can.lo[k])
        hi = can.hi.copy()
        hi[j] = 0.5 * (can.lo[j] + cold.x[0][j])
        t = lambda x, dt: torch.tensor(np.asarray(x, dtype=dt)[None], device=cuda)
        warm = (t(basis, np.int32), t(cold.vstat[0], np.int32),
                t(np.linalg.inv(can.A[:, basis]), np.float32))
    args = [torch.tensor(np.asarray(x, dtype=np.float32)[None], device=cuda)
            for x in (can.A, can.b, can.c, can.lo, hi)]
    m, n = can.A.shape
    assert bs.default_blocks(cuda, m, n) > 1
    before = bs.launches
    (wide, ws_wide), (one, ws_one) = (bs._launch(*args, warm, blocks=g, **kw) for g in (None, 1))
    torch.cuda.synchronize()
    assert bs.launches == before + 2
    assert int(wide[0, -1]) > 0  # pivots
    assert torch.equal(wide, one)
    assert torch.equal(ws_wide[:m * m].view(torch.int32), ws_one[:m * m].view(torch.int32))


def test_main_path_goes_through_the_kernel(cuda, tmp_path, monkeypatch):
    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    prob = netlib_shaped_problem(60, 150, 0.06, seed=11)
    cpu = netlib_shaped_problem(60, 150, 0.06, seed=11)
    cpu.options = SolverOptions(device="cpu", use_megakernel="never")
    before = bs.launches
    sol = prob.solve()
    assert bs.launches == before + 1
    assert json.loads(log.read_text().splitlines()[-1])["event"] == "cold_solve_megakernel"
    assert sol._engine.certified
    want = cpu.solve().objective()
    assert abs(sol.objective() - want) <= 1e-9 * (1.0 + abs(want))


def test_degen2_pool_lp_goes_through_k1(cuda):
    """LP 0 of `degen2-cold`'s pool (`lpbench/workloads/degen2-cold.json`:
    pool seed 20261021) at Netlib degen2's 444 × 534: presolve merges its
    66 duplicated rows, K1 solves it at the main path's options as its
    plain version does (status, `verified`, certified objective), and the
    main path answers from K1's basis without the f64 engine."""
    key = [20261021, 0, 0]
    red, stats = presolve_problem(degenerate_problem(444, 534, 9 / 534, seed=key))
    assert stats.parallel_rows == 66
    can = canonicalize(red)
    opts = SolverOptions()
    out = _kernel_and_plain(cuda, *(x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)),
                            slack0=can.nv, max_iter=opts.effective_max_iter(can.M, can.N),
                            opt_tol=driver._k1_opt_tol(can, opts))
    m, n = can.M, can.N
    obj = bs._verify_f64(*(x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)),
                         out[:, :m], out[:, m:m + n], out[:, m + n])[0][0]
    profiling.reset_stages()
    sol = degenerate_problem(444, 534, 9 / 534, seed=key).solve()
    stages = profiling.stages(None)
    assert stages["route.megakernel"] == 1 and "route.engine" not in stages
    assert stages["megakernel_pivots"] > 0
    assert abs(sol.objective() - obj) <= 1e-9 * (1.0 + abs(obj))


def test_readme_example_on_the_card(cuda):
    prob = Problem(OptimizationDirection.Maximize)
    x = prob.add_var(1.0, (0.0, None))
    y = prob.add_var(2.0, (0.0, 3.0))
    prob.add_constraint(x + y, ComparisonOp.Le, 4.0)
    sol = prob.solve()
    assert abs(sol.objective() - 7.0) <= 1e-12
    assert (sol[x], sol[y]) == pytest.approx((1.0, 3.0), abs=1e-12)


def test_f64_engine_on_the_card(cuda):
    """use_megakernel="never" on the card: the f64 torch engine runs there
    and certifies the optimum the CPU run certifies."""
    got, want = [netlib_shaped_problem(30, 80, 0.1, seed=3) for _ in range(2)]
    got.options = SolverOptions(use_megakernel="never")
    want.options = SolverOptions(device="cpu", use_megakernel="never")
    before = bs.launches
    sol, ref = got.solve(), want.solve()
    assert bs.launches == before
    assert sol._engine.certified and ref._engine.certified
    assert abs(sol.objective() - ref.objective()) <= 1e-9 * (1.0 + abs(ref.objective()))


# ---- K2, the streaming kernel ------------------------------------------------

def _k2_kernel_and_plain(cuda, A, b, c, lo, hi, slack0, **options):
    """K2 and its plain version on `solve_streaming`'s first launch, with a
    short refresh period so that small LPs refresh too."""
    options = {**dict(tile_n=16, refactor_period=16, max_iter=4000), **options}
    launch = ss.prepare_launch(A, b, c, lo, hi, device=cuda, slack0=slack0, **options)
    before = ss.launches
    outs = [fn(*launch.args, launch.warm, **launch.kw)
            for fn in (ss.stream_kernel_call, ss.stream_plain)]
    torch.cuda.synchronize()
    assert ss.launches == before + 1  # the plain version is no launch
    res = []
    for out in outs:
        mon = out.monitor.cpu().numpy()
        obj, ver, _ = bs._verify_f64(launch.A[None], launch.b[None], launch.c[None],
                                     launch.lo[None], launch.hi[None],
                                     out.basis.cpu().numpy()[None],
                                     out.vstat.cpu().numpy()[None], mon[:1])
        res.append((int(mon[0]), float(obj[0]), bool(ver[0])))
    (st_k, obj_k, ver_k), (st_p, obj_p, ver_p) = res
    assert (st_k, ver_k) == (st_p, ver_p)
    assert ver_k
    assert abs(obj_k - obj_p) <= 1e-9 * (1.0 + abs(obj_p))
    return outs[0]


#: test_k2_kernel_matches_plain's cases: netlib_shaped_problem's shape and
#: `prepare_launch` options
K2_PLAIN_CASES = {
    False: ((70, 150, 0.08), dict(long_step_min_m=2048)),
    True: ((70, 150, 0.08), dict(long_step_min_m=0)),
    # 1336 rows, about 7600 pivots in one launch
    "m1336": ((1340, 1440, 0.004), dict(long_step_min_m=2048, max_iter=20000, chunk_iters=None)),
    # minor_k = 128: the lane scan's warp takes four lanes a thread
    "minor_k128": ((400, 900, 0.01), dict(long_step_min_m=2048, minor_k=128)),
}


@pytest.mark.parametrize("case", list(K2_PLAIN_CASES))
def test_k2_kernel_matches_plain(cuda, case):
    """K2 against its plain version, at small and large m and minor_k."""
    shape, options = K2_PLAIN_CASES[case]
    can = canonicalize(presolve_problem(netlib_shaped_problem(*shape, seed=2))[0])
    _k2_kernel_and_plain(cuda, can.A, can.b, can.c, can.lo, can.hi, slack0=can.nv, **options)


def test_k2_kernel_matches_plain_warm_start(cuda):
    A, b, c, lo, hi = [x[0] for x in random_batch(21, 1, 16, 32)]
    cold = ss.solve_streaming(A, b, c, lo, hi, device=cuda, tile_n=16)
    assert cold.verified
    hi2 = hi.copy()
    hi2[:32] = np.minimum(hi2[:32], 0.4)
    warm = (cold.basis, cold.vstat, np.linalg.inv(A[:, cold.basis]))
    out = _k2_kernel_and_plain(cuda, A, b, c, lo, hi2, slack0=32, warm_state=warm)
    assert int(out.monitor[1]) > 0


@pytest.mark.parametrize("seed", [2, 11])
@pytest.mark.parametrize("route", ["megakernel", "streaming"])
def test_warm_resolves_through_the_api_match_plain(cuda, route, seed):
    """The incremental API with a kernel forced: on the card every re-solve
    launches K1 (or K2) warm; on the CPU the same edits run its plain
    version.  Each edit, chosen from the CPU run's values, gives the same
    outcome, certified flag and objective within 1e-9 relative."""
    mod, options = {"megakernel": (bs, dict(use_megakernel="always")),
                    "streaming": (ss, dict(use_streaming="always",
                                           use_megakernel="never"))}[route]
    sols = {}
    for dev in ("cuda", "cpu"):
        prob = netlib_shaped_problem(60, 150, 0.06, seed=seed)
        prob.options = SolverOptions(device=dev, **options)
        sols[dev] = prob.solve()
    rng = np.random.default_rng(5)
    before = mod.launches

    def both(edit, *args):
        out = {}
        for dev in ("cuda", "cpu"):
            try:
                res = getattr(sols[dev], edit)(*args)
            except Infeasible:
                out[dev] = None
                continue
            sols[dev] = res[1] if edit == "unfix_var" else res
            out[dev] = sols[dev]
        assert (out["cuda"] is None) == (out["cpu"] is None), edit
        if out["cpu"] is not None:
            got, want = out["cuda"], out["cpu"]
            assert got._engine.certified and want._engine.certified
            assert abs(got.objective() - want.objective()) <= 1e-9 * (1.0 + abs(want.objective()))
        return out["cpu"] is not None

    edits = 0
    for _k in range(3):
        js = rng.choice(150, size=8, replace=False)
        coeffs = rng.normal(size=8)
        val = sum(float(cf) * sols["cpu"][Variable(int(j))] for cf, j in zip(coeffs, js))
        expr = LinearExpr((float(cf), Variable(int(j))) for cf, j in zip(coeffs, js))
        edits += 1
        if not both("add_constraint", expr, ComparisonOp.Le, val - 0.05):
            break
    else:
        h = sols["cpu"]._engine
        x = h._x_full()
        j = max((int(k) for k in h._state.basis if k < h.can.nv), key=lambda k: x[k] - h.can.lo[k])
        both("fix_var", Variable(j), 0.5 * (h.can.lo[j] + x[j]))
        both("unfix_var", Variable(j))
        edits += 2
    torch.cuda.synchronize()
    assert mod.launches >= before + edits


def _k2_bits(out):
    return [t.view(torch.int32).reshape(-1).cpu() for t in out]


#: test_k2_wide_matches_one_block's cases: (netlib_shaped_problem's shape and
#: seed, `prepare_launch` options, blocks of the wide launch: None for
#: `default_blocks`, dict(extra=e) for the default plus e blocks that get no
#: row of Aᵀ in pricing, or dict(blocks=g) for g blocks)
K2_WIDE_CASES = {
    "cold": ((70, 150, 0.08, 2), {}, None),
    "warm": ((70, 150, 0.08, 2), {}, None),
    "long_step": ((70, 150, 0.08, 2), dict(long_step_min_m=0), None),
    # Bland from the first major: one candidate, the lowest eligible column
    "bland": ((70, 150, 0.08, 2), dict(bland_after=0), None),
    "minor_k_1": ((70, 150, 0.08, 2), dict(minor_k=1), None),
    "minor_k_128": ((70, 150, 0.08, 2), dict(minor_k=128), None),
    # 64 nonbasic columns at most: always fewer eligible than minor_k
    "few_eligible": ((60, 60, 0.1, 2), dict(minor_k=128), None),
    "idle_blocks": ((70, 150, 0.08, 2), {}, dict(extra=8)),
    # more than one column a thread in every block: each block builds its
    # list by repeated argmax, and the merge joins two such lists
    "many_columns": ((100, 1200, 0.03, 2), {}, dict(blocks=2)),
    # 304 x 1280: every product of the refresh has several row and column
    # units; on 3 blocks more units than blocks, on the default grid the
    # smallest unit shapes
    "refresh_units": ((300, 900, 0.02, 2), {}, None),
    "refresh_units_3": ((300, 900, 0.02, 2), {}, dict(blocks=3)),
}


@pytest.mark.parametrize("case", list(K2_WIDE_CASES))
def test_k2_wide_matches_one_block(cuda, case):
    """K2 on its default cooperative grid (or a wider one) and on one block:
    basis, vstat, the bits of B⁻¹ and the monitor are equal bit for bit."""
    shape, over, wide_blocks = K2_WIDE_CASES[case]
    can = canonicalize(presolve_problem(netlib_shaped_problem(*shape[:3], seed=shape[3]))[0])
    options = dict(device=cuda, slack0=can.nv, refactor_period=16, max_iter=4000,
                   long_step_min_m=2048)
    options.update(over)
    hi = can.hi
    if case == "warm":
        cold = ss.solve_streaming(can.A, can.b, can.c, can.lo, can.hi, **options)
        assert cold.verified
        struct = [int(j) for j in cold.basis if j < can.nv]
        j = max(struct, key=lambda k: cold.x[k] - can.lo[k])
        hi = can.hi.copy()
        hi[j] = 0.5 * (can.lo[j] + cold.x[j])
        options["warm_state"] = (cold.basis, cold.vstat, np.linalg.inv(can.A[:, cold.basis]))
    launch = ss.prepare_launch(can.A, can.b, can.c, can.lo, hi, **options)
    m, n = launch.A.shape
    blocks = ss.default_blocks(cuda, m, n)
    assert blocks > 1
    if wide_blocks and "extra" in wide_blocks:
        assert blocks == -(-n // 16)  # a warp a row of Aᵀ: the extra blocks get none
        blocks += wide_blocks["extra"]
    elif wide_blocks:
        blocks = wide_blocks["blocks"]
        if case == "many_columns":
            # block r's columns pass 512 (a warp a row, 32 rows a pass) when
            # ((32 blocks + r) 16) < n, for every r < blocks
            assert n > 16 * (33 * blocks - 1)
    if case.startswith("refresh_units"):
        assert m > 256 and n > 1024
    before = ss.launches
    wide, one = (ss.stream_kernel_call(*launch.args, launch.warm, blocks=g, **launch.kw)
                 for g in (blocks, 1))
    torch.cuda.synchronize()
    assert ss.launches == before + 2
    assert int(wide.monitor[1]) > 0 and int(wide.monitor[6]) > 0  # pivots, refreshes
    if case == "bland":  # a Bland major takes at most one pivot
        assert int(wide.monitor[5]) >= int(wide.monitor[1])
    for name, a, b in zip(wide._fields, _k2_bits(wide), _k2_bits(one)):
        diff = torch.nonzero(a != b)
        assert diff.numel() == 0, f"{name} differs first at flat index {int(diff[0])}"


def test_main_path_goes_through_k2(cuda, tmp_path, monkeypatch):
    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    prob = netlib_shaped_problem(70, 150, 0.08, seed=2)
    prob.options = SolverOptions(use_streaming="always", use_megakernel="never")
    cpu = netlib_shaped_problem(70, 150, 0.08, seed=2)
    cpu.options = SolverOptions(device="cpu", use_megakernel="never")
    before = ss.launches
    sol = prob.solve()
    assert ss.launches == before + 1
    assert json.loads(log.read_text().splitlines()[-1])["event"] == "cold_solve_streaming"
    assert sol._engine.certified
    want = cpu.solve().objective()
    assert abs(sol.objective() - want) <= 1e-9 * (1.0 + abs(want))


# ---- K3, the packed kernel ----------------------------------------------------

def _k3_kernel_and_plain(cuda, A, b, c, lo, hi, slack0, pack):
    """K3 twice and its plain version on the same device inputs."""
    args = ps.upload_packed(A, b, c, lo, hi, pack=pack, device=cuda)
    kw = dict(pack=pack, slack0=slack0, max_iter=4000, **KW)
    before = ps.launches
    outs = [fn(*args, **kw) for fn in (ps.packed_kernel_call, ps.packed_kernel_call,
                                       ps.packed_plain)]
    torch.cuda.synchronize()
    assert ps.launches == before + 2  # the plain version is no launch
    assert torch.equal(outs[0], outs[1])  # no read of uninitialised scratch
    got, want = (bs.verify_rows_f64(o.cpu().numpy(), A, b, c, lo, hi)
                 for o in (outs[0], outs[2]))
    np.testing.assert_array_equal(got.status, want.status)
    np.testing.assert_array_equal(got.verified, want.verified)
    assert got.verified.all()
    assert np.all(np.abs(got.obj - want.obj) <= 1e-9 * (1.0 + np.abs(want.obj)))
    return got


def test_k3_kernel_matches_plain_batch(cuda):
    A, b, c, lo, hi = random_batch(5, 16, 16, 48)  # two packs of 8
    _k3_kernel_and_plain(cuda, A, b, c, lo, hi, slack0=48, pack=8)


def test_k3_kernel_matches_plain_pack16(cuda):
    """Packs of 16 LPs: blocks of 512 threads, whose refresh keeps T in the
    workspace (the register tiles need at most 8 LPs a block)."""
    A, b, c, lo, hi = random_batch(5, 32, 16, 48)
    _k3_kernel_and_plain(cuda, A, b, c, lo, hi, slack0=48, pack=16)


def _replicated_canonical(m, nv, lanes=8):
    can = canonicalize(presolve_problem(netlib_shaped_problem(m, nv, 0.08, seed=2))[0])
    tile = lambda x: np.broadcast_to(x, (lanes,) + x.shape).copy()
    return tuple(tile(x) for x in (can.A, can.b, can.c, can.lo, can.hi)), can.nv


@pytest.mark.parametrize("m,nv", [(30, 60), (60, 150)])
def test_k3_kernel_matches_plain_replicated_canonical(cuda, m, nv):
    """A canonical instance replicated over two packs of 4; at 60 x 150 the
    pack's A no longer fits shared memory beside its workspace, and m > 32
    keeps both Newton temporaries."""
    lp, slack0 = _replicated_canonical(m, nv)
    got = _k3_kernel_and_plain(cuda, *lp, slack0=slack0, pack=4)
    assert (got.niter == got.niter[0]).all()  # identical lanes, identical pivots


def _heterogeneous_bucket():
    """The 24-row bucket of a mixed list, as `solve_heterogeneous` builds it."""
    lps = []
    for k, (count, m, nv) in enumerate([(16, 16, 48), (8, 24, 72)]):
        A, b, c, lo, hi = random_batch(60 + k, count, m, nv)
        lps += [(A[i], b[i], c[i], lo[i], hi[i]) for i in range(count)]
    bucket = scheduling.bucket_lps(lps, pack=8)[1][1]
    return bucket.batch, bucket.NV


@pytest.mark.parametrize("case", ["batch16", "bucket", "canonical30x60", "canonical60x150"])
def test_k3_layouts_bit_identical(cuda, case):
    """Every layout of K3 that fits the pack gives the same out rows bit for
    bit, the default (the first that fits) among them; a forced layout that
    does not fit raises ValueError before any launch."""
    pack = 8
    if case == "batch16":
        lp, slack0 = random_batch(5, 16, 16, 48), 48
    elif case == "bucket":
        lp, slack0 = _heterogeneous_bucket()
    else:
        lp, slack0 = _replicated_canonical(*{"canonical30x60": (30, 60),
                                             "canonical60x150": (60, 150)}[case])
        pack = 4
    _B, m, n = lp[0].shape
    args = ps.upload_packed(*lp, pack=pack, device=cuda)
    kw = dict(pack=pack, slack0=slack0, max_iter=4000, **KW)
    default = ps.packed_kernel_call(*args, **kw)
    fits = []
    for layout in ps.LAYOUTS:
        before = ps.launches
        try:
            out = ps.packed_kernel_call(*args, layout=layout, **kw)
        except ValueError:
            assert ps.launches == before
            continue
        fits.append(layout)
        torch.cuda.synchronize()
        assert torch.equal(out, default), f"layout {layout!r} differs from the default"
    assert fits[0] == ps.pick_layout(pack, m, n) and fits[-1] == "global"
    assert ("staged" in fits) == (case != "canonical60x150")
    assert int(default[..., -1].sum()) > 0  # pivots


def test_pipelined_goes_through_k3(cuda):
    batches = [random_batch(40 + k, 16, 12, 36) for k in range(2)]
    before, cert0 = ps.launches, certify.launches
    got = batched.solve_batches_pipelined(batches, device=cuda, pack=8, structural_cols=36)
    assert ps.launches == before + 2
    assert certify.launches == cert0 + 2  # one certificate a batch, on the card
    want = batched.solve_batches_pipelined(batches, device="cpu", pack=8)
    for g, w in zip(got, want):
        assert g.verified.all()
        np.testing.assert_allclose(g.obj, w.obj, rtol=1e-9, atol=1e-9)


@pytest.mark.parametrize("matrix", ["dense", "sparse"])
def test_pdhg_on_the_card_matches_the_cpu(cuda, matrix):
    """The PDHG engine's f64 iterates on the card equal the CPU run's after
    4 windows (1e-9: the same arithmetic, summed in another order)."""
    from minilp_tpu_torch.engine import pdhg

    can = canonicalize(presolve_problem(netlib_shaped_problem(60, 150, 0.08, seed=4))[0])
    opts = SolverOptions(engine="pdhg", feas_tol=1e-7)
    runs = []
    for dev in (cuda, torch.device("cpu")):
        t = [torch.as_tensor(np.asarray(v), device=dev)
             for v in (can.A, can.b, can.c, can.lo, can.hi)]
        if matrix == "sparse":
            runs.append(pdhg.solve_pdhg_sparse(t[0].to_sparse_csr(), *t[1:], opts=opts,
                                               stop_at=256))
        else:
            runs.append(pdhg.solve_pdhg(*t, opts=opts, stop_at=256))
    card, cpu = runs
    assert int(card.niter) == int(cpu.niter) == 256
    for name in ("x", "y"):
        a, b = getattr(card, name).cpu().numpy(), getattr(cpu, name).numpy()
        assert np.linalg.norm(a - b) <= 1e-9 * (1.0 + np.linalg.norm(b))


def test_crossover_runs_its_device_stage_on_the_card(cuda, tmp_path, monkeypatch):
    """`Problem.solve()` above `_CROSSOVER_M` (patched small): the device
    stage runs on the card and the solve is certified at the objective of
    the CPU's simplex route (1e-9)."""
    from minilp_tpu_torch.engine import driver
    from minilp_tpu_torch.utils import profiling

    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    monkeypatch.setattr(driver, "_CROSSOVER_M", 32)
    prob = netlib_shaped_problem(60, 150, 0.08, seed=4)
    prob.options = SolverOptions(use_megakernel="never")  # K1 would come first
    profiling.reset_stages()
    sol = prob.solve()
    assert json.loads(log.read_text().splitlines()[-1])["event"] == "cold_solve_crossover"
    assert profiling.stages()["crossover_pdhg_device_iters"] > 0
    assert sol._engine.certified
    cpu = netlib_shaped_problem(60, 150, 0.08, seed=4)
    cpu.options = SolverOptions(device="cpu", use_megakernel="never")
    assert abs(sol.objective() - cpu.solve().objective()) <= 1e-9 * (1 + abs(sol.objective()))


# ---- the f64 certificate of the batch entry points ----------------------------

def _certificate_inputs(cuda, singular_lane=None):
    """K1's rows on 16 of the bench's 16 x 40 LPs, with the f64 batch, on
    the card; `singular_lane` gets a zero basic column."""
    lp = [np.array(v) for v in random_batch(7, 16, 16, 24)]
    data = bs.upload(cuda, *lp)
    rows = bs.megakernel_rows(*data, slack0=24, **KW)
    ints = [rows[:, :16].contiguous(), rows[:, 16:56].contiguous(), rows[:, 56].contiguous()]
    if singular_lane is not None:
        data[0][singular_lane, :, int(ints[0][singular_lane, 0])] = 0.0
    return (*data, *ints)


def _same_certificate(got, want, rel=1e-12):
    (obj, ver, x), (w_obj, w_ver, w_x) = ([t.cpu().numpy() for t in r] for r in (got, want))
    np.testing.assert_array_equal(ver, w_ver)
    assert np.all(np.abs(obj - w_obj) <= rel * np.maximum(1.0, np.abs(w_obj)))
    assert np.all(np.abs(x - w_x) <= rel * np.maximum(1.0, np.abs(w_x)))


def test_certificate_kernel_matches_plain(cuda):
    args = _certificate_inputs(cuda)
    before = certify.launches
    got = certify.certify_kernel_call(*args)
    want = certify.certify_plain(*args)
    torch.cuda.synchronize()
    assert certify.launches == before + 1  # the plain version is no launch
    _same_certificate(got, want)
    assert got[1].all() and got[1].dtype == torch.bool
    host = bs._verify_f64(*(t.cpu().numpy() for t in args))
    _same_certificate(got, [torch.as_tensor(np.asarray(v)) for v in host])


def test_certificate_layouts_bit_identical(cuda):
    """The shared-memory and global layouts, and a second run, give the
    same bits; "shared" is the default at this shape."""
    args = _certificate_inputs(cuda)
    assert certify.pick_layout(16, 40) == "shared"
    default = certify.certify_kernel_call(*args)
    for again in (certify.certify_kernel_call(*args, layout="global"),
                  certify.certify_kernel_call(*args)):
        assert all(torch.equal(u, v) for u, v in zip(default, again))
    assert certify.pick_layout(200, 400) == "global"
    with pytest.raises(ValueError, match="does not fit"):
        certify.pick_layout(200, 400, "shared")


def test_certificate_fails_a_singular_lane_alone(cuda):
    """The recorded deviation: lane 3's basis is exactly singular; the
    kernel and the plain version fail lane 3 alone, where the host's
    batched solve fails every lane."""
    args = _certificate_inputs(cuda, singular_lane=3)
    got, want = certify.certify_kernel_call(*args), certify.certify_plain(*args)
    _same_certificate(got, want)
    assert got[1].cpu().tolist() == [i != 3 for i in range(16)]
    host = bs._verify_f64(*(t.cpu().numpy() for t in args))
    assert not np.asarray(host[1]).any()


def test_certificate_wrapper_raises_on_what_it_does_not_take(cuda):
    args = list(_certificate_inputs(cuda))
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="float64"):
        certify.certify_kernel_call(*bad)
    bad = list(args)
    bad[1] = args[1].cpu()
    with pytest.raises(ValueError, match="is on cpu"):
        certify.certify_kernel_call(*bad)
    with pytest.raises(ValueError, match="layout"):
        certify.certify_kernel_call(*args, layout="staged")


def test_device_f32_cast_is_numpys(cuda):
    """K1's and K3's f32 inputs are cast on the card from the f64 upload:
    the bits of numpy's `astype(np.float32)`, half-ulp ties and subnormals
    included."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 39, 4096)
    ulp = np.spacing(np.float32(1.0)).astype(np.float64)
    ties = np.array([1 + ulp / 2, 1 + 3 * ulp / 2, -(1 + ulp / 2), 2.0 ** -149 * 1.5,
                     2.0 ** -149 * 2.5, 2.0 ** -150, 2.0 ** -151, 1e-45, 1e-39, -1e-42,
                     np.inf, -np.inf, 0.0, -0.0])
    x = np.concatenate([x, ties])
    got = bs.upload(cuda, x)[0].to(torch.float32).cpu().numpy()
    np.testing.assert_array_equal(got.view(np.uint32), x.astype(np.float32).view(np.uint32))


def test_batch_entry_points_certify_on_the_card(cuda, monkeypatch):
    """K1's and K3's batch entry points take the device certificate, never
    the host's `_verify_f64`."""
    def host_check(*args):
        raise AssertionError("a batch entry point called the host's _verify_f64")

    monkeypatch.setattr(bs, "_verify_f64", host_check)
    A, b, c, lo, hi = random_batch(8, 16, 12, 36)
    before = certify.launches
    for res in (bs.solve_batch_megakernel(A, b, c, lo, hi, device=cuda),
                ps.solve_batch_packed(A, b, c, lo, hi, device=cuda, pack=8),
                batched.solve_batch_certified(A, b, c, lo, hi, device=cuda)):
        assert res.verified.all()
    assert certify.launches == before + 3


# ---- the basis kernel: the f64 certificate of one LP's final basis ------------

def _solved_basis(m=60, nv=150, seed=11):
    """The canonical form, final basis and vstat of a CPU solve."""
    prob = netlib_shaped_problem(m, nv, 0.06, seed=seed)
    prob.options = SolverOptions(device="cpu")
    h = prob.solve()._engine
    return h.can, np.asarray(h._state.basis), np.asarray(h._state.vstat).astype(np.int32)


def _basis_args(cuda, can, basis, vstat):
    t = lambda v, dt: torch.as_tensor(np.ascontiguousarray(v, dtype=dt), device=cuda)
    return ([t(v, np.float64) for v in (can.A, can.b, can.c, can.lo, can.hi)]
            + [t(basis, np.int32), t(vstat, np.int32)])


@pytest.mark.parametrize("case", ["optimal", "non_optimal_status", "infinite_bound",
                                  "repeated", "zero_pivot"])
def test_basis_kernel_matches_plain(cuda, case):
    can, basis, vstat = _solved_basis()
    A = can.A.copy()
    status = 1
    if case == "non_optimal_status":
        status = 4
    elif case == "infinite_bound":
        sl = np.arange(can.nv, can.nv + can.m)
        j = int(sl[(vstat[sl] == 0) & np.isinf(can.hi[sl])][0])
        vstat = vstat.copy()
        vstat[j] = 1  # AT_UPPER at +inf
    elif case == "repeated":
        basis = basis.copy()
        basis[1] = basis[0]
    elif case == "zero_pivot":
        A[:, basis[int(np.flatnonzero(basis < can.nv)[0])]] = 0.0
    args = _basis_args(cuda, can, basis, vstat)
    args[0] = torch.as_tensor(A, device=cuda)
    before = basis_f64.launches
    got = basis_f64.basis_kernel_call(*args, status, inverse=True)
    want = basis_f64.basis_plain(*args, status, inverse=True)
    torch.cuda.synchronize()
    assert basis_f64.launches == before + 1  # the plain version is no launch
    m, n = can.M, can.N
    k, p = (basis_f64.unpack(t.cpu().numpy(), m, n) for t in (got, want))
    assert (k.pfeas, k.dfeas, k.singular, k.verified) == (p.pfeas, p.dfeas, p.singular,
                                                          p.verified)
    assert k.singular == (case in ("repeated", "zero_pivot"))
    assert k.verified == (case == "optimal")
    close = lambda a, b: np.all((a == b) | (np.isnan(a) & np.isnan(b))
                                | (np.abs(a - b) <= 1e-12 * np.maximum(1.0, np.abs(b))))
    with np.errstate(invalid="ignore"):
        assert close(np.array([k.obj]), np.array([p.obj])) and close(k.x, p.x)
        assert close(k.xB, p.xB) and close(k.y, p.y)
    if not k.singular:
        assert np.abs(k.Binv @ A[:, basis] - np.eye(m)).max() <= 1e-10


@pytest.mark.parametrize("shape", [(60, 150, 11), (250, 760, 11)])
def test_basis_kernel_grid_independent(cuda, shape):
    """One block, a grid of 3 and the default grid give the same bits, as do
    two runs and the launch with B⁻¹; one row of B⁻¹ alone (`row`, on the
    default grid and on one block) is that row of the whole, bit for bit."""
    can, basis, vstat = _solved_basis(*shape)
    args = _basis_args(cuda, can, basis, vstat)
    outs = [basis_f64.basis_kernel_call(*args, 1, blocks=g) for g in (None, None, 1, 3)]
    inv = basis_f64.basis_kernel_call(*args, 1, inverse=True)
    m, size = can.M, basis_f64.packed_size(can.M, can.N)
    bits = lambda t: t.view(torch.int64)
    for other in outs[1:] + [inv[:size]]:
        assert torch.equal(bits(outs[0]), bits(other))
    for k, g in ((0, None), (m // 2, 1), (m - 1, None)):
        one = basis_f64.basis_kernel_call(*args, 1, row=k, blocks=g)
        assert one.numel() == size + m
        assert torch.equal(bits(one[:size]), bits(outs[0]))
        assert torch.equal(bits(one[size:]), bits(inv[size + k * m:size + (k + 1) * m]))


def test_basis_wrapper_raises_on_what_it_does_not_take(cuda):
    can, basis, vstat = _solved_basis()
    args = _basis_args(cuda, can, basis, vstat)
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(args[0].float(), *args[1:], 1)
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(*args[:5], args[5].cpu(), args[6], 1)
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(*args, 1, blocks=0)


@pytest.mark.parametrize("options", [{}, {"use_streaming": "always", "use_megakernel": "never"}],
                         ids=["k1", "k2"])
def test_card_solve_certifies_its_basis_on_the_card(cuda, monkeypatch, options):
    """A card solve factors its final basis once, on the card (the route's
    check serves the state and `certify`), and B⁻¹ once more; no host
    factorization of it."""
    def host_check(*args, **kw):
        raise AssertionError("a card solve factored its final basis on the host")

    for mod, name in ((bs, "_verify_f64"), (ss, "_verify_f64"), (hostlp, "factorize_basis")):
        monkeypatch.setattr(mod, name, host_check)
    prob = netlib_shaped_problem(70, 150, 0.08, seed=2)
    prob.options = SolverOptions(**options)
    cpu = netlib_shaped_problem(70, 150, 0.08, seed=2)
    cpu.options = SolverOptions(device="cpu")
    before = basis_f64.launches
    sol = prob.solve()
    assert sol._engine.certified and basis_f64.launches == before + 1
    want = cpu.solve().objective()
    assert abs(sol.objective() - want) <= 1e-9 * (1.0 + abs(want))
    binv = np.asarray(sol._engine.state.Binv)
    assert basis_f64.launches == before + 2
    B = sol._engine.can.A[:, np.asarray(sol._engine._state.basis)]
    assert binv.flags.c_contiguous and np.abs(binv @ B - np.eye(B.shape[0])).max() <= 1e-10


def test_card_resolves_certify_on_the_card(cuda, monkeypatch):
    """Warm re-solves on the card (host route and K1 warm): each node
    certified by the basis kernel, none on the host."""
    from minilp_tpu_torch.utils.node_chain import run_chain

    def host_check(*args, **kw):
        raise AssertionError("a card re-solve factored its final basis on the host")

    monkeypatch.setattr(driver.hostlp, "factorize_basis", host_check)
    monkeypatch.setattr(bs, "_verify_f64", host_check)
    for options in ({}, {"use_megakernel": "always"}):
        prob = netlib_shaped_problem(60, 150, 0.06, seed=11)
        prob.options = SolverOptions(**options)
        before = basis_f64.launches
        nodes = run_chain(prob.solve())
        done = [n for n in nodes if n.outcome == "optimal"]
        assert done and all(n.certified for n in done)
        assert basis_f64.launches - before >= 1 + len(done)


def test_cold_solve_spans_stay_off_the_cards_timeline(cuda, monkeypatch):
    """A cold 25fv47-shaped solve (K2, the basis kernel): under
    `torch.profiler` its host spans are ranges on the CPU's timeline and no
    `minilp.*` event lies on the card's; without a profiler (tracing off)
    `profiling` synchronises nothing and keeps no span."""
    import sys

    from torch.autograd import DeviceType

    from minilp_tpu_torch.utils import profiling

    prob = netlib_shaped_problem(821, 1571, 0.008, seed=1)
    prob.options = SolverOptions()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    profiling.reset_stages()
    with torch.profiler.profile(activities=acts) as prof:
        assert prob.solve()._engine.certified
        torch.cuda.synchronize()
    ours = [e for e in prof.events() if e.name.startswith("minilp.")]
    assert {"minilp.presolve", "minilp.canonicalize"} <= {e.name for e in ours}
    assert not [e.name for e in ours if e.device_type == DeviceType.CUDA]
    assert any(e.device_type == DeviceType.CUDA for e in prof.events())
    assert "stream_pivots" in profiling.stages() and profiling.spans()

    calls = []
    sync = torch.cuda.synchronize

    def counted(*a, **kw):
        calls.append(sys._getframe(1).f_code.co_filename)
        return sync(*a, **kw)

    monkeypatch.setattr(torch.cuda, "synchronize", counted)
    assert not profiling.tracing()
    profiling.reset_stages()
    prob = netlib_shaped_problem(821, 1571, 0.008, seed=1)
    prob.options = SolverOptions()
    assert prob.solve()._engine.certified
    assert not [f for f in calls if f == profiling.__file__]
    assert profiling.spans() == [] and "basis_dev_s" not in profiling.stages()
