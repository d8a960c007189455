"""PyTorch port, K2 (the streaming single-LP simplex kernel) against the
Pallas kernel, and the Netlib-scale driver route through it.

On the CPU the port's wrapper runs the kernel's plain torch version
(`stream_plain`); the reference runs its Pallas kernel in interpret mode,
as the JAX package's own tests do.  The port's `solve_streaming` returns
K2's claim, which these tests check with the reference's host check
(`_verify_f64`) on the launch's arrays, as the reference's
`solve_streaming_pallas` checks its own.  Both iterate in f32 and reduce in
different orders, so the gate is: the same status, the same `verified`
flag, certified (exact f64) objectives within 1e-9 relative, and the same
pivot count where both take the same pivot path (every instance here).
The CUDA kernel is held against the plain version on the card by
`test_torch_cuda.py` and `chip_smoke.py`.

Each distinct Pallas signature costs seconds to trace in interpret mode, so
every reference result is computed once per module.
"""

import functools
import json
import re
from pathlib import Path
from typing import NamedTuple

import numpy as np
import pytest
import torch

import minilp_tpu
from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.ops.kernels import streaming_simplex as ref_ss
from minilp_tpu.parallel.batched import make_random_batch_host
from minilp_tpu.status import Status
from minilp_tpu.utils.synth import degenerate_problem
from minilp_tpu_torch.ops.kernels import build
from minilp_tpu_torch.ops.kernels import streaming_simplex as ss
from minilp_tpu_torch.ops.kernels.batched_simplex import _verify_f64

from .oracle import random_problem
from .torch_helpers import HAND_CASES, as_torch_problem, rel_err

REL_OBJ = 1e-9  # certified objectives, both exact f64 recomputations


def _lp(seed, m, nv):
    return [x[0] for x in make_random_batch_host(seed, 1, m, nv)]


def _canonical(seed):
    rng = np.random.default_rng(8200 + seed)
    can = ref_canonicalize(random_problem(rng, nv=int(rng.integers(4, 10)),
                                          m=int(rng.integers(2, 8))))
    return (can.A, can.b, can.c, can.lo, can.hi), can.nv


@functools.lru_cache(maxsize=None)
def _ref(case):
    """The Pallas kernel's result on a named case (cached per module)."""
    lp, kw = CASES[case]
    return ref_ss.solve_streaming_pallas(*lp, interpret=True, **kw)


class Checked(NamedTuple):
    """The port's claim and its host check, in the reference's fields."""

    basis: np.ndarray
    vstat: np.ndarray
    status: int
    niter: int
    obj: float
    verified: bool
    x: np.ndarray


def _solve(A, b, c, lo, hi, **kw):
    """`solve_streaming` on the CPU, its claim checked by `_verify_f64` on
    the LP (the padding columns, inert FIXED at 0, stripped)."""
    res = ss.solve_streaming(A, b, c, lo, hi, device="cpu", **kw)
    obj, ver, x = (v[0] for v in _verify_f64(
        *(np.asarray(v)[None] for v in (A, b, c, lo, hi, res.basis, res.vstat)),
        np.array([res.status])))
    return Checked(res.basis, res.vstat, int(res.status), int(res.niter), float(obj),
                   bool(ver), x)


def _port(case, **extra):
    lp, kw = CASES[case]
    return _solve(*lp, **kw, **extra)


def _assert_agree(ref, got, same_path=True):
    assert int(got.status) == int(ref.status)
    assert bool(got.verified) == bool(ref.verified)
    if bool(ref.verified):
        assert rel_err(float(got.obj), float(ref.obj)) <= REL_OBJ
    if same_path:
        assert int(got.niter) == int(ref.niter)


def _warm_from(res, A):
    """(basis, vstat, B⁻¹) of a certified result, the inverse exact in f64."""
    basis = np.asarray(res.basis)
    return basis, np.asarray(res.vstat), np.linalg.inv(A[:, basis])


CASES = {
    "rand_0_8_16": (_lp(0, 8, 16), dict(tile_n=16)),
    "rand_1_16_24": (_lp(1, 16, 24), dict(tile_n=16)),
    "rand_2_16_40": (_lp(2, 16, 40), dict(tile_n=16)),
    "pad_9_8_20": (_lp(9, 8, 20), dict(tile_n=16)),
    "long_step_3_16_24": (_lp(3, 16, 24), dict(tile_n=16, long_step_min_m=0)),
    "devex_reset": (_lp(2, 16, 40), dict(tile_n=16, devex_reset=1.5)),
    "chunked": (_lp(2, 16, 40), dict(tile_n=16, chunk_iters=8)),
}
for _seed in range(2):
    _lpc, _nv = _canonical(_seed)
    CASES[f"canonical_{_seed}"] = (_lpc, dict(slack0=_nv, tile_n=8))
_deg = ref_canonicalize(degenerate_problem(20, 40, 0.25, seed=0))
CASES["long_step_degenerate"] = (
    (_deg.A, _deg.b, _deg.c, _deg.lo, _deg.hi),
    dict(slack0=_deg.nv, tile_n=16, long_step_min_m=0, max_iter=5_000))


@pytest.mark.parametrize("case", [
    "rand_0_8_16", "rand_1_16_24", "rand_2_16_40", "canonical_0", "canonical_1",
    "long_step_3_16_24", "long_step_degenerate", "devex_reset",
])
def test_cold_matches_pallas(case):
    ref = _ref(case)
    got = _port(case)
    assert int(got.status) == int(Status.OPTIMAL) and bool(got.verified)
    _assert_agree(ref, got)
    A, b = CASES[case][0][:2]
    assert np.abs(A @ got.x - b).max() < 1e-9  # the exact vertex solves A x = b


def test_n_padding_is_inert():
    """n = 28: tile 16 and tile 8 pad to 32 columns, tile 5 to 30, with
    FIXED zero columns.  The answer is the same at every tile size, and the
    padding is stripped from the result."""
    ref = _ref("pad_9_8_20")
    r16 = _port("pad_9_8_20")
    _assert_agree(ref, r16)
    for tile in (8, 5):
        got = _solve(*CASES["pad_9_8_20"][0], tile_n=tile)
        _assert_agree(r16, got, same_path=False)
        assert got.vstat.shape == (28,) and got.x.shape == (28,)


def test_chunked_launches_match_single_and_pallas():
    """chunk_iters=8: each launch runs at most 8 pivots and the next one
    restarts warm from its (basis, vstat, B⁻¹); the single launch is the
    default "auto" chunk.  Port and Pallas agree on each."""
    single_ref, single = _ref("rand_2_16_40"), _port("rand_2_16_40")
    chunked_ref, chunked = _ref("chunked"), _port("chunked")
    _assert_agree(single_ref, single)
    _assert_agree(chunked_ref, chunked)
    _assert_agree(single, chunked, same_path=False)
    assert int(chunked.niter) <= 2 * int(single.niter) + 16


def test_chunk_loop_counts_launches_and_stages():
    from minilp_tpu_torch.utils import profiling

    profiling.reset_stages()
    got = _port("chunked")
    st = profiling.stages()
    assert st["stream_n_chunks"] == -(-int(got.niter) // 8)
    assert st["stream_majors"] >= st["stream_refreshes"] >= st["stream_n_chunks"]
    for name in ("stream_prep_s", "stream_first_launch_s", "stream_chunks_s"):
        assert st[name] >= 0.0


def test_warm_restart_from_optimum_takes_no_pivot():
    cold = _port("rand_1_16_24")
    A = CASES["rand_1_16_24"][0][0]
    warm = _port("rand_1_16_24", warm_state=_warm_from(cold, A))
    assert int(warm.status) == int(Status.OPTIMAL) and bool(warm.verified)
    assert int(warm.niter) == 0
    assert rel_err(float(warm.obj), float(cold.obj)) <= 1e-12


def test_warm_restart_after_tightened_box_matches_pallas():
    """The JAX package's certified basis warm-starts both kernels on an
    edited problem (every structural box cut to [0, 0.4])."""
    lp, kw = CASES["rand_1_16_24"]
    A, b, c, lo, hi = lp
    warm = _warm_from(_ref("rand_1_16_24"), A)
    hi2 = hi.copy()
    hi2[:24] = np.minimum(hi2[:24], 0.4)
    ref = ref_ss.solve_streaming_pallas(A, b, c, lo, hi2, interpret=True,
                                        warm_state=warm, **kw)
    got = _solve(A, b, c, lo, hi2, warm_state=warm, **kw)
    assert int(got.niter) > 0
    _assert_agree(ref, got)


@pytest.mark.parametrize("seq", [
    # (phase, infeasibility, objective) per chunk
    [(1, 5.0, 1.0)] * 8,                                  # frozen: surrenders
    [(1, 5.0 / 2 ** k, 1.0) for k in range(8)],           # halving: never
    [(2, 5.0, 1.0 + k) for k in range(8)],                # objective moving
    [(2, 1e-9, 1.0)] * 8,                                 # feasible: never
    [(1, 5.0, 1.0)] * 3 + [(1, 2.0, 1.0)] + [(1, 2.0, 1.0)] * 5,
])
def test_surrender_tracker_matches_reference(seq):
    ref, got = ref_ss.SurrenderTracker(1e-5), ss.SurrenderTracker(1e-5)
    assert [ref.update(*x) for x in seq] == [got.update(*x) for x in seq]
    assert (ref.stalled, ref.best_infeas) == (got.stalled, got.best_infeas)


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    A, b, c, lo, hi = _lp(0, 8, 16)
    t = lambda x: torch.tensor(np.asarray(x, np.float32))
    args = (t(np.ascontiguousarray(A.T)), t(b), t(c), t(lo), t(hi))
    kw = dict(slack0=16, max_iter=100, refactor_period=128, newton_sweeps=2,
              feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6, bland_after=400,
              devex_floor=1e-12, devex_reset=1e8, minor_k=16, regress_tol=1e-3,
              se_weights=True, minor_decay=0.0625, xb_refine=True, long_step=False)
    before = ss.launches
    out = ss.stream_kernel_call(*args, **kw)
    assert ss.launches == before
    ref = ss.stream_plain(*args, **kw)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert out.monitor.dtype == torch.int32 and int(out.monitor[0]) == int(Status.OPTIMAL)
    infeas, _obj = out.monitor[3:5].view(torch.float32).tolist()
    assert infeas <= 1e-5
    assert out.monitor.shape == (7,) and int(out.monitor[5]) >= int(out.monitor[6]) >= 1
    bad = dict(kw, minor_k=0)
    with pytest.raises(ValueError):
        ss.stream_kernel_call(*args, **bad)
    with pytest.raises(ValueError):
        ss.stream_kernel_call(args[0].double(), *args[1:], **kw)
    with pytest.raises(ValueError):
        ss.stream_kernel_call(args[0], args[1][:4].contiguous(), *args[2:], **kw)


def _wide_phase_work_items(m, n):
    """Work items of each of K2's grid phases, one block's worth each: the
    Newton gather and copy (m² entries, one per thread of 512), the Newton
    products (output units of 128×128 down to 64×64, the finest 64×64), the
    steepest-edge product (units of 128×128 down to 32×128, the finest
    32-row by 128-column), the reduced costs (n rows, one per warp of 16) and
    the column sums (32-column tiles)."""
    return max(-(-m * m // 512), (-(-m // 64)) ** 2, -(-n // 32) * -(-m // 128),
               -(-n // 16), -(-m // 32))


@pytest.mark.parametrize("m,n", [(8, 16), (60, 70), (100, 300), (128, 128), (129, 260),
                                 (824, 2432), (4096, 32768)])
def test_k2_grid_blocks_stay_within_the_card_and_the_work(m, n):
    for sm_count, per_sm in [(132, 1), (132, 2), (8, 1), (1, 1)]:
        g = ss.k2_grid_blocks(m, n, sm_count, per_sm)
        assert isinstance(g, int)
        assert 1 <= g <= min(sm_count * per_sm, ss.MAX_GRID)
        assert g <= _wide_phase_work_items(m, n)
    # the card is the limit at Netlib scale, the work at a toy size
    assert ss.k2_grid_blocks(824, 2432, 132, 1) == 132
    assert ss.k2_grid_blocks(8, 16, 132, 1) == 1
    with pytest.raises(ValueError):
        ss.k2_grid_blocks(m, n, 132, 0)


def test_k2_split_parts_are_the_kernels_clock_parts():
    """`k2_split.PARTS` names the clock build's `Part` enum one for one, in
    its order: the split reads the clock words by position."""
    from minilp_tpu_torch.utils import k2_split

    src = (Path(build.__file__).resolve().parents[2] / "csrc" / "streaming_simplex.cu").read_text()
    enum = re.search(r"enum Part \{(.*?)\};", src, re.S).group(1)
    enum = re.sub(r"//[^\n]*", "", enum)
    names = [w.strip() for w in enum.split(",") if w.strip()]
    assert names[-1] == "kParts"
    prefix = {"REF": "refresh", "PRICE": "price", "MIN": "minors"}
    as_part = lambda w: ".".join(prefix.get(x, x) for x in w[2:].split("_")).lower()
    parts = [as_part(w).replace("ysync", "y.sync") for w in names[:-1]]
    assert tuple(parts) == k2_split.PARTS
    assert [p for p in parts if p.startswith("minors.")] == [
        "minors.costs", "minors.scan", "minors.ratio", "minors.row", "minors.update"]


def _launch_args(seed=0, m=8, nv=16):
    A, b, c, lo, hi = _lp(seed, m, nv)
    t = lambda x: torch.tensor(np.asarray(x, np.float32))
    args = (t(np.ascontiguousarray(A.T)), t(b), t(c), t(lo), t(hi))
    kw = dict(slack0=nv, max_iter=100, refactor_period=128, newton_sweeps=2,
              feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6, bland_after=400,
              devex_floor=1e-12, devex_reset=1e8, minor_k=16, regress_tol=1e-3,
              se_weights=True, minor_decay=0.0625, xb_refine=True, long_step=False)
    return args, kw


@pytest.mark.parametrize("blocks", [0, -1, ss.MAX_GRID + 1])
def test_wrapper_rejects_a_bad_grid_before_any_launch(blocks, monkeypatch):
    """`blocks` outside [1, MAX_GRID] raises before the plain version runs
    or the library loads, on a CPU tensor too."""
    args, kw = _launch_args()
    ran = []
    monkeypatch.setattr(ss, "stream_plain", lambda *a, **k: ran.append(1))
    monkeypatch.setattr(ss, "_library", lambda: ran.append(2))
    before = ss.launches
    with pytest.raises(ValueError, match="blocks"):
        ss.stream_kernel_call(*args, blocks=blocks, **kw)
    assert ran == [] and ss.launches == before


@pytest.mark.parametrize("blocks", [1, 7])
def test_wrapper_with_blocks_runs_plain_on_cpu(blocks):
    """On a CPU tensor `blocks` changes nothing: the plain version runs,
    bit for bit, and no launch is counted."""
    args, kw = _launch_args(seed=1, m=16, nv=24)
    before = ss.launches
    out = ss.stream_kernel_call(*args, blocks=blocks, **kw)
    assert ss.launches == before
    ref = ss.stream_plain(*args, **kw)
    for x, y in zip(out, ref):
        np.testing.assert_array_equal(x.numpy(), y.numpy())
    assert int(out.monitor[0]) == int(Status.OPTIMAL)


def test_build_digest_follows_included_headers(tmp_path):
    """A kernel's library name hashes the headers it includes, so an edited
    shared header never loads a stale build (no nvcc needed)."""
    (tmp_path / "common.cuh").write_text("// v1\n")
    (tmp_path / "nested.cuh").write_text('#include "common.cuh"\n')
    src = tmp_path / "k.cu"
    src.write_text('#include <math.h>\n#include "nested.cuh"\nint k;\n')
    d0 = build.source_digest(src)
    assert build.source_digest(src) == d0
    (tmp_path / "common.cuh").write_text("// v2\n")
    d1 = build.source_digest(src)
    assert d1 != d0
    (tmp_path / "unrelated.cuh").write_text("// not included\n")
    assert build.source_digest(src) == d1
    # every kernel of the port includes the shared header
    for name in ("batched_simplex", "streaming_simplex", "packed_simplex"):
        assert '#include "simplex_common.cuh"' in (build.CSRC / f"{name}.cu").read_text()
    # and the two single-LP grids share theirs
    for name in ("batched_simplex", "streaming_simplex"):
        assert '#include "simplex_grid.cuh"' in (build.CSRC / f"{name}.cu").read_text()


# ---- the driver: Problem.solve() routed through K2 --------------------------

STREAM = dict(use_streaming="always", use_megakernel="never")


@pytest.mark.parametrize("name", ["readme", "random_4", "random_5"])
def test_problem_solve_routes_through_k2(name, tmp_path, monkeypatch):
    if name == "readme":
        make = HAND_CASES["doc_example_maximize"][0]
    else:
        seed = int(name.split("_")[1])
        make = lambda: random_problem(np.random.default_rng(seed), nv=12, m=8)
    ref_prob = make()
    ref_prob.options = minilp_tpu.SolverOptions(**STREAM, f32_midsize="never")
    want = ref_prob.solve().objective()
    log = tmp_path / "rec.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    sol = as_torch_problem(make(), **STREAM).solve()
    events = [json.loads(line)["event"] for line in log.read_text().splitlines()]
    assert events == ["cold_solve_streaming"]
    assert sol._engine.certified
    assert rel_err(sol.objective(), want) <= REL_OBJ
    if name == "readme":
        assert sol.objective() == pytest.approx(7.0, abs=1e-12)


def test_prepare_launch_is_the_drivers_first_launch():
    """`prepare_launch` with the driver's options gives the launch that
    `Problem.solve()`'s K2 route makes (n unpadded: the default tile is one
    column), so a comparison on it runs at the main path's shape."""
    from minilp_tpu_torch.canonical import canonicalize
    from minilp_tpu_torch.engine.driver import streaming_options
    from minilp_tpu_torch.options import SolverOptions

    prob = as_torch_problem(random_problem(np.random.default_rng(5), nv=12, m=8))
    can = canonicalize(prob)
    opts = streaming_options(can, SolverOptions(device="cpu", **STREAM))
    launch = ss.prepare_launch(can.A, can.b, can.c, can.lo, can.hi, **opts)
    assert tuple(launch.args[0].shape) == (can.N, can.M) and launch.A.shape == (can.M, can.N)
    assert launch.kw["max_iter"] == min(32768, opts["max_iter"])
    out = ss.stream_kernel_call(*launch.args, launch.warm, **launch.kw)
    got = ss.solve_streaming(can.A, can.b, can.c, can.lo, can.hi, **opts)
    assert int(out.monitor[1]) == int(got.niter)
    np.testing.assert_array_equal(out.basis.numpy(), got.basis)
    np.testing.assert_array_equal(out.vstat.numpy()[:can.N], got.vstat)


def test_streaming_auto_declines_off_the_card():
    """"auto" takes K2 only on a CUDA device; on the CPU a Netlib-shaped LP
    goes the f64 engine's way, and "never" is never K2."""
    from minilp_tpu_torch.canonical import canonicalize
    from minilp_tpu_torch.engine.driver import _streaming_eligible
    from minilp_tpu_torch.options import SolverOptions

    prob = as_torch_problem(random_problem(np.random.default_rng(4), nv=12, m=8))
    can = canonicalize(prob)
    assert not _streaming_eligible(can, SolverOptions(device="cpu"))
    assert not _streaming_eligible(can, SolverOptions(device="cpu", use_streaming="never"))
    assert _streaming_eligible(can, SolverOptions(device="cpu", use_streaming="always"))
    with pytest.raises(ValueError):
        _streaming_eligible(can, SolverOptions(device="cpu", use_streaming="sometimes"))
