"""PyTorch port, K1 (the batched simplex megakernel) against the Pallas kernel.

On the CPU the port's wrapper runs the kernel's plain torch version; the
reference runs its Pallas kernel in interpret mode, as the JAX package's own
tests do.  Both iterate in f32, whose reduction order differs, so pivot
counts may differ: the gate is the same status and `verified` flag per LP
and certified (f64) objectives within 1e-9 relative.  The CUDA kernel itself
is held against the plain version on the card by `test_torch_cuda.py` and
`chip_smoke.py`.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.engine.driver import _state_from_certified_basis
from minilp_tpu.ops.kernels import batched_simplex as ref_bs
from minilp_tpu.parallel.batched import make_random_batch_host
from minilp_tpu.status import Status
from minilp_tpu_torch.engine.state import state_from_numpy
from minilp_tpu_torch.ops.kernels import batched_simplex as bs
from minilp_tpu_torch.ops.kernels import build

from .oracle import random_problem
from .torch_helpers import CPU

KW = dict(refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
          bland_after=200)


def _assert_agree(ref, got):
    np.testing.assert_array_equal(got.status, np.asarray(ref.status))
    np.testing.assert_array_equal(got.verified, np.asarray(ref.verified))
    v = np.asarray(ref.verified)
    ref_obj = np.asarray(ref.obj)[v]
    assert np.all(np.abs(got.obj[v] - ref_obj) <= 1e-9 * (1.0 + np.abs(ref_obj)))


@pytest.mark.parametrize("seed", [0, 1])
def test_cold_batch_matches_pallas(seed):
    A, b, c, lo, hi = make_random_batch_host(seed, 4, 8, 24)  # 4 × (8 × 32)
    ref = ref_bs.solve_batch_pallas(A, b, c, lo, hi, interpret=True)
    got = bs.solve_batch_megakernel(A, b, c, lo, hi, device="cpu")
    assert (got.status == int(Status.OPTIMAL)).all() and got.verified.all()
    _assert_agree(ref, got)
    # the exact vertex is consistent: A x = b in f64
    assert np.abs(np.einsum("bmn,bn->bm", A, got.x) - b).max() < 1e-9


@pytest.mark.parametrize("seed", range(4))
def test_canonical_layout_matches_pallas(seed):
    """canonicalize() output: slack block at slack0=nv, inert padding after;
    free and at-upper variables, Eq/Ge rows, maximize; every status."""
    rng = np.random.default_rng(7100 + seed)
    prob = random_problem(rng, nv=int(rng.integers(4, 10)), m=int(rng.integers(2, 8)))
    can = ref_canonicalize(prob)
    args = [x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)]
    ref = ref_bs.solve_batch_pallas(*args, slack0=can.nv, interpret=True, max_iter=4000)
    got = bs.solve_batch_megakernel(*args, slack0=can.nv, device="cpu", max_iter=4000)
    _assert_agree(ref, got)


def test_warm_start_after_tightened_bound():
    """The reference's certified state crosses over through state_from_numpy;
    warm from it, after a bound cut, both kernels agree."""
    rng = np.random.default_rng(7102)
    can = ref_canonicalize(random_problem(rng, nv=12, m=8, frac_free=0.0))
    args = [x[None] for x in (can.A, can.b, can.c, can.lo, can.hi)]
    cold = ref_bs.solve_batch_pallas(*args, slack0=can.nv, interpret=True)
    assert bool(cold.verified[0])
    basis, vstat = np.asarray(cold.basis[0]), np.asarray(cold.vstat[0]).astype(np.int8)
    state = _state_from_certified_basis(can, basis, vstat, int(cold.niter[0]), CPU)
    state = state._replace(Binv=np.linalg.inv(can.A[:, basis]))
    st = state_from_numpy(state, "cpu", dtype=torch.float32)
    x = np.asarray(cold.x[0])
    j = max((int(k) for k in basis if k < can.nv),
            key=lambda k: x[k] - can.lo[k] if np.isfinite(can.lo[k]) else -1.0)
    hi2 = can.hi.copy()
    hi2[j] = 0.5 * (can.lo[j] + x[j])
    args[4] = hi2[None]
    warm_ref = (basis[None], vstat[None].astype(np.int32),
                np.linalg.inv(can.A[:, basis])[None].astype(np.float32))
    warm_port = (st.basis.numpy()[None], st.vstat.numpy()[None], st.Binv.numpy()[None])
    ref = ref_bs.solve_batch_pallas(*args, slack0=can.nv, interpret=True,
                                    warm_state=warm_ref)
    got = bs.solve_batch_megakernel(*args, slack0=can.nv, device="cpu",
                                    warm_state=warm_port)
    assert got.verified.all() and int(got.niter[0]) > 0
    _assert_agree(ref, got)


def test_verify_f64_is_the_reference_check():
    A, b, c, lo, hi = make_random_batch_host(3, 3, 6, 10)
    got = bs.solve_batch_megakernel(A, b, c, lo, hi, device="cpu")
    ours = bs._verify_f64(A, b, c, lo, hi, got.basis, got.vstat, got.status)
    theirs = ref_bs._verify_f64(A, b, c, lo, hi, got.basis, got.vstat, got.status)
    for x, y in zip(ours, theirs):
        np.testing.assert_array_equal(x, np.asarray(y))


def _tensors(B=2, m=4, nv=6, seed=0):
    A, b, c, lo, hi = make_random_batch_host(seed, B, m, nv)
    return [torch.tensor(x, dtype=torch.float32) for x in (A, b, c, lo, hi)]


def test_wrapper_runs_plain_on_cpu_and_counts_no_launch():
    args = _tensors()
    before = bs.launches
    out = bs.simplex_kernel_call(*args, slack0=6, max_iter=100, **KW)
    assert bs.launches == before
    assert out.dtype == torch.int32 and out.shape == (2, 4 + 10 + 2)
    np.testing.assert_array_equal(
        out.numpy(), bs.simplex_plain(*args, slack0=6, max_iter=100, **KW).numpy())
    assert (out[:, -2] == int(Status.OPTIMAL)).all()


@pytest.mark.parametrize("m,n", [(8, 16), (24, 128), (64, 256), (256, 1024), (504, 2048)])
@pytest.mark.parametrize("cluster,clusters", [(16, 8), (8, 1), (8, 16), (16, 64)])
def test_k1_grid_blocks_within_card_and_work(m, n, cluster, clusters):
    """G is a whole number of clusters that fits the card (all resident at
    once, at most MAX_GRID), and no cluster but the first lacks items of
    the widest grid phase: the m² elementwise steps at one per thread, the
    refresh GEMM's 64×64 tiles, matvec rows at one per warp, column sums at
    one warp per 32 columns."""
    g = bs.k1_grid_blocks(m, n, cluster, clusters)
    work = max(-(-m * m // 512), (-(-m // 64)) ** 2, -(-m // 16), -(-n // 32))
    assert g % cluster == 0 and cluster <= g <= bs.MAX_GRID
    assert g <= cluster * clusters and (g == cluster or g <= work)
    assert g == cluster * max(1, min(clusters, work // cluster, bs.MAX_GRID // cluster))
    if (m, n) in ((256, 1024), (504, 2048)) and clusters > 1:
        assert g > cluster  # the main path's single-LP shapes go wide on an H100


@pytest.mark.parametrize("m,n,cluster,clusters,want", [
    (8, 16, 16, 8, 16),          # less work than one cluster: one cluster all the same
    (384, 1024, 16, 7, 112),     # degen2-cold's shape: every cluster the card holds
    (384, 1024, 8, 16, 128),
    (384, 1024, 16, 100, 288),   # the work items: 384² entries at one a thread
    (504, 2048, 16, 100, 496),   # a whole number of clusters below the work (497)
    (1024, 2048, 8, 1000, 1024),  # MAX_GRID
])
def test_k1_grid_blocks_rule(m, n, cluster, clusters, want):
    assert bs.k1_grid_blocks(m, n, cluster, clusters) == want


@pytest.mark.parametrize("cluster,clusters", [(132, 0), (0, 8)])
def test_k1_grid_blocks_rejects_an_empty_card(cluster, clusters):
    with pytest.raises(ValueError):
        bs.k1_grid_blocks(504, 2048, cluster, clusters)


@pytest.mark.parametrize("blocks,batch,cluster", [
    (None, 1, 16), (None, 5, None), (1, 1, 16), (1, 1, None), (1, 4, 8), (16, 1, 16),
    (112, 1, 16), (24, 1, 8), (12, 1, None), (bs.MAX_GRID, 1, 16)])
def test_check_blocks_takes_one_block_or_whole_clusters(blocks, batch, cluster):
    """One block with no cluster, or for one LP a whole number of clusters
    (any count while the card's cluster is not known)."""
    bs.check_blocks(blocks, batch, cluster)


@pytest.mark.parametrize("blocks,batch,cluster", [
    (0, 1, 16), (bs.MAX_GRID + 16, 1, 16), (12, 1, 16), (20, 1, 8), (2, 1, 16),
    (16, 2, 16), (16, 2, None)])
def test_check_blocks_rejects(blocks, batch, cluster):
    with pytest.raises(ValueError, match="blocks"):
        bs.check_blocks(blocks, batch, cluster)


@pytest.mark.parametrize("B,blocks", [(1, 0), (1, bs.MAX_GRID + 1), (2, 2), (4, 132)])
def test_wrapper_rejects_bad_blocks_before_any_launch(B, blocks):
    """`blocks` outside [1, MAX_GRID], or above 1 for a batch (a batch runs
    one block per LP), raises before anything runs, on any device."""
    args = _tensors(B=B)
    before = bs.launches
    with pytest.raises(ValueError, match="blocks"):
        bs.simplex_kernel_call(*args, slack0=6, max_iter=100, blocks=blocks, **KW)
    assert bs.launches == before


@pytest.mark.parametrize("B,blocks", [(1, 1), (1, 7), (1, None), (3, 1)])
def test_wrapper_blocks_on_cpu_runs_plain(B, blocks):
    """CPU tensors run the plain version whatever `blocks` says, and count
    no launch; the private launch helper returns no workspace for them."""
    args = _tensors(B=B, seed=B)
    before = bs.launches
    out, ws = bs._launch(*args, slack0=6, max_iter=100, blocks=blocks, **KW)
    assert bs.launches == before and ws is None
    np.testing.assert_array_equal(
        out.numpy(), bs.simplex_plain(*args, slack0=6, max_iter=100, **KW).numpy())
    np.testing.assert_array_equal(
        out.numpy(),
        bs.simplex_kernel_call(*args, slack0=6, max_iter=100, blocks=blocks, **KW).numpy())


@pytest.mark.parametrize("fault", ["dtype", "shape", "contiguous", "warm_dtype"])
def test_wrapper_rejects_bad_inputs(fault):
    A, b, c, lo, hi = _tensors()
    warm = None
    if fault == "dtype":
        A = A.double()
    elif fault == "shape":
        b = b[:, :3].contiguous()
    elif fault == "contiguous":
        A = A.transpose(1, 2).contiguous().transpose(1, 2)
    else:
        warm = (torch.zeros(2, 4, dtype=torch.int64), torch.zeros(2, 10, dtype=torch.int32),
                torch.zeros(2, 4, 4))
    with pytest.raises(ValueError):
        bs.simplex_kernel_call(A, b, c, lo, hi, warm, slack0=6, max_iter=10, **KW)


def test_k1_split_parts_are_the_kernels_clock_parts():
    """`k1_split.PARTS` names the clock build's `Part` enum one for one, in
    its order: the split reads the clock words by position."""
    from minilp_tpu_torch.utils import k1_split

    src = (Path(build.__file__).resolve().parents[2] / "csrc" / "batched_simplex.cu").read_text()
    enum = re.search(r"enum Part \{(.*?)\};", src, re.S).group(1)
    names = [w.strip() for w in re.sub(r"//[^\n]*", "", enum).split(",") if w.strip()]
    assert names[-1] == "kParts"
    assert tuple(w[2:].lower().replace("_", ".") for w in names[:-1]) == k1_split.PARTS


def test_k1_split_degen2_is_the_cells_pool():
    """The split's "degen2" shape is `degen2-cold`'s configuration and pool,
    at the padded (384, 1024) that K1 runs, at the driver's `opt_tol`."""
    import json

    from minilp_tpu_torch.engine.driver import _k1_opt_tol
    from minilp_tpu_torch.options import SolverOptions
    from minilp_tpu_torch.utils import k1_split

    root = Path(__file__).resolve().parents[1] / "lpbench"
    shape = json.loads((root / "configs" / "netlib-degen2.json").read_text())["shape"]
    params = json.loads((root / "workloads" / "degen2-cold.json").read_text())["params"]
    assert k1_split.SHAPES["degen2"] == (shape["rows"], shape["cols"], shape["density"])
    assert k1_split.DEGEN2_POOL_SEED == params["pool_seed"]
    lps = k1_split.instances("degen2")
    assert len(lps) == k1_split.DEGEN2_LPS
    for can, opt_tol in lps:
        assert can.A.shape == (384, 1024)
        assert opt_tol == _k1_opt_tol(can, SolverOptions())
