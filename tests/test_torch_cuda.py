"""PyTorch port on the card: the CUDA kernel against its plain version, and
the main path through it.  Every test here needs a CUDA device and skips
without one.

This file imports neither jax nor the JAX package, so that it runs on a
machine with the card and no jax; `tests/conftest.py` imports jax, so run it
there without the conftest:

    python -m pytest tests/test_torch_cuda.py --noconftest -q
"""

import json

import numpy as np
import pytest
import torch

from minilp_tpu_torch import ComparisonOp, OptimizationDirection, Problem, SolverOptions
from minilp_tpu_torch.ops.kernels import batched_simplex as bs
from minilp_tpu_torch.utils.synth import netlib_shaped_problem, random_batch

pytestmark = pytest.mark.cuda

KW = dict(refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
          bland_after=200)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_and_plain(cuda, A, b, c, lo, hi, slack0, warm=None):
    t = lambda x, dt=np.float32: torch.tensor(np.asarray(x, dtype=dt), device=cuda)
    args = [t(x) for x in (A, b, c, lo, hi)]
    if warm is not None:
        warm = (t(warm[0], np.int32), t(warm[1], np.int32), t(warm[2]))
    before = bs.launches
    outs = [fn(*args, warm, slack0=slack0, max_iter=4000, **KW)
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
