"""PyTorch port, the batched path's f64 certificate (`ops/kernels/certify.py`)
against the JAX package's host check `_verify_f64`, on the CPU.

On the CPU the wrapper runs the kernel's plain torch version
(`certify_plain`: one LU per lane through `torch.linalg.lu_factor_ex`).  The
same numpy inputs go through the reference's `_verify_f64` (numpy, one
batched `np.linalg.solve`).  Required: the same `verified` flags, and obj and
x within 1e-12 · max(1, |reference|) (two LU orders of the same f64 solve; a
NaN or an infinity must be the reference's).  The bases come from K3's and
K1's plain versions on the bench's LPs, and from edits of them that break
one check each.  One case differs by design, the recorded deviation: an
exactly singular basis fails its own lane only, where the reference's
batched solve raises and fails every lane.  The CUDA kernel is held against
`certify_plain` on the card by `test_torch_cuda.py` and `chip_smoke.py`.
"""

import functools

import numpy as np
import pytest
import torch

from minilp_tpu.ops.kernels import batched_simplex as ref_bs
from minilp_tpu_torch.ops.kernels import batched_simplex as bs
from minilp_tpu_torch.ops.kernels import certify
from minilp_tpu_torch.ops.kernels import packed_simplex as ps
from minilp_tpu_torch.status import Status, VarStat
from minilp_tpu_torch.utils.synth import random_batch

REL = 1e-12
KW = dict(max_iter=2000, refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
          bland_after=200)


@functools.lru_cache(maxsize=None)
def _solved(seed, B, m, nv, kernel):
    """A batch of the bench's random LPs and the (basis, vstat, status) of
    K3's (pack 8) or K1's plain version on it."""
    lp = random_batch(seed, B, m, nv)
    data = bs.upload("cpu", *lp)
    if kernel == "k3":
        out = ps.packed_kernel_call(*ps.packed_args(*data, pack=8), pack=8, slack0=nv, **KW)
    else:
        out = bs.megakernel_rows(*data, slack0=nv, **KW)
    rows = out.reshape(B, -1).numpy()
    n = m + nv
    return lp, rows[:, :m].copy(), rows[:, m:m + n].copy(), rows[:, m + n].copy()


def _case(name):
    """(A, b, c, lo, hi, basis, vstat, status) of a named case."""
    if name.startswith("bench_"):  # 64 of the bench's 32x128 LPs, K3's bases
        (lp, basis, vstat, status) = _solved(0, 64, 32, 96, "k3")
    elif name.startswith("rows"):  # the 16/24/32-row shapes of mixed_lps
        m = int(name[4:])
        (lp, basis, vstat, status) = _solved(50 + m, 16, m, 3 * m, "k3")
    else:  # scenario_batch's 16x40 LPs, K1's bases
        (lp, basis, vstat, status) = _solved(0, 16, 16, 24, "k1")
    lp = [x.copy() for x in lp]
    basis, vstat, status = basis.copy(), vstat.copy(), status.copy()
    A, b, c, lo, hi = lp
    n = A.shape[2]
    if name == "bench_swapped":  # a nonbasic column takes a basic one's place
        for i in range(0, 64, 3):
            k, j = 5, int(np.flatnonzero(vstat[i] == int(VarStat.AT_LOWER))[0])
            vstat[i, basis[i, k]], vstat[i, j] = int(VarStat.AT_LOWER), int(VarStat.BASIC)
            basis[i, k] = j
    elif name == "bench_flipped":  # a nonbasic structural moves to its other bound
        for i in range(0, 64, 2):
            j = int(np.flatnonzero(vstat[i, :96] == int(VarStat.AT_LOWER))[0])
            vstat[i, j] = int(VarStat.AT_UPPER)
    elif name == "bench_status":
        status[::3] = int(Status.MAX_ITER)
        status[1::5] = int(Status.INFEASIBLE)
    elif name == "bench_infinite_bound":  # a nonbasic slack at its upper bound, +inf
        for i in range(0, 64, 4):
            j = 96 + int(np.flatnonzero(vstat[i, 96:] == int(VarStat.AT_LOWER))[0])
            vstat[i, j] = int(VarStat.AT_UPPER)
        assert np.isinf(hi[:, 96:]).all()
    return A, b, c, lo, hi, basis, vstat, status


def _close(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    with np.errstate(invalid="ignore"):  # inf - inf, where `same` holds
        return same | (np.abs(got - ref) <= REL * np.maximum(1.0, np.abs(ref)))


def _port(A, b, c, lo, hi, basis, vstat, status):
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x, dtype=dt))
    args = ([t(x, np.float64) for x in (A, b, c, lo, hi)]
            + [t(x, np.int32) for x in (basis, vstat, status)])
    before = certify.launches
    obj, ver, x = certify.certify_kernel_call(*args)
    assert certify.launches == before  # the plain version is no launch
    assert (obj.dtype, ver.dtype, x.dtype) == (torch.float64, torch.bool, torch.float64)
    return obj.numpy(), ver.numpy(), x.numpy()


def _reference(*case):
    """The reference's `_verify_f64` on numpy copies of the case; an infinite
    bound's NaNs (0·inf) are the point of that case, not a fault."""
    with np.errstate(invalid="ignore"):
        return ref_bs._verify_f64(*(np.copy(v) for v in case))


def _assert_same(got, ref):
    (obj, ver, x), (r_obj, r_ver, r_x) = got, [np.asarray(v) for v in ref]
    np.testing.assert_array_equal(ver, r_ver)
    assert _close(obj, r_obj).all(), np.flatnonzero(~_close(obj, r_obj))
    assert _close(x, r_x).all(), np.argwhere(~_close(x, r_x))[:4]


@pytest.mark.parametrize("name", ["bench_k3", "rows16", "rows24", "rows32", "scenario_k1",
                                  "bench_swapped", "bench_flipped", "bench_status",
                                  "bench_infinite_bound"])
def test_plain_matches_reference(name):
    case = _case(name)
    got = _port(*case)
    _assert_same(got, _reference(*case))
    ver = got[1]
    if name in ("bench_k3", "rows16", "rows24", "rows32", "scenario_k1"):
        assert ver.all()
    elif name == "bench_status":
        assert ver.sum() == 64 - len(set(range(0, 64, 3)) | set(range(1, 64, 5)))
    else:  # each edit breaks a check on the lanes it touched
        touched = {"bench_swapped": 3, "bench_flipped": 2, "bench_infinite_bound": 4}[name]
        assert not ver[::touched].any() and ver.sum() > 0
    if name == "bench_infinite_bound":
        assert np.isnan(got[0][::4]).all() and not np.isfinite(got[2][::4]).all()


def _two_lps(repeat: bool):
    """Two 2 x 4 LPs [A_s | I]: lane 0 solved at the slack basis; lane 1's
    basis repeats a column when `repeat`."""
    # column 0 is (1, 2): repeated, its LU meets an exact zero pivot (1 - 0.5·2)
    A = np.array([[[1.0, 2.0, 1.0, 0.0], [2.0, 1.0, 0.0, 1.0]]] * 2)
    b = np.array([[4.0, 6.0]] * 2)
    c = np.array([[1.0, 1.0, 0.0, 0.0]] * 2)
    lo, hi = np.zeros((2, 4)), np.full((2, 4), np.inf)
    basis = np.array([[2, 3], [0, 0] if repeat else [2, 3]], dtype=np.int32)
    vstat = np.array([[0, 0, 4, 4], [4, 0, 0, 0] if repeat else [0, 0, 4, 4]], dtype=np.int32)
    status = np.full(2, int(Status.OPTIMAL), dtype=np.int32)
    return A, b, c, lo, hi, basis, vstat, status


def test_singular_lane_fails_alone():
    """The recorded deviation (ROADMAP item 12): the reference's batched
    solve raises on lane 1's singular basis and fails both lanes; the port
    fails lane 1 only, and lane 0 is the reference's answer for lane 0
    alone."""
    case = _two_lps(repeat=True)
    obj, ver, x = _port(*case)
    r_obj, r_ver, r_x = _reference(*case)
    assert ver.tolist() == [True, False]
    assert np.asarray(r_ver).tolist() == [False, False]
    alone = _reference(*(v[:1] for v in case))
    _assert_same((obj[:1], ver[:1], x[:1]), alone)
    # the singular lane: x_B = 0, as the reference gives every lane
    assert _close(obj[1:], np.asarray(r_obj)[1:]).all()
    assert _close(x[1:], np.asarray(r_x)[1:]).all()
    _assert_same(_port(*_two_lps(repeat=False)), _reference(*_two_lps(repeat=False)))


def test_out_of_range_index_reads_a_zero_column():
    A, b, c, lo, hi, basis, vstat, status = _two_lps(repeat=False)
    basis[1, 1] = 7
    obj, ver, x = _port(A, b, c, lo, hi, basis, vstat, status)
    assert ver.tolist() == [True, False]
    np.testing.assert_array_equal(x[1], [0.0, 0.0, 0.0, 0.0])


def test_certify_out_packs_one_copy():
    """`certify_out` + `host_fields`: the rows come back exactly, beside
    the certificate of each lane."""
    (A, b, c, lo, hi), basis, vstat, status = _solved(0, 16, 16, 24, "k1")
    rows = np.concatenate([basis, vstat, status[:, None], np.arange(16)[:, None]], axis=1)
    data = bs.upload("cpu", A, b, c, lo, hi)
    packed = certify.certify_out(torch.as_tensor(rows.astype(np.int32)), *data)
    fields = certify.host_fields(packed.numpy(), 16, 40)
    for got, want in zip(fields[:4], (basis, vstat, status, np.arange(16))):
        np.testing.assert_array_equal(got, want)
        assert got.dtype == np.int32
    _assert_same(fields[4:7], _reference(A, b, c, lo, hi, basis, vstat, status))


def test_batch_entry_points_match_reference_check():
    """K1's and K3's batch entry points certify through the wrapper (here
    its plain version): their answers are the reference check's on the
    same bases."""
    A, b, c, lo, hi = random_batch(3, 16, 8, 24)
    for res in (bs.solve_batch_megakernel(A, b, c, lo, hi, device="cpu"),
                ps.solve_batch_packed(A, b, c, lo, hi, device="cpu", pack=4)):
        ref = _reference(A, b, c, lo, hi, res.basis, res.vstat, res.status)
        _assert_same((res.obj, res.verified, res.x), ref)
        assert res.verified.all()


def test_wrapper_checks_its_inputs():
    case = list(_two_lps(repeat=False))
    t = lambda x, dt: torch.as_tensor(np.ascontiguousarray(x, dtype=dt))
    args = [t(x, np.float64) for x in case[:5]] + [t(x, np.int32) for x in case[5:]]
    bad = list(args)
    bad[0] = args[0].float()
    with pytest.raises(ValueError, match="float64"):
        certify.certify_kernel_call(*bad)
    bad = list(args)
    bad[5] = args[5].long()
    with pytest.raises(ValueError, match="int32"):
        certify.certify_kernel_call(*bad)
    bad = list(args)
    bad[2] = args[2].t().contiguous().t()
    with pytest.raises(ValueError, match="contiguous"):
        certify.certify_kernel_call(*bad)
    with pytest.raises(ValueError, match="layout"):
        certify.certify_kernel_call(*args, layout="staged")
    with pytest.raises(ValueError, match="m <= n"):
        certify.certify_kernel_call(args[0].transpose(1, 2).contiguous(), *args[1:])


def test_device_f32_cast_is_numpys():
    """K1's and K3's f32 inputs are cast on the device from the f64 upload:
    round to nearest even, the bits of numpy's `astype(np.float32)`, on
    random data, half-ulp ties (both directions), subnormals and
    infinities."""
    rng = np.random.default_rng(0)
    x = rng.standard_normal(4096) * 10.0 ** rng.integers(-40, 40, 4096)
    one = np.float64(1.0)
    ulp = np.float64(np.spacing(np.float32(1.0)))
    ties = np.array([one + ulp / 2, one + 3 * ulp / 2, -(one + ulp / 2), 2.0 ** -149 * 1.5,
                     2.0 ** -149 * 2.5, 2.0 ** -150, 2.0 ** -151, 3.4028235677973366e38,
                     1e-45, 1e-39, -1e-42, np.inf, -np.inf, 0.0, -0.0, 1e300])
    x = np.concatenate([x, ties]).reshape(4, 2, -1)
    got = ps.packed_args(*(torch.as_tensor(v) for v in (x, x[..., 0], x[:, 0], x[:, 0],
                                                         x[:, 0])), pack=2)
    with np.errstate(over="ignore"):  # 1e300 rounds to inf, in both
        want = x.astype(np.float32)
    np.testing.assert_array_equal(got[0].numpy().view(np.uint32).ravel(),
                                  want.view(np.uint32).ravel())
