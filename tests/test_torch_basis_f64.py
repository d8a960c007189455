"""PyTorch port, the certificate of one LP's basis (`ops/kernels/basis_f64.py`)
against the JAX package's host code, on the CPU.

On the CPU the wrapper runs the kernel's plain torch version (`basis_plain`:
`torch.linalg.lu_factor_ex` and `lu_solve`).  The same numpy inputs (the
reference's canonical form of a seed-made LP, and a basis) go through the
reference's host code: `_verify_f64` on a batch of one, and a `minilp_tpu`
handle's certified state (`_state_from_certified_basis`), `certify()` and
B⁻¹ (`ensure_binv`), numpy's LU below 1024 rows and SuperLU from 1024 up.
Required: the same flags (`verified`, `certified`, a None state on a
singular basis), obj within 1e-12 relative on the dense branch and 1e-10 on
the SuperLU branch (two LU orders of one f64 solve), x, x_B and d within
1e-9 · max(1, |reference|), and B⁻¹·B within 1e-10 of I.  The bases: the
optimum, a basic column swapped for a nonbasic one, a non-optimal basis
(the host simplex cut short), a nonbasic variable at an infinite bound, a
repeated column and an exact zero pivot.

The port's own check (`engine/certificate.py`) is held to `basis_plain`
on both of its sides: its host code field by field, and its card route
(`certificate._certify_on_device`) driven with CPU tensors, where
`_state_from_certified_basis`, `certify` and `ensure_binv` give the host
route's state, one certificate serving them all.  The CUDA kernel is held
against `basis_plain` on the card by `test_torch_cuda.py` and
`chip_smoke.py`.
"""

import contextlib
import dataclasses
import functools

import numpy as np
import pytest
import torch

import minilp_tpu
from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.engine import driver as ref_driver
from minilp_tpu.engine import hostlp as ref_hostlp
from minilp_tpu.ops.kernels import batched_simplex as ref_bs
from minilp_tpu.utils.synth import netlib_shaped_problem
from minilp_tpu_torch import SolverOptions
from minilp_tpu_torch.canonical import CanonicalLP
from minilp_tpu_torch.engine import certificate, driver
from minilp_tpu_torch.ops.kernels import basis_f64
from minilp_tpu_torch.status import Status, VarStat

from .torch_helpers import as_torch_problem

#: tag -> (m, nv, density, seed): two shapes on the dense branch, one on
#: SuperLU's (padded M >= 1024)
SHAPES = {"48x96": (48, 96, 0.1, 3), "200x512": (200, 512, 0.02, 5),
          "1024x1400": (1020, 1400, 0.003, 7)}
CASES = ("optimal", "swapped", "non_optimal", "infinite_bound", "repeated", "zero_pivot")
REL_OBJ = {"48x96": 1e-12, "200x512": 1e-12, "1024x1400": 1e-10}
REL_X = 1e-9
EYE_TOL = 1e-10


@functools.lru_cache(maxsize=None)
def _solved(shape):
    """The reference's canonical form of a seed-made LP, its optimal basis
    (the host simplex) and a basis after a few pivots of it."""
    m, nv, dens, seed = SHAPES[shape]
    prob = netlib_shaped_problem(m, nv, dens, seed=seed)
    opts = minilp_tpu.SolverOptions()
    can = ref_canonicalize(prob, dtype=np.float64)
    A_csc = can.csc() if can.M >= ref_driver._SPARSE_HOST_M else None
    run = lambda **kw: ref_hostlp.solve_host_sparse(
        can.A, can.b, can.c, can.lo, can.hi, can.basis0, can.vstat0, opts=opts,
        A_csc=A_csc, **kw)
    best, short = run(), run(max_iter=12)
    assert int(best.status) == int(Status.OPTIMAL)
    assert int(short.status) == int(Status.MAX_ITER)
    return prob, can, (np.asarray(best.basis), np.asarray(best.vstat)), (
        np.asarray(short.basis), np.asarray(short.vstat))


def _case(shape, name):
    """(canonical form (a copy where the case edits it), basis, vstat,
    status) of a named case."""
    prob, can, (basis, vstat), (basis_s, vstat_s) = _solved(shape)
    basis, vstat = basis.astype(np.int32), vstat.astype(np.int32)
    status = int(Status.OPTIMAL)
    if name == "non_optimal":
        basis, vstat = basis_s.astype(np.int32), vstat_s.astype(np.int32)
    elif name == "swapped":
        # a nonbasic structural takes the place of the basic variable of its
        # largest tableau entry: a nonsingular basis, neither primal nor dual
        # feasible in general
        j = int(np.flatnonzero(vstat[:can.nv] == int(VarStat.AT_LOWER))[0])
        k = int(np.argmax(np.abs(np.linalg.solve(can.A[:, basis], can.A[:, j]))))
        vstat[basis[k]], vstat[j] = int(VarStat.AT_LOWER), int(VarStat.BASIC)
        basis[k] = j
    elif name == "infinite_bound":  # a nonbasic slack at its upper bound, +inf
        sl = np.arange(can.nv, can.nv + can.m)
        j = int(sl[(vstat[sl] == int(VarStat.AT_LOWER)) & np.isinf(can.hi[sl])][0])
        vstat[j] = int(VarStat.AT_UPPER)
    elif name == "repeated":
        basis[1] = basis[0]
    elif name == "zero_pivot":  # a basic column of A zeroed
        k = int(np.flatnonzero(basis < can.nv)[0])
        can = _copy(can)
        can.A[:, basis[k]] = 0.0
    return prob, can, basis, vstat, status


def _copy(can):
    return dataclasses.replace(can, A=can.A.copy(), b=can.b.copy(), c=can.c.copy(),
                               lo=can.lo.copy(), hi=can.hi.copy())


def _port_form(can):
    """A copy of the reference's canonical form as the port's `CanonicalLP`."""
    fields = {f.name: getattr(can, f.name) for f in dataclasses.fields(CanonicalLP) if f.init}
    return _copy(CanonicalLP(**fields))


def _plain(can, basis, vstat, status, **kw):
    t = lambda v, dt: torch.as_tensor(np.array(v, dtype=dt))
    args = ([t(v, np.float64) for v in (can.A, can.b, can.c, can.lo, can.hi)]
            + [t(basis, np.int32), t(vstat, np.int32)])
    before = basis_f64.launches
    packed = basis_f64.basis_kernel_call(*args, status, **kw)
    assert basis_f64.launches == before  # the plain version is no launch
    assert packed.dtype == torch.float64
    return basis_f64.unpack(packed.numpy(), can.M, can.N)


def _close(got, ref, rel):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref, dtype=np.float64)
    same = (got == ref) | (np.isnan(got) & np.isnan(ref))
    with np.errstate(invalid="ignore"):
        return bool((same | (np.abs(got - ref) <= rel * np.maximum(1.0, np.abs(ref)))).all())


def _ref_handle(prob, can, state):
    return ref_driver.EngineHandle(can, state, prob, minilp_tpu.SolverOptions())


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_reference_verify(shape, name):
    """`basis_plain` against the reference's `_verify_f64` with B = 1."""
    _prob, can, basis, vstat, status = _case(shape, name)
    got = _plain(can, basis, vstat, status)
    with np.errstate(invalid="ignore"):
        obj, ver, x = ref_bs._verify_f64(*(v[None] for v in (can.A, can.b, can.c, can.lo, can.hi,
                                                            basis, vstat)), np.array([status]))
    assert got.verified == bool(ver[0])
    assert got.singular == (name in ("repeated", "zero_pivot"))
    assert _close(got.obj, obj[0], REL_OBJ[shape]), (got.obj, obj[0])
    assert _close(got.x, x[0], REL_X)
    if name == "non_optimal":
        assert not got.verified
    if name == "optimal":
        assert got.verified


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", CASES)
def test_plain_matches_reference_state_certify_binv(shape, name):
    """The certificate's state, `certify()` and B⁻¹ against a `minilp_tpu`
    handle's on the same basis (numpy's LU or SuperLU by the shape)."""
    prob, can, basis, vstat, status = _case(shape, name)
    got = _plain(can, basis, vstat, status, inverse=True)
    opts = minilp_tpu.SolverOptions()
    with np.errstate(invalid="ignore"):
        state = ref_driver._state_from_certified_basis(can, basis, vstat, 0, opts)
    assert (state is None) == got.singular
    if state is None:
        return
    rel = REL_OBJ[shape]
    assert _close(got.obj, float(state.obj), rel)
    assert _close(got.xB, state.xB, REL_X)
    d = got.d.copy()
    d[vstat == int(VarStat.BASIC)] = 0.0
    assert _close(d, state.d, REL_X)
    handle = _ref_handle(prob, can, state)
    with np.errstate(invalid="ignore"):
        certified = handle.certify()
    assert certified == (got.pfeas and got.dfeas)
    if certified:
        assert _close(got.x, handle._x_full(), REL_X)
        assert _close(got.obj, handle._exact_obj, rel)
    handle.ensure_binv()
    B = can.A[:, basis]
    assert got.Binv.flags.c_contiguous
    assert np.abs(got.Binv @ B - np.eye(can.M)).max() <= EYE_TOL
    assert _close(got.Binv, handle._state.Binv, 1e-9)


def test_plain_matches_a_handle_solved_on_jax_cpu():
    """The certificate of the basis `minilp_tpu` finds on JAX-CPU against
    that handle's certified objective, vertex and B⁻¹."""
    prob = netlib_shaped_problem(*SHAPES["48x96"][:3], seed=SHAPES["48x96"][3])
    sol = prob.solve()
    h = sol._engine
    assert h.certified
    st = h.state  # materializes B⁻¹
    got = _plain(h.can, np.asarray(st.basis), np.asarray(st.vstat), int(Status.OPTIMAL),
                 inverse=True)
    assert got.verified and got.pfeas and got.dfeas and not got.singular
    assert _close(h.can.obj_sign * got.obj, sol.objective(), 1e-12)
    assert _close(got.x, h._x_full(), REL_X)
    assert np.abs(got.Binv - np.asarray(st.Binv)).max() <= 1e-9


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("name", ["optimal", "swapped", "repeated"])
def test_plain_row_of_binv(shape, name):
    """One row of B⁻¹ (`row`, what a Gomory cut reads) against the whole
    inverse's row and the reference handle's; None on a singular basis."""
    prob, can, basis, vstat, status = _case(shape, name)
    full = _plain(can, basis, vstat, status, inverse=True)
    pos = can.M // 3
    got = _plain(can, basis, vstat, status, row=pos)
    assert (got.verified, got.singular) == (full.verified, full.singular)
    assert _close(got.obj, full.obj, 0.0)  # the same solves (a NaN as NaN)
    if full.singular:
        assert got.Binv is None
        return
    assert got.Binv.shape == (1, can.M)
    assert _close(got.Binv[0], full.Binv[pos], 1e-9)
    with np.errstate(invalid="ignore"):
        state = ref_driver._state_from_certified_basis(can, basis, vstat, 0,
                                                       minilp_tpu.SolverOptions())
    handle = _ref_handle(prob, can, state)
    handle.ensure_binv()
    assert _close(got.Binv[0], handle._state.Binv[pos], 1e-9)


#: the host check's cases against `basis_plain`: (shape, case, keywords)
HOST_CASES = {
    "optimal_48x96": ("48x96", "optimal", {}),
    "optimal_superlu": ("1024x1400", "optimal", {}),
    "swapped_48x96": ("48x96", "swapped", {}),
    "singular_zero_pivot": ("48x96", "zero_pivot", {}),
    "singular_repeated_superlu": ("1024x1400", "repeated", {}),
    "inverse_48x96": ("48x96", "optimal", {"inverse": True}),
    "inverse_superlu": ("1024x1400", "swapped", {"inverse": True}),
    "row_48x96": ("48x96", "swapped", {"row": 16}),
    "row_superlu": ("1024x1400", "optimal", {"row": 341}),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_host_check_matches_plain(case):
    """`certificate.check` on a CPU solve (numpy's LU below 1024 padded
    rows, SuperLU from there) fills the same `Certificate` fields as the
    basis kernel's plain version: the flags exactly, the values within the
    tolerances above, B⁻¹ (or its one row) within 1e-9."""
    shape, name, kw = HOST_CASES[case]
    _prob, can, basis, vstat, status = _case(shape, name)
    can = _port_form(can)
    assert (can.M >= certificate.SPARSE_HOST_M) == (shape == "1024x1400")
    want = _plain(can, basis, vstat, status, **kw)
    got = certificate.check(can, basis, vstat, SolverOptions(device="cpu"), **kw)
    for flag in ("pfeas", "dfeas", "singular", "verified"):
        assert getattr(got, flag) == getattr(want, flag), flag
    assert got.singular == (name in ("zero_pivot", "repeated"))
    assert _close(got.obj, want.obj, REL_OBJ[shape]), (got.obj, want.obj)
    for field in ("x", "d", "xB", "y"):
        assert _close(getattr(got, field), getattr(want, field), REL_X), field
    if want.Binv is None:
        assert got.Binv is None
    else:
        assert got.Binv.shape == want.Binv.shape and got.Binv.flags.c_contiguous
        assert _close(got.Binv, want.Binv, 1e-9)


def test_wrapper_rejects_bad_inputs():
    _prob, can, basis, vstat, _status = _case("48x96", "optimal")
    t = lambda v, dt: torch.as_tensor(np.ascontiguousarray(v, dtype=dt))
    args = [t(v, np.float64) for v in (can.A, can.b, can.c, can.lo, can.hi)] + [
        t(basis, np.int32), t(vstat, np.int32)]
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(args[0].float(), *args[1:], 1)
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(*args[:5], args[5].long(), args[6], 1)
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(args[0].T, *args[1:], 1)
    with pytest.raises(ValueError):  # one row of B⁻¹, inside [0, m), without inverse
        basis_f64.basis_kernel_call(*args, 1, row=can.M)
    with pytest.raises(ValueError):
        basis_f64.basis_kernel_call(*args, 1, inverse=True, row=0)


def test_grid_blocks():
    assert basis_f64.grid_blocks(824, 132, 1) == 132
    assert basis_f64.grid_blocks(40, 132, 1) == 10
    assert basis_f64.grid_blocks(3136, 132, 2) == 132
    with pytest.raises(ValueError):
        basis_f64.grid_blocks(100, 132, 0)


@pytest.fixture
def card_route(monkeypatch):
    """The check's card route (`certificate._certify_on_device`) on CPU
    tensors; counts the plain version's calls (the launches it stands
    for)."""
    calls = []
    plain = basis_f64.basis_plain

    def counted(*args, **kw):
        calls.append("row" if kw.get("row") is not None else kw.get("inverse", False))
        return plain(*args, **kw)

    monkeypatch.setattr(certificate, "_certify_on_device", lambda opts: True)
    monkeypatch.setattr(basis_f64, "basis_plain", counted)
    return calls


@contextlib.contextmanager
def _host_route():
    saved = certificate._certify_on_device
    certificate._certify_on_device = lambda opts: False
    try:
        yield
    finally:
        certificate._certify_on_device = saved


def _port_solve(shape, **options):
    m, nv, dens, seed = SHAPES[shape]
    prob = as_torch_problem(netlib_shaped_problem(m, nv, dens, seed=seed), **options)
    return prob.solve()


@pytest.mark.parametrize("options", [{}, {"use_megakernel": "always"},
                                     {"use_streaming": "always", "use_megakernel": "never"}],
                         ids=["default", "k1", "k2"])
def test_card_route_wiring_gives_the_host_state(card_route, options):
    """A cold solve on the card route factors its basis once (the route's
    check of K1's or K2's claim serves the state and `certify`), then
    `ensure_binv` once more; the state, certificate and B⁻¹ are the host
    route's."""
    with _host_route():
        host = _port_solve("48x96", **options)._engine
        host_binv = np.asarray(host.state.Binv)
    assert not card_route
    sol = _port_solve("48x96", **options)
    card = sol._engine
    assert card.certified and host.certified
    assert card_route == [False]  # one factorization for the whole cold solve
    hs, cs = host._state, card._state
    np.testing.assert_array_equal(cs.basis, hs.basis)
    np.testing.assert_array_equal(cs.vstat, hs.vstat)
    assert cs.niter == hs.niter
    assert _close(cs.xB, hs.xB, REL_X) and _close(cs.d, hs.d, REL_X)
    assert _close(float(cs.obj), float(hs.obj), 1e-12)
    assert _close(card._x_full(), host._x_full(), REL_X)
    assert _close(card.user_objective(), host.user_objective(), 1e-12)
    lazy = card.binv_stale  # a state rebuilt from a certified basis
    assert lazy == (options != {})
    binv = np.asarray(card.state.Binv)
    assert card_route == [False] + [True] * lazy
    assert binv.flags.c_contiguous and binv.dtype == np.float64
    assert np.abs(binv - host_binv).max() <= 1e-9


def test_card_route_incremental_chain(card_route):
    """The incremental API on the card route: each edit's re-solve is the
    host route's (pivots, objective, certificate); the certificate kept on
    the canonical form is keyed on the LP as it stands, so each node is
    certified on its own edited LP."""
    from minilp_tpu_torch.utils.node_chain import run_chain

    with _host_route():
        host = run_chain(_port_solve("200x512"))
    n_cold = len(card_route)
    card = run_chain(_port_solve("200x512"))
    # every node certified on the route
    assert len(card_route) - n_cold >= sum(n.outcome == "optimal" for n in card)
    assert len(card) == len(host)
    for h, c in zip(host, card):
        assert (c.edit, c.outcome, c.pivots, c.certified) == (h.edit, h.outcome, h.pivots,
                                                              h.certified)
        if h.outcome == "optimal":
            assert _close(c.objective, h.objective, 1e-9)


def test_card_route_exact_inverse(card_route):
    """`_exact_inverse` (the engines' resume after a Newton divergence) on
    the card route: the basis kernel's B⁻¹, LinAlgError on a singular
    basis, as numpy's inverse on the host."""
    _prob, can, basis, vstat, _status = _case("48x96", "optimal")
    can, opts = _port_form(can), SolverOptions(device="cpu")
    binv = driver._exact_inverse(can, basis, vstat, opts)
    assert np.abs(binv - np.linalg.inv(can.A[:, basis])).max() <= 1e-9
    with pytest.raises(np.linalg.LinAlgError):
        driver._exact_inverse(can, np.r_[basis[:1], basis[:-1]], vstat, opts)


def test_card_route_certificate_follows_edits(card_route):
    """The certificate kept on the canonical form serves the same (basis,
    vstat) of the same LP; an edit of b, c, lo or hi in place makes the next
    call launch again, with nothing to drop by hand."""
    _prob, can, basis, vstat, _status = _case("48x96", "optimal")
    can, opts = _port_form(can), SolverOptions(device="cpu")
    first = certificate.check(can, basis, vstat, opts)
    assert certificate.check(can, basis, vstat, opts) is first
    assert certificate.check(can, basis, vstat, opts, tol=1e-6) is not first
    assert card_route == [False, False]
    for name in ("b", "c", "lo", "hi"):
        v = getattr(can, name)
        k = int(np.flatnonzero(np.isfinite(v))[0])
        v[k] += 0.5
        edited = certificate.check(can, basis, vstat, opts)
        assert edited is not first, name
        v[k] -= 0.5
    assert card_route == [False] * 6
    # what was asked for: a certificate without B⁻¹ does not serve `inverse`
    with_inverse = certificate.check(can, basis, vstat, opts, inverse=True)
    assert with_inverse.Binv is not None and card_route[-1] is True
    assert certificate.check(can, basis, vstat, opts) is with_inverse


def test_card_route_handle_keeps_copies(card_route):
    """`ensure_binv` and `certify` on the card route put copies of the kept
    certificate's B⁻¹ and x into the handle: an edit through the handle
    leaves the certificate as it was."""
    h = _port_solve("48x96", use_megakernel="always")._engine
    h.ensure_binv()
    st = h._state
    kept = certificate.check(h.can, st.basis, st.vstat, h.opts, inverse=True)
    assert kept.Binv is not None
    assert not np.shares_memory(h._state.Binv, kept.Binv)
    assert not np.shares_memory(h._x_full(), kept.x)
    assert card_route == [False, True]


def test_card_route_gomory_row(card_route):
    """`add_gomory_cut` on a lazy B⁻¹ of the card route reads one row of
    B⁻¹ from one launch (`row`), and cuts and re-solves as the host route
    does."""
    from minilp_tpu_torch import Variable

    def cut():
        sol = _port_solve("200x512", use_megakernel="always")
        h = sol._engine
        assert h.binv_stale
        nv = h.can.nv
        x = h._x_full()[:nv]
        frac = [int(k) for k in np.asarray(h._state.basis)
                if k < nv and 1e-6 < x[k] - np.floor(x[k]) < 1.0 - 1e-6]
        g = min(frac, key=lambda k: (abs(x[k] - np.floor(x[k]) - 0.5), k))
        n0 = len(card_route)
        new = sol.add_gomory_cut(Variable(g))
        can = new._engine.can
        return (can.A[can.m - 1, :nv].copy(), float(can.b[can.m - 1]), new.objective(),
                card_route[n0:])

    with _host_route():
        row_h, rhs_h, obj_h, _ = cut()
    row_c, rhs_c, obj_c, calls = cut()
    assert calls[0] == "row" and calls.count("row") == 1
    assert _close(row_c, row_h, 1e-9) and _close(rhs_c, rhs_h, 1e-9)
    assert _close(obj_c, obj_h, 1e-9)
