"""The exact f64 check of one basis of a canonical LP, for every route.

Every single-LP route ends on a basis: K1's or K2's f32 claim, the host's
polish, the crossover, a warm re-solve.  Whether that basis is exactly
optimal, and its exact state (x_B, y, d, x, the objective, B⁻¹ or one row
of it), is asked here and nowhere else: `check` answers with a
`basis_f64.Certificate` on either side of the one choice this module owns.

* A card solve (`_certify_on_device`) launches the basis kernel
  (`ops/kernels/basis_f64.py`) on an f64 copy of A kept on the card, one
  upload for each version of A (`upload`, `_A_version`).
* A CPU solve keeps the JAX package's host code: numpy's dense solves below
  `SPARSE_HOST_M` padded rows, SuperLU at and above it (the factors a host
  route hands over, `lu`, when it has them).

Both fill the same fields with the kernel's semantics (module docstring of
`basis_f64.py`): a basis that repeats a column or meets an exact zero pivot
is `singular`, with x_B = y = 0.  The claim's status is not an input:
`verified` means the basis passed, and the caller adds its claim.

Each canonical form keeps its last certificate (`CanonicalLP.checks`) under
a key of the path, A's version and a digest of b, c, lo, hi, basis and
vstat (`_key`), so the route's check, the state rebuilt from it and
`certify()` share one factorization, and no edit has to drop it.
"""

from __future__ import annotations

import hashlib
from typing import Optional

import numpy as np
import torch

from ..canonical import CanonicalLP, nonbasic_values
from ..ops.kernels import basis_f64
from ..options import SolverOptions
from ..status import Status, VarStat
from ..utils import profiling
from . import hostlp

#: padded rows from which host-side exact linear algebra goes through the
#: sparse LU (`engine/hostlp.py`) instead of dense LAPACK
SPARSE_HOST_M = 1024


def _certify_on_device(opts: SolverOptions) -> bool:
    """Whether the solve's bases are checked on its device by the basis
    kernel: a card solve's are; a CPU solve keeps the host code."""
    return torch.device(opts.device).type == "cuda"


def span(name: str, opts: SolverOptions) -> profiling.span:
    """The span of a block whose work is a check: a host span (a profiler
    range) on a CPU solve, a device span on a card solve."""
    return profiling.span(name, host=not _certify_on_device(opts))


def _A_version(can: CanonicalLP) -> tuple:
    """What tells one A of `can` from another: an edit of A activates a
    padding row (`incremental._append_row`: `can.m` grows), and a larger
    padding is a new shape."""
    return (can.m,) + can.A.shape


def upload(can: CanonicalLP, opts: SolverOptions) -> Optional[torch.Tensor]:
    """`can.A` in f64 on a card solve's device, uploaded once for each of
    its versions; None on a CPU solve.  K2's route calls it before its
    launch, so that the copy is made before the span `finish`."""
    if not _certify_on_device(opts):
        return None
    dev = torch.device(opts.device)
    key = (dev, _A_version(can))
    kept = can.checks.get("A")
    if kept is None or kept[0] != key:
        A = np.ascontiguousarray(can.A, dtype=np.float64)
        with profiling.span("upload", dev):
            kept = can.checks["A"] = (key, torch.as_tensor(A, device=dev))
    return kept[1]


def _key(can: CanonicalLP, basis, vstat, opts: SolverOptions, tol: float) -> tuple:
    """What a certificate of (basis, vstat) on `can` depends on: the path
    (the card's device, or the host), A's version (`_A_version`), a digest
    of b, c, lo, hi, basis and vstat, and `tol`."""
    digest = hashlib.blake2b(digest_size=16)
    for v, dt in ((can.b, np.float64), (can.c, np.float64), (can.lo, np.float64),
                  (can.hi, np.float64), (basis, np.int32), (vstat, np.int32)):
        digest.update(np.ascontiguousarray(v, dtype=dt).tobytes())
    path = torch.device(opts.device) if _certify_on_device(opts) else None
    return path, _A_version(can), digest.digest(), float(tol)


def check(can: CanonicalLP, basis, vstat, opts: SolverOptions, *, tol: float = basis_f64.TOL,
          inverse: bool = False, row: Optional[int] = None, lu=None) -> basis_f64.Certificate:
    """The certificate of (basis, vstat) on `can`: x_B, y, d, x, obj, the
    feasibility flags at `tol`, `singular`, and B⁻¹ with `inverse` or its
    row `row` alone (what a Gomory cut reads).  The basis kernel on a card
    solve, the host code on a CPU solve (module docstring); `lu`, a host
    route's `hostlp.BasisLU` of this basis, saves the host's SuperLU.

    The form's last certificate serves a later call for the same inputs
    while it has what is asked; a `row` call neither reads nor keeps it."""
    basis, vstat = np.asarray(basis), np.asarray(vstat)
    key = None
    if row is None:
        key = _key(can, basis, vstat, opts, tol)
        kept = can.checks.get("cert")
        if kept is not None and kept[0] == key and (
                not inverse or kept[1].Binv is not None or kept[1].singular):
            return kept[1]
    if _certify_on_device(opts):
        cert = _on_card(can, basis, vstat, opts, tol=tol, inverse=inverse, row=row)
    else:
        cert = _on_host(can, basis, vstat, tol=tol, inverse=inverse, row=row, lu=lu)
    if key is not None:
        can.checks["cert"] = (key, cert)
    return cert


def _on_card(can, basis, vstat, opts, **kw) -> basis_f64.Certificate:
    """One launch of the basis kernel on the solve's device (`kw` its
    `tol`, `inverse` and `row`)."""
    dev = torch.device(opts.device)
    A = upload(can, opts)
    put = lambda v, dt: torch.as_tensor(np.ascontiguousarray(v, dtype=dt), device=dev)
    with profiling.span("upload", dev):
        vecs = [put(v, np.float64) for v in (can.b, can.c, can.lo, can.hi)]
        vecs += [put(basis, np.int32), put(vstat, np.int32)]
    return basis_f64.certificate(A, *vecs, int(Status.OPTIMAL), **kw)


def _on_host(can, basis, vstat, *, tol, inverse, row, lu) -> basis_f64.Certificate:
    """The host's check: numpy's dense solves below `SPARSE_HOST_M` padded
    rows, SuperLU (`lu`, else a factorization of its own) from there."""
    A, b, c, lo, hi = (np.asarray(v, dtype=np.float64) for v in
                       (can.A, can.b, can.c, can.lo, can.hi))
    m = A.shape[0]
    xN = nonbasic_values(vstat, lo, hi)
    rhs, cB = b - A @ xN, c[basis]
    e_row = None if row is None else np.eye(1, m, row)[0]
    singular, binv = np.unique(basis).size < m, None
    if not singular and can.M >= SPARSE_HOST_M:
        if lu is None:
            lu = hostlp.factorize_basis(A, basis, A_csc=can.csc())
        singular = lu is None
        if not singular:
            xB, y = lu.lu.solve(rhs), lu.lu.solve(cB, trans="T")
            if inverse:
                binv = lu.lu.solve(np.eye(m))
            elif row is not None:
                binv = lu.lu.solve(e_row, trans="T")[None]
    elif not singular:
        Bmat = A[:, basis]
        try:
            xB, y = np.linalg.solve(Bmat, rhs), np.linalg.solve(Bmat.T, cB)
            if inverse:
                binv = np.linalg.inv(Bmat)
            elif row is not None:
                binv = np.linalg.solve(Bmat.T, e_row)[None]
        except np.linalg.LinAlgError:
            singular = True
    if singular:
        xB, y, binv = np.zeros(m), np.zeros(m), None
    d = c - y @ A
    pfeas = bool(((xB >= lo[basis] - tol) & (xB <= hi[basis] + tol)).all())
    at_lo, at_hi = vstat == int(VarStat.AT_LOWER), vstat == int(VarStat.AT_UPPER)
    free = vstat == int(VarStat.FREE)
    dfeas = bool((np.where(at_lo, d >= -tol, True) & np.where(at_hi, d <= tol, True)
                  & np.where(free, np.abs(d) <= tol, True)).all())
    x = xN.copy()
    x[basis] = xB
    return basis_f64.Certificate(
        x=x, d=d, xB=xB, y=y, obj=float(cB @ xB + c @ xN), pfeas=pfeas, dfeas=dfeas,
        singular=bool(singular), verified=bool(pfeas and dfeas and not singular),
        Binv=None if binv is None else np.ascontiguousarray(binv))
