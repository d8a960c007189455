"""The f64 certificate, state and B⁻¹ of ONE LP's final basis, on the card.

Every single-LP route ends on a basis: K1's or K2's f32 claim, the host's
polish, the crossover, a warm re-solve.  The JAX package checks it on the
host: numpy's `_verify_f64` on the kernels' claims
(`minilp_tpu/ops/kernels/batched_simplex.py:555`), then
`_state_from_certified_basis`, `EngineHandle._certify_timed` and
`ensure_binv` (`minilp_tpu/engine/driver.py`) and `_exact_host_inverse`
(`minilp_tpu/engine/incremental.py`), each factoring the same B =
A[:, basis] again (LAPACK below 1024 rows, SuperLU above), because the
TPU's f64 LU does not compile.  The H100 has native f64, so a card solve
factors its basis once, here:

* `basis_kernel_call` — the kernel wrapper.  On CUDA tensors it launches
  the hand-written kernel (`minilp_tpu_torch/csrc/basis_f64.cu`: one
  cooperative grid, a right-looking f64 LU with LAPACK's partial pivoting
  over the SMs, the triangular solves, d, and B⁻¹ or one row of it on
  request) and counts the
  launch in `launches`; on CPU tensors it runs `basis_plain`.  Nothing else
  selects between the two, and nothing falls back: a failed build or launch
  raises.  Its results do not depend on the grid's size (`blocks`).
* `basis_plain` — the plain torch version (`torch.linalg.lu_factor_ex`,
  `lu_solve`), for the CPU and for the comparison on the card.
* `certificate` — the wrapper's packed result copied to the host once and
  unpacked into a `Certificate`, the type that the host's check
  (`engine/certificate.py`) fills too: x_B, y, d, x, obj, the two
  feasibility flags, `singular`, B⁻¹ or the row of it that a Gomory cut
  reads.

Semantics are the host code's: x_N from vstat (AT_LOWER and FIXED at lo,
AT_UPPER at hi, BASIC and FREE at 0), rhs = b − A·x_N, B·x_B = rhs,
Bᵀ·y = c_B, d = c − Aᵀ·y, pfeas (x_B within [lo − tol, hi + tol]) and dfeas
(d ≥ −tol at lower, ≤ tol at upper, |d| ≤ tol free), obj = c_B·x_B + c·x_N,
x = x_N with x_B scattered, and `singular` on an exact zero pivot or a
basis that repeats a column (x_B = y = 0 then, as `_verify_f64` has them).
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional

import numpy as np
import torch

from ...status import Status, VarStat
from ...utils import profiling
from . import build

#: launches of the CUDA kernel in this process (plain-version calls do not
#: count); `chip_smoke.py` resets it before driving a path and reads it after
launches = 0

#: the host check's tolerance of both feasibility tests
TOL = 1e-7

#: the scalars at the end of the packed result
SCALARS = ("obj", "pfeas", "dfeas", "singular", "verified")

#: blocks of a default grid per row: a block owns at least this many columns
#: of the LU
COLS_PER_BLOCK = 4

#: most blocks of one launch (`kMaxGrid` of `csrc/simplex_grid.cuh`)
MAX_GRID = 1024

_I = ctypes.c_int
_P = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    lib = build.load("basis_f64").lib
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.basis_f64_workspace_bytes.argtypes = [_I, _I]
    lib.basis_f64_workspace_bytes.restype = ctypes.c_size_t
    lib.basis_f64_smem_bytes.argtypes = [_I, _I]
    lib.basis_f64_smem_bytes.restype = ctypes.c_size_t
    lib.basis_f64_grid_limits.argtypes = [_I, _I, _P, _P]
    lib.basis_f64_grid_limits.restype = _I
    lib.basis_f64_launch.argtypes = ([_P] * 7 + [_I, ctypes.c_double] + [_P] * 2
                                     + [_I, _P] + [_I] * 3 + [_P])
    lib.basis_f64_launch.restype = _I
    lib.basis_f64_error_string.argtypes = [_I]
    lib.basis_f64_error_string.restype = ctypes.c_char_p
    return lib


def packed_size(m: int, n: int, binv_rows: int = 0) -> int:
    """Doubles of the packed result: [x (n) | d (n) | x_B (m) | y (m) |
    `SCALARS` | `binv_rows` rows of B⁻¹ (row-major)]."""
    return 2 * n + 2 * m + len(SCALARS) + binv_rows * m


def _binv_rows(m: int, inverse: bool, row: Optional[int]) -> int:
    """Rows of B⁻¹ in the packed result: m with `inverse`, 1 with `row`."""
    if row is None:
        return m if inverse else 0
    if inverse or not 0 <= row < m:
        raise ValueError(f"row={row} asks for one row of B⁻¹ in [0, {m}), without inverse")
    return 1


def grid_blocks(m: int, sm_count: int, per_sm: int) -> int:
    """Blocks of the cooperative grid at m rows: one per SM (no more than
    are resident at once), and no more than one per `COLS_PER_BLOCK`
    columns of the LU."""
    if sm_count * per_sm < 1:
        raise ValueError(f"no block of the basis kernel fits: {sm_count} SMs x {per_sm} per SM")
    return max(1, min(sm_count, sm_count * per_sm, -(-m // COLS_PER_BLOCK)))


def default_blocks(device, m: int) -> int:
    """`grid_blocks` on a CUDA device's own limits, for the shared memory
    of that grid; raises with the CUDA error when the device cannot launch
    a cooperative grid."""
    lib = _library()
    sms, per_sm = _I(0), _I(0)
    blocks = -(-m // COLS_PER_BLOCK)
    with torch.cuda.device(device):
        for _ in range(2):  # the shared memory depends on the grid: settle it
            err = lib.basis_f64_grid_limits(m, blocks, ctypes.byref(sms), ctypes.byref(per_sm))
            if err != 0:
                msg = lib.basis_f64_error_string(err).decode()
                raise RuntimeError(f"basis_f64 cannot launch a cooperative grid: {msg} ({err})")
            blocks = grid_blocks(m, sms.value, per_sm.value)
    return blocks


def _check_inputs(A, b, c, lo, hi, basis, vstat):
    if not isinstance(A, torch.Tensor) or A.dim() != 2:
        raise ValueError("A must be an (m, n) torch.Tensor")
    m, n = A.shape
    if not 1 <= m <= n:
        raise ValueError(f"need 1 <= m <= n, got m={m}, n={n}")
    want = {"A": (A, (m, n), torch.float64), "b": (b, (m,), torch.float64),
            "c": (c, (n,), torch.float64), "lo": (lo, (n,), torch.float64),
            "hi": (hi, (n,), torch.float64), "basis": (basis, (m,), torch.int32),
            "vstat": (vstat, (n,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def basis_kernel_call(A, b, c, lo, hi, basis, vstat, status: int, *, inverse: bool = False,
                      row: Optional[int] = None, blocks: Optional[int] = None,
                      tol: float = TOL) -> torch.Tensor:
    """The certificate of one LP's basis as one packed f64 tensor on the
    inputs' device (`packed_size`: x, d, x_B, y, `SCALARS`, and B⁻¹ when
    `inverse`, or only its row `row`).

    Inputs: A (m, n), b (m), c/lo/hi (n) f64; basis (m), vstat (n) int32,
    all contiguous on one device; `status` the claim's status (`verified`
    needs OPTIMAL).  CUDA tensors launch the kernel on the current stream
    (no synchronisation) as one cooperative grid of `blocks` blocks, by
    default `default_blocks`, whose result does not depend on it; CPU
    tensors run `basis_plain`.
    """
    _check_inputs(A, b, c, lo, hi, basis, vstat)
    m, n = A.shape
    rows = _binv_rows(m, inverse, row)
    if blocks is not None and not 1 <= blocks <= MAX_GRID:
        raise ValueError(f"blocks={blocks} must be in [1, {MAX_GRID}]")
    if A.device.type == "cpu":
        return basis_plain(A, b, c, lo, hi, basis, vstat, status, inverse=inverse, row=row,
                           tol=tol)
    if A.device.type != "cuda":
        raise ValueError(f"the basis kernel runs on CUDA (kernel) or CPU (plain), not {A.device}")
    lib = _library()
    if blocks is None:
        blocks = default_blocks(A.device, m)
    out = torch.empty(packed_size(m, n, rows), dtype=torch.float64, device=A.device)
    ws = torch.empty(lib.basis_f64_workspace_bytes(m, n), dtype=torch.uint8, device=A.device)
    binv = out[packed_size(m, n):].data_ptr() if rows else None
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.basis_f64_launch(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            basis.data_ptr(), vstat.data_ptr(), int(status), float(tol), out.data_ptr(), binv,
            -1 if row is None else int(row), ws.data_ptr(), m, n, int(blocks), stream,
        )
    if err != 0:
        msg = lib.basis_f64_error_string(err).decode()
        raise RuntimeError(f"basis_f64 kernel launch failed: {msg} ({err})")
    global launches
    launches += 1
    return out


def basis_plain(A, b, c, lo, hi, basis, vstat, status: int, *, inverse: bool = False,
                row: Optional[int] = None, tol: float = TOL) -> torch.Tensor:
    """Plain torch version of the kernel (any device), same inputs and
    packed output as `basis_kernel_call`: one `torch.linalg.lu_factor_ex`
    of B, `lu_solve` for x_B, y and B⁻¹ (its row `row`: Bᵀw = e_row)."""
    m, n = A.shape
    rows = _binv_rows(m, inverse, row)
    idx = basis.long()
    valid = (idx >= 0) & (idx < n)
    # an index outside [0, n) reads column n: zeros in A and c, and x's
    # scatter drops it
    col = torch.where(valid, idx, n)
    pad = lambda t: torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
    Bmat = pad(A)[:, col]
    repeated = bool((torch.sort(idx).values.diff() == 0).any())
    at_lo, at_hi = vstat == int(VarStat.AT_LOWER), vstat == int(VarStat.AT_UPPER)
    free = vstat == int(VarStat.FREE)
    xN = torch.where(at_lo | (vstat == int(VarStat.FIXED)), lo,
                     torch.where(at_hi, hi, torch.zeros_like(lo)))
    rhs = b - (A * xN).sum(dim=1)  # every product, as numpy's (0·inf is NaN)
    cB = pad(c)[col]
    LU, piv, info = torch.linalg.lu_factor_ex(Bmat)
    singular = bool(info != 0) or repeated
    if singular:
        xB, y = torch.zeros_like(rhs), torch.zeros_like(cB)
    else:
        xB = torch.linalg.lu_solve(LU, piv, rhs[:, None])[:, 0]
        y = torch.linalg.lu_solve(LU, piv, cB[:, None], adjoint=True)[:, 0]
    d = c - (y[:, None] * A).sum(dim=0)
    loB, hiB = pad(lo)[col], pad(hi)[col]
    pfeas = bool(((xB >= loB - tol) & (xB <= hiB + tol)).all())
    dfeas = bool(((~at_lo | (d >= -tol)) & (~at_hi | (d <= tol))
                  & (~free | (d.abs() <= tol))).all())
    obj = (cB * xB).sum() + (c * xN).sum()
    x = pad(xN).scatter(0, col, xB)[:n]
    verified = pfeas and dfeas and not singular and int(status) == int(Status.OPTIMAL)
    flags = torch.tensor([pfeas, dfeas, singular, verified], dtype=A.dtype, device=A.device)
    parts = [x, d, xB, y, obj[None], flags]
    if rows:
        eye = torch.eye(m, dtype=A.dtype, device=A.device)
        if singular:
            binv = torch.zeros(rows, m, dtype=A.dtype, device=A.device)
        elif row is None:
            binv = torch.linalg.lu_solve(LU, piv, eye)
        else:
            binv = torch.linalg.lu_solve(LU, piv, eye[:, row:row + 1], adjoint=True).T
        parts.append(binv.reshape(-1))
    return torch.cat(parts)


@dataclasses.dataclass
class Certificate:
    """One basis's certificate on the host (numpy f64): `basis_kernel_call`'s
    packed result, unpacked."""

    x: np.ndarray
    d: np.ndarray
    xB: np.ndarray
    y: np.ndarray
    obj: float
    pfeas: bool
    dfeas: bool
    singular: bool
    verified: bool
    #: B⁻¹ (m, m), or the one row asked for (1, m), C order; None unless
    #: asked for (or singular)
    Binv: Optional[np.ndarray]


def unpack(packed, m: int, n: int) -> Certificate:
    """A packed result (host numpy) as a `Certificate`; the rows of B⁻¹
    it holds follow from its length."""
    buf = np.asarray(packed)
    rows = (buf.size - packed_size(m, n)) // m
    x, d, xB, y = (buf[o:o + k].copy() for o, k in
                   ((0, n), (n, n), (2 * n, m), (2 * n + m, m)))
    sc = dict(zip(SCALARS, buf[2 * n + 2 * m:2 * n + 2 * m + len(SCALARS)]))
    singular = bool(sc["singular"])
    binv = None
    if rows and not singular:
        binv = buf[packed_size(m, n):].reshape(rows, m).copy()
    return Certificate(x=x, d=d, xB=xB, y=y, obj=float(sc["obj"]), pfeas=bool(sc["pfeas"]),
                       dfeas=bool(sc["dfeas"]), singular=singular,
                       verified=bool(sc["verified"]), Binv=binv)


def certificate(A, b, c, lo, hi, basis, vstat, status: int, *, inverse: bool = False,
                row: Optional[int] = None, blocks: Optional[int] = None,
                tol: float = TOL) -> Certificate:
    """`basis_kernel_call` on the inputs' device, copied to the host once;
    on a card its time goes to the stage `basis_dev_s` (CUDA events)."""
    m, n = A.shape
    with profiling.device_stage("basis_dev_s", A.device):
        packed = basis_kernel_call(A, b, c, lo, hi, basis, vstat, status, inverse=inverse,
                                   row=row, blocks=blocks, tol=tol)
    return unpack(packed.cpu().numpy(), m, n)
