"""The f64 certificate of a batch of LP bases, on the card.

K1 (in batch mode) and K3 solve each LP of a batch in f32 and return its
final basis and variable statuses.  The basis is combinatorial, so the exact
answer follows from one f64 solve per lane: x_N from the statuses, x_B =
B⁻¹(b − A·x_N), y = B⁻ᵀc_B, d = c − Aᵀy, and the certificate that x_B lies
within its bounds and d has the right sign (both at 1e-7) on an OPTIMAL
claim.  The JAX package computes it on the host in numpy (`_verify_f64`,
`minilp_tpu/ops/kernels/batched_simplex.py:555`) because the TPU's f64 linear
algebra neither compiled quickly nor, at some shapes, correctly; the H100
has native f64, so the port's batch entry points certify on the card:

* `certify_kernel_call` — the kernel wrapper.  On CUDA tensors it launches
  the hand-written kernel (`minilp_tpu_torch/csrc/certify_f64.cu`, one thread
  block per lane, an LU with partial pivoting in f64) and counts the launch
  in `launches`; on CPU tensors it runs `certify_plain`.  Nothing else
  selects between the two, and nothing falls back: a failed build or launch
  raises.  The kernel's workspace sits in shared memory where one lane's
  fits (`LAYOUTS`, `pick_layout`); both layouts give the same bits.
* `certify_plain` — the plain torch version (`torch.linalg.lu_factor_ex` and
  `lu_solve` over the batch), for the CPU and for the comparison on the card.
* `certify_out` and `host_fields` — the batch entry points' plumbing: the
  certificate of a kernel's output rows, packed into one f64 tensor for one
  copy to the host, and that copy unpacked into `BatchResult`'s fields.

One recorded deviation from `_verify_f64`: an exactly singular basis (an
exact zero pivot, or a basis that repeats a column) fails its own lane only.
numpy's batched solve raises `LinAlgError` for the whole batch, and the host
check then fails every lane.  The single-LP routes (the driver's K1 launch,
K2's `solve_streaming`) keep the host check `_verify_f64`.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from ...status import Status, VarStat
from . import build

#: launches of the CUDA kernel in this process (plain-version calls do not
#: count); `chip_smoke.py` resets it before driving the batched paths and
#: reads it after
launches = 0

#: the kernel's layouts, in the order the default tries them: "shared" (one
#: lane's workspace in shared memory), "global" (in global memory; always
#: fits)
LAYOUTS = ("shared", "global")

#: `_verify_f64`'s tolerance of both checks
TOL = 1e-7

_I = ctypes.c_int
_P = ctypes.c_void_p


def _library() -> ctypes.CDLL:
    lib = build.load("certify_f64").lib
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.certify_f64_workspace_doubles.argtypes = [_I, _I]
    lib.certify_f64_workspace_doubles.restype = ctypes.c_size_t
    lib.certify_f64_layout_fits.argtypes = [_I, _I, _I]
    lib.certify_f64_layout_fits.restype = _I
    lib.certify_f64_smem_bytes.argtypes = [_I, _I, _I]
    lib.certify_f64_smem_bytes.restype = ctypes.c_size_t
    lib.certify_f64_launch.argtypes = [_P] * 12 + [_I] * 4 + [_P]
    lib.certify_f64_launch.restype = _I
    lib.certify_f64_error_string.argtypes = [_I]
    lib.certify_f64_error_string.restype = ctypes.c_char_p
    return lib


def _check_layout(layout) -> None:
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout must be None or one of {LAYOUTS}, got {layout!r}")


def pick_layout(m: int, n: int, layout: Optional[str] = None) -> str:
    """The layout of a launch on lanes of m x n: `layout` where it fits (else
    ValueError), or the first of `LAYOUTS` that fits.  Builds the kernel's
    library (the sizes are the kernel's own)."""
    _check_layout(layout)
    lib = _library()
    fits = [name for code, name in enumerate(LAYOUTS)
            if lib.certify_f64_layout_fits(code, m, n)]
    if layout is None:
        return fits[0]
    if layout not in fits:
        raise ValueError(f"layout {layout!r} does not fit lanes of {m}x{n} (fits: {fits})")
    return layout


def smem_bytes(m: int, n: int, layout: str) -> int:
    """Dynamic shared memory of one block in `layout`, in bytes."""
    return int(_library().certify_f64_smem_bytes(LAYOUTS.index(layout), m, n))


def _check_inputs(A, b, c, lo, hi, basis, vstat, status):
    if not isinstance(A, torch.Tensor) or A.dim() != 3:
        raise ValueError("A must be a (B, m, n) torch.Tensor")
    B, m, n = A.shape
    if not 1 <= m <= n:
        raise ValueError(f"need 1 <= m <= n, got m={m}, n={n}")
    want = {"A": (A, (B, m, n), torch.float64), "b": (b, (B, m), torch.float64),
            "c": (c, (B, n), torch.float64), "lo": (lo, (B, n), torch.float64),
            "hi": (hi, (B, n), torch.float64), "basis": (basis, (B, m), torch.int32),
            "vstat": (vstat, (B, n), torch.int32), "status": (status, (B,), torch.int32)}
    for name, (t, shape, dtype) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if tuple(t.shape) != shape or t.dtype != dtype:
            raise ValueError(f"{name} must be {shape} {dtype}, got {tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def certify_kernel_call(A, b, c, lo, hi, basis, vstat, status, *,
                        layout: Optional[str] = None):
    """The f64 certificate of B lanes: (obj (B,) f64, verified (B,) bool, x
    (B, n) f64) on the inputs' device.

    Inputs: A (B, m, n), b (B, m), c/lo/hi (B, n) f64; basis (B, m), vstat
    (B, n), status (B,) int32; all contiguous on one device.  CUDA tensors
    launch the kernel on the current stream (no synchronisation) in `layout`
    (`pick_layout`: None takes the first of `LAYOUTS` that fits; a forced one
    that does not fit raises ValueError); CPU tensors run `certify_plain`.
    """
    _check_inputs(A, b, c, lo, hi, basis, vstat, status)
    _check_layout(layout)
    if A.device.type == "cpu":
        return certify_plain(A, b, c, lo, hi, basis, vstat, status)
    if A.device.type != "cuda":
        raise ValueError(f"the certificate runs on CUDA (kernel) or CPU (plain), not {A.device}")
    B, m, n = A.shape
    layout = pick_layout(m, n, layout)
    lib = _library()
    obj = torch.empty(B, dtype=torch.float64, device=A.device)
    verified = torch.empty(B, dtype=torch.uint8, device=A.device)
    x = torch.empty((B, n), dtype=torch.float64, device=A.device)
    ws = None
    if layout == "global":
        ws = torch.empty((B, lib.certify_f64_workspace_doubles(m, n)), dtype=torch.float64,
                         device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.certify_f64_launch(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            basis.data_ptr(), vstat.data_ptr(), status.data_ptr(), obj.data_ptr(),
            verified.data_ptr(), x.data_ptr(), ws.data_ptr() if ws is not None else None,
            B, m, n, LAYOUTS.index(layout), stream,
        )
    if err != 0:
        msg = lib.certify_f64_error_string(err).decode()
        raise RuntimeError(f"certify_f64 kernel launch failed: {msg} ({err})")
    global launches
    launches += 1
    return obj, verified.view(torch.bool), x


def certify_plain(A, b, c, lo, hi, basis, vstat, status):
    """Plain torch version of the kernel (any device), same inputs and
    outputs as `certify_kernel_call`: `_verify_f64`'s arithmetic with one LU
    per lane (`torch.linalg.lu_factor_ex`), whose `info` marks each singular
    lane on its own."""
    B, m, n = A.shape
    idx = basis.long()
    valid = (idx >= 0) & (idx < n)
    # an index outside [0, n) reads column n: zeros in A and c, and x's
    # scatter drops it
    col = torch.where(valid, idx, n)
    pad = lambda t: torch.cat([t, torch.zeros_like(t[..., :1])], dim=-1)
    Bmat = torch.gather(pad(A), 2, col[:, None, :].expand(B, m, m))
    srt = torch.sort(idx, dim=1).values
    repeated = (srt[:, 1:] == srt[:, :-1]).any(dim=1)

    at_lo, at_hi = vstat == int(VarStat.AT_LOWER), vstat == int(VarStat.AT_UPPER)
    free = vstat == int(VarStat.FREE)
    xN = torch.where(at_lo | (vstat == int(VarStat.FIXED)), lo,
                     torch.where(at_hi, hi, torch.zeros_like(lo)))
    rhs = b - (A * xN[:, None, :]).sum(dim=2)  # every product, as numpy's (0·inf is NaN)
    cB = torch.gather(pad(c), 1, col)
    LU, piv, info = torch.linalg.lu_factor_ex(Bmat)
    singular = (info != 0) | repeated
    xB = torch.linalg.lu_solve(LU, piv, rhs[..., None])[..., 0]
    yT = torch.linalg.lu_solve(LU, piv, cB[..., None], adjoint=True)[..., 0]
    xB = torch.where(singular[:, None], 0.0, xB)
    yT = torch.where(singular[:, None], 0.0, yT)
    d = c - (yT[:, :, None] * A).sum(dim=1)
    loB, hiB = torch.gather(pad(lo), 1, col), torch.gather(pad(hi), 1, col)
    pfeas = ((xB >= loB - TOL) & (xB <= hiB + TOL)).all(dim=1)
    dfeas = ((~at_lo | (d >= -TOL)) & (~at_hi | (d <= TOL))
             & (~free | (d.abs() <= TOL))).all(dim=1)
    obj = (cB * xB).sum(dim=1) + (c * xN).sum(dim=1)
    ok = pfeas & dfeas & (status == int(Status.OPTIMAL)) & ~singular
    x = pad(xN).scatter(1, col, xB)[:, :n]
    return obj, ok, x.contiguous()


def certify_out(out, A, b, c, lo, hi) -> torch.Tensor:
    """The certificate of K1's or K3's output rows `out` (B rows of m + n + 2
    int32 ``[basis | vstat | status | niter]`` in the batch's order, any
    leading shape) against the f64 batch A (B, m, n), b (B, m), c/lo/hi
    (B, n) on the same device, in one (B, n + 2 + m + n + 2) f64 tensor
    ``[x | obj | verified | rows]`` for one copy to the host
    (`host_fields`); the int32 rows are exact in f64."""
    B, m, n = A.shape
    rows = out.reshape(B, m + n + 2)
    obj, verified, x = certify_kernel_call(
        A, b, c, lo, hi, rows[:, :m].contiguous(), rows[:, m:m + n].contiguous(),
        rows[:, m + n].contiguous())
    return torch.cat([x, obj[:, None], verified[:, None].to(x.dtype), rows.to(x.dtype)], dim=1)


def host_fields(packed, m: int, n: int) -> tuple:
    """`certify_out`'s tensor, copied to the host (numpy, (B, ...)), as the
    fields of a `BatchResult`: (basis, vstat, status, niter, obj, verified,
    x)."""
    buf = np.asarray(packed)
    rows = buf[:, n + 2:].astype(np.int32)
    return (rows[:, :m], rows[:, m:m + n], rows[:, m + n], rows[:, m + n + 1],
            buf[:, n].copy(), buf[:, n + 1] != 0, buf[:, :n].copy())
