"""K3, the packed simplex kernel: k LPs in lockstep per thread block.

PyTorch port of `minilp_tpu/ops/kernels/packed_simplex.py`.  Each LP runs
K1's bounded two-phase primal simplex (Dantzig phase 1, Devex phase 2, Bland
after a stall, a dense f32 B⁻¹ with product-form updates and a Newton
refresh), cold from the slack basis; a pack of k LPs shares ONE refresh
decision per iteration, which is what sets K3 apart from K1 in batch mode:
the pack refreshes when any running member makes its phase-1 → 2
transition or needs a forced exit check, or when the pack's largest pivot
count (finished members included) is a positive multiple of
`refactor_period`.  A refresh also makes every member's state fresh, which
decides when its terminal claim is believed, so an LP's pivots depend on its
pack-mates.

The TPU kernel held the k inverses in one block-diagonal (km, km) matrix and
gathered by one-hot matmuls (Mosaic has no dynamic indexing).  The port keeps
k separate m×m inverses and integer bases; the off-diagonal blocks were
exact zeros, so nothing changes except that an inf or NaN in one LP's block
no longer spreads to its pack-mates through 0·inf.

Three layers, as for K1:

* `packed_kernel_call` — the kernel wrapper.  On a CUDA tensor it launches
  the hand-written CUDA kernel (`minilp_tpu_torch/csrc/packed_simplex.cu`,
  replacing the Pallas TPU kernel `_packed_kernel`; one warp per LP, one
  thread block per pack) and counts the launch in `launches`; on a CPU
  tensor it runs `packed_plain`.  Nothing else selects between the two, and
  nothing falls back: a failed build or launch raises.  The kernel's memory
  layout (`LAYOUTS`: each LP's A and workspace in shared memory, the
  workspace alone there, or the workspace in global memory) is sized to the
  pack per launch, the first that fits by default; every layout gives the
  same bits.
* `packed_plain` — the kernel's plain torch version (any device): K1's plain
  loop body (`batched_simplex.simplex_plain`) with the pack's refresh rule.
* `solve_batch_packed` — host numpy in, f64 to the device and cast to f32
  there, one kernel call, then the exact f64 certificate of every lane on
  the same device (`certify.py`, shared with K1's batch entry point) and
  one device-to-host copy.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from . import build, certify
from .batched_simplex import BatchResult, simplex_plain, upload

#: launches of the CUDA kernel in this process (plain-version calls do not
#: count); `chip_smoke.py` resets it before driving the batched path and
#: reads it after
launches = 0

#: one warp per LP in one thread block: at most 1024 threads
MAX_PACK = 32

#: the kernel's layouts, in the order the default tries them: "staged" (each
#: LP's A copied into shared memory beside its workspace), "shared" (the
#: workspace in shared memory, A read from global memory), "global" (the
#: workspace in global memory; always fits)
LAYOUTS = ("staged", "shared", "global")

_F = ctypes.c_float
_I = ctypes.c_int
_P = ctypes.c_void_p


def _library(defines: tuple = ()) -> ctypes.CDLL:
    lib = build.load("packed_simplex", defines).lib
    # every pointer and the stream as c_void_p: an undeclared argument
    # would pass as a 32-bit int and cut the pointer
    lib.packed_simplex_workspace_floats.argtypes = [_I, _I, _I, _I]
    lib.packed_simplex_workspace_floats.restype = ctypes.c_size_t
    lib.packed_simplex_layout_fits.argtypes = [_I, _I, _I, _I]
    lib.packed_simplex_layout_fits.restype = _I
    lib.packed_simplex_smem_bytes.argtypes = [_I, _I, _I, _I]
    lib.packed_simplex_smem_bytes.restype = ctypes.c_size_t
    lib.packed_simplex_launch.argtypes = [_P] * 7 + [_I] * 8 + [_F] * 3 + [_I, _P]
    lib.packed_simplex_launch.restype = _I
    lib.packed_simplex_error_string.argtypes = [_I]
    lib.packed_simplex_error_string.restype = ctypes.c_char_p
    return lib


def _check_layout(layout) -> None:
    if layout is not None and layout not in LAYOUTS:
        raise ValueError(f"layout must be None or one of {LAYOUTS}, got {layout!r}")


def pick_layout(pack: int, m: int, n: int, layout: Optional[str] = None) -> str:
    """The layout a launch of packs of `pack` LPs of m x n takes: `layout`
    where it fits (else ValueError), or the first of `LAYOUTS` that fits.
    Builds the kernel's library (the sizes are the kernel's own)."""
    _check_layout(layout)
    lib = _library()
    fits = [name for code, name in enumerate(LAYOUTS)
            if lib.packed_simplex_layout_fits(code, pack, m, n)]
    if layout is None:
        return fits[0]
    if layout not in fits:
        raise ValueError(f"layout {layout!r} does not fit a pack of {pack} LPs of "
                         f"{m}x{n} in one block's shared memory (fits: {fits})")
    return layout


def smem_bytes(pack: int, m: int, n: int, layout: str) -> int:
    """Dynamic shared memory of one block in `layout`, in bytes."""
    return int(_library().packed_simplex_smem_bytes(LAYOUTS.index(layout), pack, m, n))


def _check_inputs(A, b, c, lo, hi, pack):
    if A.dim() != 3:
        raise ValueError(f"A must be (P, pack*m, n), got shape {tuple(A.shape)}")
    if not 1 <= pack <= MAX_PACK:
        raise ValueError(f"pack must be in [1, {MAX_PACK}] (one warp per LP "
                         f"in one thread block), got {pack}")
    P, km, n = A.shape
    if km % pack != 0:
        raise ValueError(f"A has {km} rows, not a multiple of pack {pack}")
    m = km // pack
    want = {"A": (A, (P, km, n)), "b": (b, (P, pack, m)), "c": (c, (P, pack, n)),
            "lo": (lo, (P, pack, n)), "hi": (hi, (P, pack, n))}
    for name, (t, shape) in want.items():
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
        if t.device != A.device:
            raise ValueError(f"{name} is on {t.device}, A on {A.device}")
        if tuple(t.shape) != shape or t.dtype != torch.float32:
            raise ValueError(f"{name} must be {shape} torch.float32, got "
                             f"{tuple(t.shape)} {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if m > n:
        raise ValueError(f"need m <= n, got m={m}, n={n}")


def packed_kernel_call(
    A, b, c, lo, hi, *,
    pack: int, slack0: int, max_iter: int, refactor_period: int,
    feas_tol: float, opt_tol: float, pivot_tol: float, bland_after: int,
    layout: Optional[str] = None,
) -> torch.Tensor:
    """Run K3 on P packs of `pack` LPs; returns (P, pack, m + n + 2) int32
    rows ``[basis | vstat | status | niter]`` on the inputs' device.

    Inputs, as the TPU kernel takes them: A (P, pack·m, n) — the pack's LPs
    stacked by rows —, b (P, pack, m), c/lo/hi (P, pack, n), all f32 and
    contiguous on one device.  CUDA tensors launch the kernel on the current
    stream (no synchronisation) in `layout` (`pick_layout`: None takes the
    first of `LAYOUTS` that fits; a forced one that does not fit raises
    ValueError); CPU tensors run `packed_plain`.
    """
    _check_inputs(A, b, c, lo, hi, pack)
    _check_layout(layout)
    kw = dict(pack=pack, slack0=slack0, max_iter=max_iter,
              refactor_period=refactor_period, feas_tol=feas_tol,
              opt_tol=opt_tol, pivot_tol=pivot_tol, bland_after=bland_after)
    if A.device.type == "cpu":
        return packed_plain(A, b, c, lo, hi, **kw)
    if A.device.type != "cuda":
        raise ValueError(f"K3 runs on CUDA (kernel) or CPU (plain), not {A.device}")
    m = A.shape[1] // pack
    return _launch(_library(), A, b, c, lo, hi, layout=pick_layout(pack, m, A.shape[2], layout),
                   **kw)


def _launch(lib, A, b, c, lo, hi, *, pack, layout, slack0, max_iter, refactor_period,
            feas_tol, opt_tol, pivot_tol, bland_after) -> torch.Tensor:
    """One launch of `lib`'s kernel (the wrapper's, or a diagnostic build's)
    on checked CUDA inputs in a layout that fits; counted in `launches`."""
    P, km, n = A.shape
    m = km // pack
    code = LAYOUTS.index(layout)
    out = torch.empty((P, pack, m + n + 2), dtype=torch.int32, device=A.device)
    ws_lps = P * pack if layout == "global" else 0
    ws = torch.empty((ws_lps, lib.packed_simplex_workspace_floats(code, pack, m, n)),
                     dtype=torch.float32, device=A.device)
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        err = lib.packed_simplex_launch(
            A.data_ptr(), b.data_ptr(), c.data_ptr(), lo.data_ptr(), hi.data_ptr(),
            out.data_ptr(), ws.data_ptr() if ws_lps else None,
            P, pack, m, n, code, slack0, max_iter, refactor_period,
            feas_tol, opt_tol, pivot_tol, bland_after, stream,
        )
    if err != 0:
        msg = lib.packed_simplex_error_string(err).decode()
        raise RuntimeError(f"packed_simplex kernel launch failed: {msg} ({err})")
    global launches
    launches += 1
    return out


def packed_plain(
    A, b, c, lo, hi, *,
    pack: int, slack0: int, max_iter: int, refactor_period: int,
    feas_tol: float, opt_tol: float, pivot_tol: float, bland_after: int,
) -> torch.Tensor:
    """Plain torch version of the kernel (any device), same inputs and
    output packing as `packed_kernel_call`: every pack in lockstep, each
    with the pack-wide refresh rule (module docstring)."""
    P, km, n = A.shape
    m = km // pack
    B = P * pack
    out = simplex_plain(
        A.reshape(B, m, n), b.reshape(B, m), c.reshape(B, n), lo.reshape(B, n),
        hi.reshape(B, n), slack0=slack0, max_iter=max_iter,
        refactor_period=refactor_period, feas_tol=feas_tol, opt_tol=opt_tol,
        pivot_tol=pivot_tol, bland_after=bland_after, pack=pack)
    return out.view(P, pack, m + n + 2)


def packed_args(A, b, c, lo, hi, *, pack: int) -> list:
    """The batch A (B, m, n), b (B, m), c/lo/hi (B, n), tensors on one
    device, as the kernel's f32 inputs, cast on that device (round to
    nearest even: the bits of numpy's `astype(np.float32)`)."""
    B, m, n = A.shape
    if B % pack != 0:
        raise ValueError(f"batch {B} not divisible by pack {pack}")
    P = B // pack
    f32 = lambda x, shape: x.to(torch.float32).reshape(shape).contiguous()
    return [f32(A, (P, pack * m, n)), f32(b, (P, pack, m)), f32(c, (P, pack, n)),
            f32(lo, (P, pack, n)), f32(hi, (P, pack, n))]


def upload_packed(A, b, c, lo, hi, *, pack: int, device) -> list:
    """Host (B, m, n)-batch arrays → the kernel's f32 inputs on `device`."""
    return packed_args(*upload(device, A, b, c, lo, hi), pack=pack)


def solve_batch_packed(
    A, b, c, lo, hi,
    *,
    device,
    pack: int = 8,
    slack0: Optional[int] = None,
    max_iter: int = 2000,
    refactor_period: int = 32,
    feas_tol: float = 1e-5,
    opt_tol: float = 1e-6,
    pivot_tol: float = 1e-6,
    bland_after: int = 200,
) -> BatchResult:
    """Solve B canonical LPs in packs of `pack` with one K3 call on `device`
    (module docstring); the contract of `solve_batch_megakernel`.

    Host arrays A (B, m, n), b (B, m), c/lo/hi (B, n), B a multiple of
    `pack` (callers pad or pick the pack), uploaded in f64: the kernel takes
    them cast to f32 on the device, the certificate (`certify.certify_out`,
    on the same device) in f64.  The identity slack block occupies columns
    [slack0, slack0+m) and forms the initial basis; `slack0=None` means the
    last m columns.  Returns exact f64 objectives and vertices recomputed
    from the discovered bases plus `verified` flags, after one
    device-to-host copy.
    """
    data = upload(device, A, b, c, lo, hi)
    B, m, n = data[0].shape
    out = packed_kernel_call(
        *packed_args(*data, pack=pack), pack=pack, slack0=n - m if slack0 is None else slack0,
        max_iter=max_iter, refactor_period=refactor_period, feas_tol=feas_tol,
        opt_tol=opt_tol, pivot_tol=pivot_tol, bland_after=bland_after,
    )
    return BatchResult(*certify.host_fields(certify.certify_out(out, *data).cpu().numpy(), m, n))
