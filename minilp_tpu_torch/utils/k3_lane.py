"""Where K3 and its plain version part on one LP: the first pivot and the
quantity that decided it.

    python3 -m minilp_tpu_torch.utils.k3_lane [--seed 1] [--lane 293] [--device cuda]

On `bench.py`'s batched shape (`synth.random_batch(seed, 1024, 32, 96)`,
pack 8, `slack0` 96, the tests' options), the pack that holds `lane` is
uploaded alone, as `chip_smoke.py` phase 3c uploads the batch, and run
through K3 (`packed_kernel_call`) and `packed_plain` with `max_iter = k`.
Packs never share state, so the pack alone runs as it does in the batch.
A bisection finds the smallest k at which the two give other out rows
(basis, vstat, status, pivots) on some lane of the pack.  For each lane
that differs at k it prints what each side did on its k-th pivot (the
entering variable, the leaving variable or a bound flip, read from the out
rows) and the quantity that decided it, from two readings of the state
both sides share before the pivot (their out rows agree at k - 1):
  * the kernel's own f32 values, from a build with `-DK3_PROBE` that
    records that lane's ratio test at that pivot: the entering column,
    x_B, w, each row's ratio and target, the step t_rows and the tie window
    t_rows·1.0001 + 1e-6 (the window's largest |w| leaves), the flip;
  * the same ratio test in exact f64 from the shared basis and statuses.
So: another entering variable, or the same one with another leaving row
(both rows' ratios and |w| beside the window, in f32 and in f64), or a flip
on one side only, or else the refresh rule or a terminal claim.  Prints
one JSON line and the card's name and power limit.  With `--device cpu` it
runs the plain version on both sides (a rehearsal: no split).
"""

from __future__ import annotations

import argparse
import json
import subprocess

BATCH, M, NV, PACK = 1024, 32, 96, 8  # bench.py's batched line
N = NV + M  # columns: the structural ones, then the slacks
KERNEL_KW = dict(refactor_period=32, feas_tol=1e-5, opt_tol=1e-6, pivot_tol=1e-6,
                 bland_after=200)
MAX_ITER = 2000
PROBE_HEAD, PROBE_ROWS = 12, 64  # the -DK3_PROBE record (packed_simplex.cu)


def _rows(ps, args, k, plain=False):
    kw = dict(pack=PACK, slack0=NV, max_iter=k, **KERNEL_KW)
    out = (ps.packed_plain if plain else ps.packed_kernel_call)(*args, **kw)
    return out.cpu().numpy().reshape(PACK, M + N + 2)


def _kernel_probe(ps, args, lane, k):
    """K3's own ratio test on `lane` of the pack at its k-th pivot, from the
    `-DK3_PROBE` build: (header dict, per-row array of x_B, w, ratio,
    target)."""
    import ctypes

    import numpy as np

    lib = ps._library(("K3_PROBE",))
    lib.packed_simplex_probe_at.argtypes = [ctypes.c_longlong, ctypes.c_longlong]
    lib.packed_simplex_probe_at.restype = ctypes.c_int
    lib.packed_simplex_probe_read.argtypes = [ctypes.c_void_p]
    lib.packed_simplex_probe_read.restype = ctypes.c_int
    rec = (ctypes.c_float * (PROBE_HEAD + 4 * PROBE_ROWS))()
    if lib.packed_simplex_probe_at(lane, k - 1) != 0:
        raise RuntimeError("selecting K3's probe failed")
    ps._launch(lib, *args, pack=PACK, layout=ps.pick_layout(PACK, M, N), slack0=NV,
               max_iter=k, **KERNEL_KW)
    if lib.packed_simplex_probe_read(ctypes.addressof(rec)) != 0:
        raise RuntimeError("reading K3's probe failed")
    vals = np.frombuffer(rec, dtype=np.float32).astype(np.float64)
    head = dict(zip(("written", "q", "r", "t_rows", "window", "flip", "s", "rng_q",
                     "phase", "refresh", "bland", "d_q"), vals[:PROBE_HEAD].tolist()))
    if head["written"] != 1.0:
        raise RuntimeError(f"K3's probe recorded nothing at lane {lane}, pivot {k}")
    return head, vals[PROBE_HEAD:].reshape(PROBE_ROWS, 4)[:M]


def _step(before, after):
    """What one side did between two out rows of a lane: (entering,
    leaving, flipped)."""
    b0, b1 = set(before[:M].tolist()), set(after[:M].tolist())
    entering = sorted(b1 - b0)
    leaving = sorted(b0 - b1)
    v0, v1 = before[M:M + N], after[M:M + N]
    flipped = [int(j) for j in (v0 != v1).nonzero()[0] if j not in b0 | b1]
    return dict(entering=entering, leaving=leaving, flipped=flipped,
                status=int(after[M + N]), pivots=int(after[-1]))


def f64_ratio_test(lp, basis, vstat, q, feas_tol=1e-5, pivot_tol=1e-6):
    """The ratio test of entering column q of the LP `lp` = (A, b, c, lo,
    hi) in exact f64 from a basis and statuses (K1's and K3's rule): (x_B,
    w, ratio per row, the row the rule takes: the largest |w| inside the
    tie window)."""
    import numpy as np

    from ..canonical import nonbasic_values

    A, b, c, lo, hi = (np.asarray(x, dtype=np.float64) for x in lp)
    xN = nonbasic_values(vstat, lo, hi)
    B = A[:, basis]
    xB = np.linalg.solve(B, b - A @ xN)
    w = np.linalg.solve(B, A[:, q])
    d_q = c[q] - np.linalg.solve(B.T, c[basis]) @ A[:, q]
    delta = -(1.0 if d_q < 0 else -1.0) * w
    loB, hiB = lo[basis], hi[basis]
    below, above = xB < loB - feas_tol, xB > hiB + feas_tol
    up, dn = delta > pivot_tol, delta < -pivot_tol
    tgt = np.where(up, np.where(below, loB, hiB), np.where(dn, np.where(above, hiB, loB), 0.0))
    blockable = ((up & ~above) | (dn & ~below)) & np.isfinite(tgt)
    with np.errstate(divide="ignore", invalid="ignore"):
        ratio = np.where(blockable, (tgt - xB) / np.where(up | dn, delta, 1.0), np.inf)
    ratio = np.maximum(ratio, 0.0)
    tie = ratio <= ratio.min() * 1.0001 + 1e-6
    return xB, w, ratio, int(np.argmax(np.where(tie, np.abs(w), -np.inf)))


def split(seed: int = 1, lane: int = 293, device: str = "cuda") -> dict:
    import numpy as np

    from ..ops.kernels import packed_simplex as ps
    from .synth import random_batch

    A, b, c, lo, hi = random_batch(seed, BATCH, M, NV)
    first = lane // PACK * PACK
    pack = slice(first, first + PACK)
    args = ps.upload_packed(A[pack], b[pack], c[pack], lo[pack], hi[pack],
                            pack=PACK, device=device)
    differs = lambda k: not np.array_equal(_rows(ps, args, k), _rows(ps, args, k, plain=True))
    full = (_rows(ps, args, MAX_ITER), _rows(ps, args, MAX_ITER, plain=True))
    result = dict(seed=seed, lane=lane, pack_lanes=[first, first + PACK - 1],
                  pivots_kernel=full[0][:, -1].tolist(), pivots_plain=full[1][:, -1].tolist())
    if not differs(MAX_ITER):
        result["split"] = None
        return result
    lo_k, hi_k = 0, MAX_ITER  # rows agree at lo_k, differ at hi_k
    while hi_k - lo_k > 1:
        mid = (lo_k + hi_k) // 2
        lo_k, hi_k = (lo_k, mid) if differs(mid) else (mid, hi_k)
    k = hi_k
    prev = _rows(ps, args, k - 1)  # both sides' rows agree here
    kern, plain = _rows(ps, args, k), _rows(ps, args, k, plain=True)
    lanes = []
    for i in np.flatnonzero((kern != plain).any(1)):
        ks, pl = _step(prev[i], kern[i]), _step(prev[i], plain[i])
        head, rows = _kernel_probe(ps, args, int(i), k)
        q, r_k = int(head["q"]), int(head["r"])
        entry = dict(lane=first + int(i), pivot=k, kernel=ks, plain=pl,
                     kernel_probe={key: head[key] for key in
                                   ("q", "r", "t_rows", "window", "flip", "rng_q",
                                    "phase", "refresh", "bland", "d_q")})
        lp = tuple(x[first + int(i)] for x in (A, b, c, lo, hi))
        basis = prev[i][:M]
        if pl["entering"] and pl["entering"] != [q]:
            entry["quantity"] = "entering pick (pricing)"
            entry["values"] = {"kernel q": q, "plain q": pl["entering"][0]}
        elif pl["leaving"] and ks["leaving"] != pl["leaving"]:
            r_p = int(np.flatnonzero(basis == pl["leaving"][0])[0])
            xB64, w64, ratio64, r64 = f64_ratio_test(lp, basis, prev[i][M:M + N], q)
            entry["quantity"] = "leaving row (ratio test: tie window, then largest |w|)"
            entry["values"] = {"kernel row": r_k, "plain row": r_p, "f64 row": r64,
                               "f64 t_rows": float(ratio64.min())}
            for tag, r in (("plain's row", r_p), ("kernel's row", r_k)):
                entry["values"][f"row {r} ({tag})"] = {
                    "kernel f32": dict(x_B=rows[r, 0], w=rows[r, 1], ratio=rows[r, 2],
                                       target=rows[r, 3]),
                    "f64": dict(x_B=float(xB64[r]), w=float(w64[r]),
                                ratio=float(ratio64[r]))}
        elif bool(ks["flipped"]) != bool(pl["flipped"]):
            entry["quantity"] = "bound flip (entering range against the step)"
            entry["values"] = {"kernel rng_q": head["rng_q"], "kernel t_rows": head["t_rows"],
                               "f64 t_rows": float(f64_ratio_test(
                                   lp, basis, prev[i][M:M + N], q)[2].min())}
        else:
            entry["quantity"] = "refresh rule or terminal claim (same pivot, other state)"
            entry["values"] = {"kernel refresh": head["refresh"]}
        lanes.append(entry)
    result["split"] = dict(pivot=k, lanes=lanes)
    return result


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--lane", type=int, default=293)
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args()
    if a.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("k3_lane: no CUDA device")
        torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps(split(a.seed, a.lane, a.device)))
    if a.device == "cuda":
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True, timeout=60).stdout.strip())


if __name__ == "__main__":
    main()
