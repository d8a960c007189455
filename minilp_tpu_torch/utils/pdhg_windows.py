"""Where two runs of the f64 PDHG engine part: the first window whose
restart decision or status differs, and the quantities that decided it.

    python3 -m minilp_tpu_torch.utils.pdhg_windows [--matrix dense] [--devices cuda,cpu]
                                                   [--out DIR] [--with TRACE.npz ...]

On `chip_smoke.py` phase 7(b)'s instance (`synth.netlib_shaped_problem(250,
760, 0.05, seed=11)`, the `single_lp` 256x1024 line, `engine="pdhg"`,
`feas_tol` 1e-6, the vanilla variant), `Problem.solve()` runs once on each
device of `--devices` and records the state at the end of every window of
`pdhg_check_every` iterations: niter, the window counter `inner` (0 after a
restart), `last_err`, the KKT error `err` (the vanilla restart metric),
omega and status.  The recording stacks the scalars on the run's device
and reads them once, after the solve, so the run's arithmetic is the
engine's own.  Each trace is saved as `DIR/pdhg_windows_<device>_<matrix>.npz`;
`--with` adds traces saved elsewhere (another machine's CPU).

The vanilla rule restarts at the end of window k when err_k ≤ tol, or
err_k ≤ β·last_err_{k-1}, or the window has reached 36% of all iterations
(the artificial restart).  The script first checks that each trace obeys
that rule, then, for the first trace against each other one, prints the
first window whose restart or status differs, with both runs' err_k and
β·last_err_{k-1} (the two sides of the decision), the first window where
err differs at all, and how far err had drifted apart before the parting.
Prints one JSON line per pair, and the card's name and power limit as
`nvidia-smi` gives them when a card ran.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import pathlib
import subprocess
import time

import numpy as np

INSTANCE = (250, 760, 0.05)  # chip_smoke.py's SINGLE_LP["256x1024"]
SEED = 11
OPTIONS = dict(engine="pdhg", feas_tol=1e-6, pdhg_max_iter=600_000)  # chip_smoke.PDHG_KW
FIELDS = ("niter", "inner", "last_err", "err", "omega", "status")


@contextlib.contextmanager
def recording_windows(torch):
    """Every PdhgState the loop builds, as a stacked f64 row of FIELDS kept
    on its device: the first row is the initial state, each later one the
    end of a window."""
    from ..engine import pdhg

    real = pdhg.PdhgState
    rows = []

    def record(**kw):
        rows.append(torch.stack([torch.as_tensor(kw[f]).to(torch.float64) for f in FIELDS]))
        return real(**kw)

    pdhg.PdhgState = record
    try:
        yield rows
    finally:
        pdhg.PdhgState = real


def run(torch, device: str, matrix: str) -> dict:
    """One `Problem.solve()` on `device`; its window trace and result."""
    from .. import SolverOptions
    from .synth import netlib_shaped_problem

    prob = netlib_shaped_problem(*INSTANCE, seed=SEED)
    prob.options = SolverOptions(device=device, pdhg_matrix=matrix, **OPTIONS)
    with recording_windows(torch) as rows:
        t0 = time.perf_counter()
        sol = prob.solve()
        trace = torch.stack(rows[1:]).cpu().numpy()
        wall = time.perf_counter() - t0
    return dict(device=device, matrix=matrix, trace=trace, objective=sol.objective(),
                iterations=sol._engine.iterations(), wall_s=wall)


def check_rule(trace: np.ndarray, opts) -> None:
    """Each recorded restart (inner == 0) is the rule's decision on the
    recorded values."""
    niter, inner, last_err, err = (trace[:, FIELDS.index(f)] for f in FIELDS[:4])
    prev_last = np.concatenate([[np.inf], last_err[:-1]])
    prev_inner = np.concatenate([[0.0], inner[:-1]])
    every = opts.pdhg_check_every
    rule = ((err <= opts.feas_tol) | (err <= opts.pdhg_restart_beta * prev_last)
            | (prev_inner + every >= 0.36 * niter))
    bad = np.nonzero(rule != (inner == 0))[0]
    if bad.size:
        raise AssertionError(f"window {int(bad[0])}: the recorded restart is not the rule's")


def parting(a: np.ndarray, b: np.ndarray, opts) -> dict:
    """The first window where the restart decision or the status of the two
    traces differs, and the two sides of each run's decision there."""
    col = lambda t, f: t[:, FIELDS.index(f)]
    n = min(len(a), len(b))
    restart_a, restart_b = col(a, "inner")[:n] == 0, col(b, "inner")[:n] == 0
    diff = np.nonzero((restart_a != restart_b) | (col(a, "status")[:n] != col(b, "status")[:n]))[0]
    err_a, err_b = col(a, "err")[:n], col(b, "err")[:n]
    first_err = np.nonzero(err_a != err_b)[0]
    out = dict(windows=[len(a), len(b)], iterations=[int(a[-1, 0]), int(b[-1, 0])],
               first_err_difference=int(first_err[0]) if first_err.size else None)
    if not diff.size:
        out["parting_window"] = None
        return out
    k = int(diff[0])
    beta = opts.pdhg_restart_beta
    side = lambda t, r: dict(
        restart=bool(r[k]), err=float(col(t, "err")[k]),
        beta_last_err=float(beta * col(t, "last_err")[k - 1]) if k else None,
        inner_before=float(col(t, "inner")[k - 1]) if k else 0.0,
        status=int(col(t, "status")[k]), omega=float(col(t, "omega")[k]))
    drift = np.abs(err_a[:k] - err_b[:k]) / np.abs(err_b[:k])
    out.update(parting_window=k, parting_niter=int(a[k, 0]), side_a=side(a, restart_a),
               side_b=side(b, restart_b),
               err_rel_drift_before=float(drift.max()) if k else 0.0,
               err_rel_drift_at=float(abs(err_a[k] - err_b[k]) / abs(err_b[k])))
    return out


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--matrix", default="dense", choices=("dense", "sparse"))
    ap.add_argument("--devices", default="cuda,cpu")
    ap.add_argument("--out", default="build/pdhg_windows")
    ap.add_argument("--with", dest="extra", nargs="*", default=[])
    args = ap.parse_args()

    import torch

    from .. import SolverOptions

    opts = SolverOptions(**OPTIONS)
    out = pathlib.Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    runs = []
    for device in args.devices.split(","):
        r = run(torch, device, args.matrix)
        np.savez(out / f"pdhg_windows_{device}_{args.matrix}.npz", trace=r["trace"])
        print(json.dumps({k: v for k, v in r.items() if k != "trace"}), flush=True)
        runs.append((f"{device} (this machine)", r["trace"]))
    for path in args.extra:
        runs.append((path, np.load(path)["trace"]))
    for _name, trace in runs:
        check_rule(trace, opts)
    for name, trace in runs[1:]:
        print(json.dumps(dict(a=runs[0][0], b=name, matrix=args.matrix,
                              **parting(runs[0][1], trace, opts))), flush=True)
    if any(d.startswith("cuda") for d in args.devices.split(",")):
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())


if __name__ == "__main__":
    main()
