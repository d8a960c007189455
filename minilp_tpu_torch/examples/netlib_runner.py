"""Netlib-style suite runner, PyTorch port of `examples/netlib_runner.py`:
solve MPS files and report the BASELINE protocol metrics (wall-clock to
1e-6 gap, iterations/s per device).

Usage:
    python -m minilp_tpu_torch.examples.netlib_runner FILE.mps[.gz] [...]
    python -m minilp_tpu_torch.examples.netlib_runner --engine pdhg FILE.mps ...
    python -m minilp_tpu_torch.examples.netlib_runner --expected afiro=-464.75314286 afiro.mps
    python -m minilp_tpu_torch.examples.netlib_runner --device cpu FILE.mps

When the Netlib archive is available (it is not vendored here — this machine
has no network; see BASELINE.md §1), point this at the `.mps.gz` files to run
the exact correctness gate from BASELINE.md: each objective must be within
1e-6 relative of the canonical optimum.  The record's key is the file's
MPS NAME (or its file name), looked up in `--expected` and then in
`KNOWN_OPTIMA`: a synthetic file of a Netlib shape must carry another name
(say `shape_25fv47`), or the real instance's optimum is held against it.
The solves run on `--device` ("cuda" by default).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from minilp_tpu_torch import Infeasible, SolverFailure, Unbounded
from minilp_tpu_torch.io.mps import read_mps
from minilp_tpu_torch.options import SolverOptions

#: canonical optima from BASELINE.md §1 (Netlib lp/data readme)
KNOWN_OPTIMA = {
    "afiro": -4.6475314286e02,
    "adlittle": 2.2549496316e05,
    "sc50a": -6.4575077059e01,
    "sc50b": -7.0000000000e01,
    "blend": -3.0812149846e01,
    "share2b": -4.1573224074e02,
    "25fv47": 5.5018458883e03,
    "fit1p": 9.1463780924e03,
    "maros-r7": 1.4971851665e06,
    "80bau3b": 9.8722419241e05,
    "pds-02": 2.8857862010e10,
}


def run_one(path: str, opts: SolverOptions, expected: dict) -> dict:
    t0 = time.perf_counter()
    mp = read_mps(path, options=opts)
    t_parse = time.perf_counter() - t0
    prob = mp.problem
    rec = {
        "file": path,
        "name": mp.name,
        "rows": prob.num_constraints,
        "cols": prob.num_vars,
        "parse_s": round(t_parse, 3),
        "engine": opts.engine,
    }
    t0 = time.perf_counter()
    try:
        sol = prob.solve()
        rec["status"] = "optimal"
        rec["objective"] = mp.objective_value(sol)
        rec["iterations"] = sol._engine.iterations()
        rec["certified"] = getattr(sol._engine, "certified", None)
    except Infeasible:
        rec["status"] = "infeasible"
    except Unbounded:
        rec["status"] = "unbounded"
    except SolverFailure as e:
        rec["status"] = f"failed: {e}"
    rec["solve_s"] = round(time.perf_counter() - t0, 3)
    if rec.get("iterations"):
        rec["iters_per_sec"] = round(rec["iterations"] / rec["solve_s"], 1)

    key = mp.name.lower() or path.rsplit("/", 1)[-1].split(".")[0].lower()
    target = expected.get(key, KNOWN_OPTIMA.get(key))
    if target is not None and rec.get("objective") is not None:
        gap = abs(rec["objective"] - target) / (1.0 + abs(target))
        rec["canonical_optimum"] = target
        rec["rel_gap"] = float(f"{gap:.3g}")
        rec["pass_1e-6"] = bool(gap <= 1e-6)
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("files", nargs="+", help="MPS files (.mps or .mps.gz)")
    ap.add_argument("--engine", default="simplex", choices=["simplex", "pdhg"])
    ap.add_argument("--dtype", default="float64", choices=["float64", "float32"])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument(
        "--expected", action="append", default=[],
        metavar="NAME=OBJ", help="expected optimum override (repeatable)",
    )
    args = ap.parse_args(argv)
    expected = {}
    for spec in args.expected:
        name, val = spec.split("=", 1)
        expected[name.lower()] = float(val)
    opts = SolverOptions(engine=args.engine, dtype=args.dtype, device=args.device)

    ok = True
    for path in args.files:
        rec = run_one(path, opts, expected)
        print(json.dumps(rec))
        if rec.get("pass_1e-6") is False or str(rec.get("status", "")).startswith("failed"):
            ok = False
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
