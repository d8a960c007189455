"""The control of `correct`: the plain reference put in the program's place,
computed in float32, the precision below the f64 that every configuration
states.  Its answers go through the same loop and the same comparison as
the program's, and have to come out not correct.

    python3 -m lpbench.control --workload <cell> --seeds 1,2,3 --seconds 5 [--device cuda]

prints, per seed, one JSON line with `correct` and the numbers compared
beside their limits.  The benchmark's own runs never run it.  The
branch-and-cut control has no Gomory node: only the program's basis
defines the cut.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from .core import Answer
from .reference import ipm
from .reference.lp import LE
from .traffic.scenario import lane_lp

LOW = torch.float32


class NoStages:
    def reset(self):
        pass

    def snapshot(self):
        return {}


class Cold:
    def __init__(self, device: str, dtype=LOW):
        self.device, self.dtype = device, dtype

    def build(self, inst):
        return inst.row_lp()

    def solve(self, lp):
        ref = ipm.solve([lp], dtype=self.dtype, device=self.device)[0]
        return ref.status if ref.status != ipm.OPTIMAL else (lp, ref)

    @staticmethod
    def answer(sol, n):
        if isinstance(sol, str):
            return Answer(sol)
        return Answer("optimal", sol[1].obj, sol[1].x)


class Bnc(Cold):
    def __init__(self, device: str, dtype=LOW):
        super().__init__(device, dtype)
        self.bounds = {}

    def add_cut(self, sol, js, coeffs, rhs):
        row = np.zeros(sol[0].A.shape[1])
        row[js] = coeffs
        return self.solve(sol[0].with_row(row, LE, rhs))

    def fix(self, sol, j, val):
        lp = sol[0]
        self.bounds[j] = (lp.lo[j], lp.hi[j])
        return self.solve(lp.with_bounds(j, val, val))

    def unfix(self, sol, j):
        return self.solve(sol[0].with_bounds(j, *self.bounds.pop(j)))


class Scenario:
    def __init__(self, device: str, dtype=LOW):
        self.device, self.dtype = device, dtype

    def solve_batches(self, batches):
        out = []
        for batch in batches:
            refs = ipm.solve([lane_lp(batch, i) for i in range(batch[0].shape[0])],
                             dtype=self.dtype, device=self.device)
            status = np.array([1 if r.status == ipm.OPTIMAL else 2 for r in refs])
            n = batch[0].shape[2]
            x = np.stack([r.x if r.x is not None else np.zeros(n) for r in refs])
            obj = np.array([r.obj if r.obj is not None else np.nan for r in refs])
            out.append((status, np.ones(len(refs), bool), obj, x,
                        np.zeros(len(refs), np.int32)))
        return out


SYSTEMS = {"cold": Cold, "bnc": Bnc, "scenario": Scenario}


def run(name: str, seed: int, seconds: float, device: str, sizes=None, dtype=LOW) -> dict:
    from . import run as bench, spec

    system = SYSTEMS[spec.cell(name).traffic["kind"]](device, dtype)
    return bench.run_cell(name, seed, seconds, False, device=device, system=system,
                          stages=NoStages(), sizes=sizes)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    for seed in (int(s) for s in args.seeds.split(",")):
        r = run(args.workload, seed, args.seconds, args.device)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"], "checks": r["checks"]}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
