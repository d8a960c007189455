"""K1's one-LP grid past its hand-off to K2, on one CUDA card.

    python3 -m minilp_tpu_torch.utils.k1_handoff [25fv47] [fit1p]

Run from the root of a checkout on a machine with a CUDA card and `nvcc`.
`Problem.solve()` sends a padded LP above (512, 2048) to K2 (the TPU
package's threshold).  For each Netlib shape of `k2_split` (presolved and
canonicalized: 824×2432 and 632×2432) this runs the same LP through K1's
one-LP launch (`simplex_kernel_call` on its default grid, the driver's
`max_iter`) and through K2's main-path launch (`prepare_launch` with the
driver's `streaming_options`), times each by CUDA events, and checks K1's
basis with the host's exact f64 certificate.  Prints one JSON line per
shape and the card's name and power limit as `nvidia-smi` gives them.
"""

from __future__ import annotations

import json
import subprocess
import sys

from .k1_split import KERNEL_KW, PERIOD
from .k2_split import SHAPES, _timed


def compare(tag: str) -> dict:
    import numpy as np
    import torch

    from ..canonical import canonicalize
    from ..engine.driver import streaming_options
    from ..ops.kernels import batched_simplex as bs
    from ..ops.kernels import streaming_simplex as ss
    from ..options import SolverOptions
    from ..presolve import presolve_problem
    from .synth import netlib_shaped_problem

    can = canonicalize(presolve_problem(netlib_shaped_problem(*SHAPES[tag], seed=1))[0])
    m, n = can.A.shape
    args = [torch.tensor(np.asarray(x, dtype=np.float32)[None], device="cuda")
            for x in (can.A, can.b, can.c, can.lo, can.hi)]
    kw = dict(slack0=can.nv, max_iter=SolverOptions().effective_max_iter(can.M, can.N),
              refactor_period=PERIOD, **KERNEL_KW)
    bs.simplex_kernel_call(*args, **dict(kw, max_iter=1))  # builds; not timed
    out, k1_ms = _timed(torch, lambda: bs.simplex_kernel_call(*args, **kw))
    row = out.cpu().numpy()
    obj, verified, _x = bs._verify_f64(
        can.A[None], can.b[None], can.c[None], can.lo[None], can.hi[None],
        row[:, :m], row[:, m:m + n], row[:, m + n])
    launch = ss.prepare_launch(can.A, can.b, can.c, can.lo, can.hi,
                               **streaming_options(can, SolverOptions()))
    ss.stream_kernel_call(*launch.args, launch.warm, **dict(launch.kw, max_iter=1))  # likewise
    k2, k2_ms = _timed(torch, lambda: ss.stream_kernel_call(*launch.args, launch.warm,
                                                             **launch.kw))
    return dict(shape=tag, m=m, n=n, k1_blocks=bs.default_blocks(args[0].device, m, n),
                k1_ms=k1_ms, k1_status=int(row[0, -2]), k1_pivots=int(row[0, -1]),
                k1_verified=bool(verified[0]), k1_obj=float(obj[0]), k2_ms=k2_ms,
                k2_status=int(k2.monitor[0]), k2_pivots=int(k2.monitor[1]))


def main(argv: list[str]) -> int:
    import torch

    if not torch.cuda.is_available():
        print("k1_handoff: no CUDA device is available", file=sys.stderr)
        return 3
    torch.backends.cuda.matmul.allow_tf32 = False
    for tag in argv or list(SHAPES):
        print(json.dumps(compare(tag)), flush=True)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
