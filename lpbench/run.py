"""One run of one cell:

    python3 -m lpbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up loads the cell's kernels (built into `build/minilp_tpu_torch/` of the
checkout at first use), makes the cell's inputs from the seed and warms up
once at the cell's shapes; then the traffic kind drives the program for
`--seconds`.  With `--trace 0` the result carries the cell's end-to-end
metrics, with `--trace 1` its per-layer metrics, read from the program's
stage timers and solve records and from `torch.profiler` over the whole
window.  Once the window has closed, the plain reference judges the answers
(`judge.py`).  The last line of the standard output is one JSON object;
the numbers compared, beside their limits, are the last lines of the
standard error and the result's last key.
"""

from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

from . import judge, spec
from .core import Records, Spans, Window
from .readers import Context

#: top-level modules that no run may load (the JAX package and JAX itself),
#: compared whole: the port's own name only begins like the JAX package's
FORBIDDEN = ("jax", "jaxlib", "flax", "minilp_tpu")


def forbidden_modules() -> list[str]:
    return sorted({name.split(".")[0] for name in sys.modules} & set(FORBIDDEN))


class Stages:
    """The program's stage timers and counters (`utils/profiling.py`)."""

    def __init__(self):
        from minilp_tpu_torch.utils import profiling

        self._p = profiling

    def reset(self):
        self._p.reset_stages()

    def snapshot(self):
        return self._p.stages(None)


def _device_name_power() -> str | None:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout else None


def run_cell(name: str, seed: int, seconds: float, trace: bool, *, device: str = "cuda",
             t0: float | None = None, system=None, stages=None,
             sizes: dict | None = None) -> dict:
    """One run of the cell; returns the result.  `device="cpu"` is the test
    hook: the program's plain versions, no profiler and no device metric;
    `system` and `stages` replace the program (the control), and `sizes`
    updates the configuration's shape and the traffic's parameters."""
    import torch

    t0 = time.perf_counter() if t0 is None else t0
    cell = spec.cell(name)
    config, params = dict(cell.config), dict(cell.traffic["params"])
    if sizes:
        config["shape"] = dict(config["shape"], **sizes.get("shape", {}))
        params.update(sizes.get("params", {}))
    kind = cell.kind
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(0)
        sync = torch.cuda.synchronize
        if system is None:
            from minilp_tpu_torch.ops.kernels import build

            with ThreadPoolExecutor(len(config["kernels"])) as pool:
                list(pool.map(build.load, config["kernels"]))
    else:
        sync = lambda: None
    system = system or kind.Program(device, sync, config, params)
    stages = stages or Stages()
    state = kind.prepare(config, params, seed)
    kind.warmup(config, params, seed, system, Spans(False), state)
    sync()
    setup_s = time.perf_counter() - t0

    window = Window(seconds)
    records = Records(trace)
    spans = Spans(trace and on_card)
    summary = None
    try:
        if trace and on_card:
            from . import trace as tracing

            with tracing.profiled() as holder:
                with spans(tracing.WINDOW_SPAN):
                    run = kind.run(config, params, seed, system, window, stages, records,
                                   spans, state)
        else:
            run = kind.run(config, params, seed, system, window, stages, records, spans, state)
    finally:
        records.close()
    device_info = {"platform": "gpu" if on_card else "cpu", "count": 1}
    if on_card:
        device_info.update(kind=torch.cuda.get_device_name(0),
                           memory_peak_bytes=int(torch.cuda.max_memory_allocated()))
    if trace and on_card:
        summary = tracing.reduce(holder.prof)
        del holder
        device_info.update(busy_s=summary.busy_s, window_s=summary.window_s)
    del system, state
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    t_judge = time.perf_counter()
    values = judge.numbers(run)
    t_judge = time.perf_counter() - t_judge
    correct, checks = judge.decide(values, cell.traffic["limits"])
    from .bounds import PEAKS

    ctx = Context(requests=window.requests, window_s=window.wall_s, info=run.info,
                  trace=summary, peaks=PEAKS.get(device_info.get("kind")))
    metrics = {}
    for m in (cell.per_layer() if trace else cell.end_to_end()):
        if m["name"] == "setup_s":
            value = setup_s
        else:
            value = spec.reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = sum(r.n_lps for r in window.requests)
    result = {
        "correct": correct,
        "attempted": attempted,
        "failed": attempted - sum(r.n_certified for r in window.requests),
        "metrics": metrics,
        "device": device_info,
    }
    if on_card:
        result["device"]["card"] = _device_name_power()
    if summary is not None:
        result["breakdown"] = {"device_ops": summary.device_ops, "idle_gaps": summary.idle_gaps}
    result["judged"] = {"answers": len(run.answers), "lps": len({id(lp) for lp in run.lps}),
                        "seconds": t_judge}
    result["checks"] = checks
    return result


def main(argv=None, t0: float | None = None) -> int:
    t0 = time.perf_counter() if t0 is None else t0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    import torch

    chips = spec.cell(args.workload).entry["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"lpbench: the cell needs {chips} CUDA device(s); "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} available",
              file=sys.stderr)
        return 2
    result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace), t0=t0)
    bad = forbidden_modules()
    if bad:
        print(f"lpbench: modules loaded that no run may load: {bad}", file=sys.stderr)
        return 3
    for key, c in result["checks"].items():
        print(f"check {key} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
