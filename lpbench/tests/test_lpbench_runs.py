"""Each cell's loop at a tiny size on the CPU (the port's plain versions),
through the test hook `run.run_cell(..., device="cpu")`, which reports no
device metric; then the same runs with the timed path broken underneath,
which the comparison has to call not correct, and the float32 control."""

import json
import subprocess
import sys

import numpy as np
import pytest

from lpbench import control, run, spec

SMALL_LP = {"shape": {"rows": 40, "cols": 100, "density": 0.05}}
SMALL_BATCH = {"shape": {"rows": 8, "cols": 24},
               "params": {"batch": 16, "pool": 8, "judged_lanes": 4}}
SIZES = {"cold": SMALL_LP, "bnc": dict(SMALL_LP, params={"judged": 8}),
         "scenario": SMALL_BATCH}
#: every cell the harness can run: those BENCHMARK.json declares and those
#: kept in lpbench/workloads/ for diagnosis (PERF.md, Open questions)
ALL = sorted(p.stem for p in (spec.HERE / "workloads").glob("*.json"))
#: the cells whose program answers are sound at the tiny size
CELLS = [c for c in ALL if spec.cell(c).traffic["kind"] != "bnc"]
SEED = 2**31 + 17


def sizes(name):
    return SIZES[spec.cell(name).traffic["kind"]]


def tiny(name, trace=False, seconds=1.5, seed=SEED):
    return run.run_cell(name, seed, seconds, trace, device="cpu", sizes=sizes(name))


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("name", CELLS)
def test_loop_runs_on_the_cpu(name, trace):
    r = tiny(name, trace)
    assert r["attempted"] > 0 and r["failed"] == 0
    assert r["device"] == {"platform": "cpu", "count": 1}
    cell = spec.cell(name)
    want = cell.per_layer() if trace else cell.end_to_end()
    assert set(r["metrics"]) <= {m["name"] for m in want}
    if not trace:
        assert set(r["metrics"]) == {m["name"] for m in want}
    assert list(r)[-1] == "checks"
    assert set(r["checks"]) == set(cell.traffic["limits"])
    assert r["correct"], r["checks"]


def _stale(monkeypatch, target, attr):
    """Every call after the first returns the first call's answer."""
    orig = getattr(target, attr)
    first = []

    def stale(*a, **kw):
        out = orig(*a, **kw)
        if not first:
            first.append(out)
        return first[0]

    monkeypatch.setattr(target, attr, stale)


def _alter_x(monkeypatch):
    from minilp_tpu_torch.engine import driver

    orig = driver.EngineHandle.var_value
    monkeypatch.setattr(driver.EngineHandle, "var_value",
                        lambda self, idx: orig(self, idx) + (1e-4 if idx == 0 else 0.0))


def _batches(monkeypatch, change):
    from minilp_tpu_torch.parallel import batched

    orig = batched.solve_batches_pipelined
    monkeypatch.setattr(batched, "solve_batches_pipelined",
                        lambda bs, **kw: [change(r) for r in orig(bs, **kw)])


def _half(r):
    h = len(r.status) // 2
    cp = lambda v: np.concatenate([np.asarray(v)[:h], np.asarray(v)[:h]])
    return r._replace(status=cp(r.status), verified=cp(r.verified), obj=cp(r.obj), x=cp(r.x))


def _nudge(r):
    x = np.array(r.x)
    x[:, 0] += 1e-4
    return r._replace(x=x)


def _skip_resolve(monkeypatch):
    from minilp_tpu_torch.engine import incremental

    monkeypatch.setattr(incremental, "_run_dual_resolve", lambda handle: None)
    monkeypatch.setattr(incremental, "_run_primal_resolve", lambda handle: None)


FAULTS = {
    "cold": {
        "state unchanged": lambda mp: _stale(mp, __import__("minilp_tpu_torch").Problem, "solve"),
        "answer altered": _alter_x,
    },
    "bnc": {
        "state unchanged": _skip_resolve,
        "answer altered": _alter_x,
    },
    "scenario": {
        "state unchanged": lambda mp: _stale_batches(mp),
        "half of the batch left out": lambda mp: _batches(mp, _half),
        "answer altered": lambda mp: _batches(mp, _nudge),
    },
}


def _stale_batches(monkeypatch):
    from minilp_tpu_torch.parallel import batched

    _stale(monkeypatch, batched, "solve_batches_pipelined")


@pytest.mark.parametrize("name,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[spec.cell(c).traffic["kind"]]])
def test_a_broken_timed_path_is_not_correct(name, fault, monkeypatch):
    FAULTS[spec.cell(name).traffic["kind"]][fault](monkeypatch)
    r = tiny(name)
    assert not r["correct"], r["checks"]


@pytest.mark.parametrize("seed", [1, 2, 2**31 + 5])
@pytest.mark.parametrize("name", ALL)
def test_float32_control_is_not_correct(name, seed):
    r = control.run(name, seed, 1.0, "cpu", sizes=sizes(name))
    assert not r["correct"], r["checks"]


def test_the_harness_loads_no_jax_and_the_reference_none_of_the_program():
    code = (
        "import json, sys\n"
        "from lpbench import run\n"
        f"run.run_cell({CELLS[0]!r}, 3, 0.5, False, device='cpu', sizes={sizes(CELLS[0])!r})\n"
        "top = sorted({m.split('.')[0] for m in sys.modules})\n"
        "print(json.dumps(top))\n"
    )
    top = json.loads(subprocess.run([sys.executable, "-c", code], capture_output=True,
                                    text=True, check=True, cwd=spec.ROOT).stdout.splitlines()[-1])
    assert "minilp_tpu_torch" in top
    assert not set(top) & {"jax", "jaxlib", "flax", "minilp_tpu"}
    code = ("import sys\nimport lpbench.reference.ipm, lpbench.reference.lp\n"
            "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=spec.ROOT).stdout
    assert "minilp_tpu" not in out  # neither the port nor the JAX package


@pytest.mark.cuda
def test_a_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    out = subprocess.run([sys.executable, "-m", "lpbench", "--workload", CELLS[0], "--seed",
                          str(SEED), "--seconds", "3", "--trace", "0"], capture_output=True,
                         text=True, cwd=spec.ROOT, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    line = json.loads(out.stdout.splitlines()[-1])
    assert line["correct"] and line["device"]["platform"] == "gpu"


def test_bnc_kind_with_the_f64_reference_in_place_is_correct():
    """The branch-and-cut loop's mirror of each node's LP and its judge, with
    the program replaced by the reference itself in f64."""
    import torch

    r = control.run("25fv47-bnc", SEED, 1.5, "cpu", sizes=SIZES["bnc"], dtype=torch.float64)
    assert r["attempted"] > 0 and r["correct"], r["checks"]


@pytest.mark.parametrize("trace", [False, True])
def test_bnc_kind_drives_the_program(trace):
    """The cell is not in BENCHMARK.json: the program's incremental path gives
    answers that lose to HiGHS (PERF.md, Open questions), so this checks only
    that the loop runs and reports its metrics."""
    r = tiny("25fv47-bnc", trace)
    cell = spec.cell("25fv47-bnc")
    want = {m["name"] for m in (cell.per_layer() if trace else cell.end_to_end())}
    assert r["attempted"] > 0 and r["failed"] == 0
    assert set(r["metrics"]) <= want and r["metrics"]
    assert set(r["checks"]) == set(cell.traffic["limits"])
