"""The port's spans and counters (`minilp_tpu_torch/utils/profiling.py`) on
the CPU: request ids, the span tree, the root's self time, the rule for
tracing on and off, the profiler's ranges, the route counters, and the cold
cell's six per-layer metrics read from them."""

import dataclasses
import json
import pathlib
import sys
import time

import numpy as np
import pytest
import torch

from minilp_tpu_torch import ComparisonOp, SolverOptions, Variable
from minilp_tpu_torch.ops.kernels import streaming_simplex
from minilp_tpu_torch.parallel import batched
from minilp_tpu_torch.status import Status
from minilp_tpu_torch.utils import profiling
from minilp_tpu_torch.utils.synth import netlib_shaped_problem, random_batch

ROOT = pathlib.Path(__file__).resolve().parents[1]
CPU = SolverOptions(device="cpu")
K2 = dataclasses.replace(CPU, use_streaming="always", use_megakernel="never")
K1 = dataclasses.replace(CPU, use_megakernel="always")
ENGINE = dataclasses.replace(CPU, use_streaming="never", use_megakernel="never")
#: the spans that enclose device work on a card: never profiler ranges
DEVICE_SPANS = {"solve", "resolve", "batch_call", "route.streaming", "route.megakernel",
                "route.engine", "upload", "stream_prep", "stream_first_launch",
                "stream_chunks", "finish", "state_rebuild", "megakernel"}


@pytest.fixture
def traced():
    previous = profiling.enable()
    profiling.reset_stages()
    yield
    profiling.enable(previous)
    profiling.reset_stages()


@pytest.fixture
def untraced():
    previous = profiling.enable(False)
    profiling.reset_stages()
    yield
    profiling.enable(previous)
    profiling.reset_stages()


def _problem(opts, seed=3, m=40, nv=100):
    prob = netlib_shaped_problem(m, nv, 0.05, seed=seed)
    prob.options = opts
    return prob


def _by_id():
    return {r.id: r for r in profiling.spans()}


def _root_of(rec, by_id):
    while rec.parent is not None:
        rec = by_id[rec.parent]
    return rec


def test_a_solves_spans_share_its_request_and_nest_under_solve(traced):
    _problem(K2).solve()
    recs = profiling.spans()
    by_id = _by_id()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["solve"]
    root = roots[0]
    assert root.request is not None
    assert {r.request for r in recs} == {root.request}
    for r in recs:
        assert _root_of(r, by_id) == root
        parent = by_id.get(r.parent)
        if parent is not None:  # inside its parent, but a span begun in the request
            assert parent.start <= r.start and (r.end <= parent.end or parent == root)
    names = {r.name for r in recs}
    assert {"presolve", "canonicalize", "route.streaming", "stream_prep", "upload",
            "stream_first_launch", "finish", "state_rebuild",
            "certify"} <= names
    # `finish` runs from K2's last launch to the end of the request
    finish = next(r for r in recs if r.name == "finish")
    launch = next(r for r in recs if r.name == "stream_first_launch")
    assert finish.parent == root.id and finish.end == root.end
    assert finish.start >= launch.end
    st = profiling.stages(None)
    assert st["solve_s"] == pytest.approx(root.end - root.start, abs=1e-12)
    assert st["finish_s"] <= st["solve_s"]


def test_each_solve_edit_and_batch_call_gets_a_new_request(traced):
    prob = _problem(CPU)
    ids = []
    sol = prob.solve()
    ids.append(profiling.spans()[-1].request)
    sol = prob.solve()
    ids.append(profiling.spans()[-1].request)
    profiling.reset_stages()
    sol = sol.add_constraint([(Variable(0), 1.0)], ComparisonOp.Le, sol[Variable(0)] + 1.0)
    roots = [r for r in profiling.spans() if r.parent is None]
    assert [r.name for r in roots] == ["resolve"]
    ids.append(roots[0].request)
    profiling.reset_stages()
    sol = sol.fix_var(Variable(1), sol[Variable(1)])
    _changed, sol = sol.unfix_var(Variable(1))
    roots = [r for r in profiling.spans() if r.parent is None]
    assert [r.name for r in roots] == ["resolve", "resolve"]
    ids += [r.request for r in roots]
    profiling.reset_stages()
    batches = [random_batch(k, batch=16, m=8, nv=24) for k in range(2)]
    batched.solve_batches_pipelined(batches, device="cpu", pack=8, max_iter=500,
                                    structural_cols=24)
    recs = profiling.spans()
    roots = [r for r in recs if r.parent is None]
    assert [r.name for r in roots] == ["batch_call"]
    ids.append(roots[0].request)
    # the prefetch thread's spans join the call's request
    preps = [r for r in recs if r.name == "batch_prep"]
    assert len(preps) == 2
    assert all(r.parent == roots[0].id and r.request == roots[0].request for r in preps)
    assert {r.request for r in recs} == {roots[0].request}
    assert len(set(ids)) == len(ids) == 6


def test_a_roots_self_time_is_its_wall_less_its_childrens(traced):
    with profiling.request("solve"):
        with profiling.span("a"):
            time.sleep(0.01)
        time.sleep(0.005)
        with profiling.span("b"):
            with profiling.span("c"):  # a grandchild: inside b, not counted again
                time.sleep(0.005)
            profiling.begin("d")  # overlaps b, then runs to the end of the request
            time.sleep(0.005)
        time.sleep(0.005)
    by_name = {r.name: r for r in profiling.spans()}
    root = by_name["solve"]
    assert by_name["d"].parent == root.id and by_name["d"].end == root.end
    assert by_name["c"].parent == by_name["b"].id
    covered = (by_name["a"].end - by_name["a"].start) + (root.end - by_name["b"].start)
    st = profiling.stages(None)
    assert st["solve_self_s"] == pytest.approx(root.end - root.start - covered, abs=1e-12)
    assert 0.004 <= st["solve_self_s"] < 0.05
    # and on a real solve: the root's wall less the union of its children
    profiling.reset_stages()
    _problem(K2).solve()
    recs = profiling.spans()
    root = next(r for r in recs if r.parent is None)
    kids = sorted((r.start, r.end) for r in recs if r.parent == root.id)
    union, reach = 0.0, root.start
    for a, b in kids:
        a, b = max(a, reach), min(b, root.end)
        if b > a:
            union, reach = union + b - a, b
    assert profiling.stages(None)["solve_self_s"] == pytest.approx(
        root.end - root.start - union, abs=1e-12)


def test_untraced_spans_do_not_synchronise_and_keep_nothing(untraced, monkeypatch):
    calls = []
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **kw: calls.append(a))
    card = torch.device("cuda")
    with profiling.request("solve"):
        with profiling.span("upload", card) as sp:
            pass
        profiling.begin("finish")
    assert calls == [] and profiling.spans() == []
    assert sp.wall_s is not None
    assert set(profiling.stages(None)) == {"solve_s", "upload_s"}
    profiling.reset_stages()
    _problem(K2).solve()
    st = profiling.stages(None)
    assert calls == [] and profiling.spans() == []
    assert {"solve_s", "route.streaming_s", "upload_s", "stream_prep_s"} <= set(st)
    assert not {"solve_self_s", "finish_s", "api_s", "api_calls"} & set(st)
    # traced, a span given a card synchronises it at both ends
    profiling.enable()
    with profiling.span("upload", card):
        pass
    assert calls == [(card,), (card,)]
    assert [r.name for r in profiling.spans()] == ["upload"]


def test_the_profiler_sees_the_host_spans_and_not_the_device_spans(untraced):
    prob = _problem(K2)
    acts = [torch.profiler.ProfilerActivity.CPU]
    with torch.profiler.profile(activities=acts) as prof:
        assert profiling.tracing()
        prob.solve()
    assert not profiling.tracing()
    events = sorted((e for e in prof.events() if e.name.startswith("minilp.")),
                    key=lambda e: e.time_range.start)
    recs = profiling.spans()
    host = sorted((r for r in recs if r.host), key=lambda r: r.start)
    assert {"presolve", "canonicalize", "state_rebuild_host", "certify"} <= {
        r.name for r in host}
    # one range a host span, in the same order; each record carries the
    # request's id (the profiler keeps a range's args out of its events)
    assert [e.name for e in events] == ["minilp." + r.name for r in host]
    root = next(r for r in recs if r.parent is None)
    assert all(r.request == root.request for r in host)
    assert not DEVICE_SPANS & {e.name[len("minilp."):] for e in events}
    assert DEVICE_SPANS & {r.name for r in recs if not r.host}


@pytest.mark.parametrize("opts, route, event", [
    (K1, "megakernel", "cold_solve_megakernel"),
    (K2, "streaming", "cold_solve_streaming"),
    (ENGINE, "engine", "cold_solve"),
])
def test_route_counters_count_the_routes(traced, tmp_path, monkeypatch, opts, route, event):
    log = tmp_path / "records.jsonl"
    monkeypatch.setenv("MINILP_TPU_LOG", str(log))
    _problem(opts, m=24, nv=60).solve()
    st = profiling.stages(None)
    assert {k: v for k, v in st.items() if k.startswith("route.") and not k.endswith("_s")} \
        == {f"route.{route}": 1}
    (rec,) = [json.loads(line) for line in log.read_text().splitlines()]
    assert rec["event"] == event
    span = next(r for r in profiling.spans() if r.name == f"route.{route}")
    assert rec["wall_s"] == pytest.approx(span.end - span.start, abs=1e-12)
    assert st[f"route.{route}_s"] == pytest.approx(rec["wall_s"], abs=1e-12)
    if route == "streaming":
        assert st["stream_pivots"] == rec["iterations"] > 0


@pytest.mark.parametrize("status, counter", [
    (Status.OPTIMAL, "route.streaming.polished"),
    (Status.INFEASIBLE, "route.streaming.declined"),
])
def test_k2s_failed_checks_are_counted(traced, monkeypatch, status, counter):
    solve = streaming_simplex.solve_streaming

    def failed(*a, **kw):
        # OPTIMAL claimed two pivots in, a basis its f64 check refuses; any
        # other status fails the check whatever the basis
        if status == Status.OPTIMAL:
            kw["max_iter"] = 2
        return solve(*a, **kw)._replace(status=np.int32(status))

    monkeypatch.setattr(streaming_simplex, "solve_streaming", failed)
    sol = _problem(K2, m=24, nv=60).solve()
    assert sol._engine.certified
    st = profiling.stages(None)
    assert st["route.streaming"] == st[counter] == 1
    other = ({"route.streaming.polished", "route.streaming.declined"} - {counter}).pop()
    assert other not in st


def test_a_traced_cold_cell_reports_the_six_new_metrics(traced):
    sys.path.insert(0, str(ROOT))
    from lpbench import run
    from lpbench.traffic import cold

    class Program(cold.Program):
        """The cell's program with K2 forced: "auto" takes it on a card only."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            self.opts = K2

    sizes = {"shape": {"rows": 40, "cols": 100, "density": 0.05}}
    system = Program("cpu", lambda: None)
    r = run.run_cell("25fv47-cold", 2**31 + 29, 1.5, True, device="cpu", sizes=sizes,
                     system=system)
    assert r["correct"], r["checks"]
    got = {k: v["value"] for k, v in r["metrics"].items()}
    new = {"api_ms.cold", "upload_ms.cold", "finish_ms.cold", "unspanned_ms.cold",
           "k2_pivots.cold", "k2_fallback_pct.cold"}
    assert new <= set(got)
    assert 0.0 < got["api_ms.cold"] <= got["prep_ms.cold"]
    assert got["upload_ms.cold"] > 0.0 and got["finish_ms.cold"] > 0.0
    assert got["unspanned_ms.cold"] >= 0.0
    assert got["k2_pivots.cold"] > 0 and got["k2_fallback_pct.cold"] == 0.0
