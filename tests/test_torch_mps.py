"""PyTorch port, MPS I/O: `minilp_tpu_torch/io/mps.py` and `mps_native.py`
held against `minilp_tpu/io/` on the same text.

The fixtures of `tests/test_mps.py` and `write_mps` round trips of the
synthetic shapes go through both packages and both parsers (the Python
reader and the native C++ tokenizer, which the port builds with g++ at first
use): the same Problem (objective, bounds, rows), the same canonical A, b, c
and bounds, and, where solved, the reference's objective (1e-9) and the
HiGHS oracle's (1e-6).  A failed build of the native parser raises.
"""

import gzip
import math

import numpy as np
import pytest

import minilp_tpu_torch
from minilp_tpu.canonical import canonicalize as ref_canonicalize
from minilp_tpu.io import mps as ref_mps, mps_native as ref_native
from minilp_tpu.utils import synth as ref_synth
from minilp_tpu_torch.canonical import canonicalize
from minilp_tpu_torch.io import mps, mps_native

from . import test_mps as fixtures
from .oracle import solve_with_oracle
from .torch_helpers import as_torch_problem, rel_err

CPU = minilp_tpu_torch.SolverOptions(device="cpu")
TEXTS = {"simple": fixtures.SIMPLE, "ranged": fixtures.RANGED,
         "objconst": fixtures.OBJCONST, "free_neg_up": fixtures.FREE_NEG_UP}


def _same_problem(port, ref):
    """A port MpsProblem equals a reference one, row for row."""
    p, r = port.problem, ref.problem
    assert (p.direction.value, p._obj, p._lo, p._hi) == (r.direction.value, r._obj, r._lo, r._hi)
    assert [(list(t), op.value, b) for t, op, b in p._constraints] == \
        [(list(t), op.value, b) for t, op, b in r._constraints]
    assert (port.name, port.rows, port.obj_constant, port.integer_vars) == \
        (ref.name, ref.rows, ref.obj_constant, ref.integer_vars)


def _canonical(prob):
    port = isinstance(prob, minilp_tpu_torch.Problem)
    return (canonicalize if port else ref_canonicalize)(prob)


def _same_canonical(prob, ref_prob):
    """The same canonical form (either package's Problem on either side)."""
    a, b = _canonical(prob), _canonical(ref_prob)
    for f in ("A", "b", "c", "lo", "hi"):
        assert np.array_equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("parser", ["python", "native"])
@pytest.mark.parametrize("name", sorted(TEXTS))
def test_fixtures_parse_as_the_reference(name, parser):
    text = TEXTS[name]
    ref = ref_mps.parse_mps(text)
    port = (mps.parse_mps(text, options=CPU) if parser == "python"
            else mps_native.parse_mps_native(text, options=CPU))
    _same_problem(port, ref)
    _same_canonical(port.problem, ref.problem)


@pytest.mark.parametrize("name", sorted(TEXTS))
def test_fixtures_solve_as_the_reference(name):
    ref = ref_mps.parse_mps(TEXTS[name])
    port = mps.parse_mps(TEXTS[name], options=CPU)
    outcome, obj, _ = solve_with_oracle(ref.problem)
    assert outcome == "optimal"
    sol = port.problem.solve()
    assert rel_err(sol.objective(), ref.problem.solve().objective()) <= 1e-9
    assert rel_err(sol.objective(), obj) <= 1e-6
    assert port.objective_value(sol) == sol.objective() + port.obj_constant


def test_integer_markers_and_bv():
    text = """\
NAME INTS
ROWS
 N obj
 L c1
COLUMNS
    MARKER                 'MARKER'                 'INTORG'
    a obj -1.0 c1 1.0
    MARKER                 'MARKER'                 'INTEND'
    b obj -1.0 c1 1.0
RHS
 rhs c1 5.0
BOUNDS
 BV bnd b
ENDATA
"""
    for parse in (mps.parse_mps, mps_native.parse_mps_native):
        port = parse(text, options=CPU)
        _same_problem(port, ref_mps.parse_mps(text))
        assert port.integer_vars == ["a", "b"]
        assert port.problem._hi[1] == 1.0


@pytest.mark.parametrize("native", [None, False, True])
def test_read_mps_gzip_and_plain(tmp_path, native):
    for name, text in TEXTS.items():
        for suffix in (".mps", ".mps.gz"):
            path = tmp_path / f"{name}{suffix}"
            if suffix.endswith(".gz"):
                with gzip.open(path, "wt") as f:
                    f.write(text)
            else:
                path.write_text(text)
            port = mps.read_mps(str(path), options=CPU, native=native)
            _same_problem(port, ref_mps.read_mps(str(path), native=False))


def _synthetic(shape):
    if shape == "mixed_bounds_24x60":
        return ref_synth.mixed_bounds_problem(24, 60, 0.2, seed=2)
    if shape == "netlib_shaped_40x90":
        return ref_synth.netlib_shaped_problem(40, 90, 0.1, seed=5)
    return ref_synth.netlib_shaped_problem(*ref_synth.NETLIB_SHAPES[shape], seed=1)


@pytest.mark.parametrize("shape", ["netlib_shaped_40x90", "mixed_bounds_24x60",
                                   "25fv47", "fit1p"])
def test_write_read_round_trip_of_synthetic_shapes(tmp_path, shape):
    """`write_mps` → `read_mps` in both packages, through both parsers: the
    same text, Problem and canonical form, equal to the original's."""
    ref_prob = _synthetic(shape)
    port_prob = as_torch_problem(ref_prob)
    text = mps.write_mps(port_prob)
    assert text == ref_mps.write_mps(ref_prob)
    path = tmp_path / "synthetic.mps"
    path.write_text(text)
    ref = ref_mps.read_mps(str(path), native=False)
    _same_canonical(port_prob, ref_prob)
    _same_canonical(ref.problem, ref_prob)
    for native in (False, True):
        port = mps.read_mps(str(path), options=CPU, native=native)
        _same_problem(port, ref)
        _same_canonical(port.problem, ref.problem)
    if ref_native.available():
        _same_problem(ref_native.parse_mps_native(text), ref)


def test_write_mps_round_trip_solves_as_the_reference():
    ref_prob = _synthetic("mixed_bounds_24x60")
    outcome, obj, _ = solve_with_oracle(ref_prob)
    assert outcome == "optimal"
    back = mps.parse_mps(mps.write_mps(as_torch_problem(ref_prob)), options=CPU).problem
    sol = back.solve()
    assert sol._engine.certified
    assert rel_err(sol.objective(), ref_prob.solve().objective()) <= 1e-9
    assert rel_err(sol.objective(), obj) <= 1e-6


def test_write_mps_ranges_and_maximize():
    prob = minilp_tpu_torch.Problem(minilp_tpu_torch.OptimizationDirection.Maximize, CPU)
    x = prob.add_var(1.0, (0.0, 2.0))
    y = prob.add_var(1.5, (None, 3.0))
    prob.add_constraint(x + y, minilp_tpu_torch.ComparisonOp.Le, 4.0)
    prob.add_constraint(x - y, minilp_tpu_torch.ComparisonOp.Ge, -3.0)
    text = mps.write_mps(prob, ranges={0: 5.0, 1: 2.0})
    assert "OBJSENSE" in text and "RANGES" in text and " MI BND" in text
    port = mps.parse_mps(text, options=CPU)
    _same_problem(port, ref_mps.parse_mps(text))
    assert len(port.rows["R0"]) == 2 and len(port.rows["R1"]) == 2
    assert port.problem.direction == minilp_tpu_torch.OptimizationDirection.Maximize
    assert math.isinf(port.problem._lo[1])


def test_failed_native_build_raises(tmp_path, monkeypatch):
    """No fallback: without the compiler the native parser raises, and so
    does `read_mps(native=True)`."""
    monkeypatch.setattr(mps_native, "_lib", None)
    monkeypatch.setattr(mps_native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(mps_native, "CXX", "no-such-compiler-on-path")
    path = tmp_path / "simple.mps"
    path.write_text(fixtures.SIMPLE)
    with pytest.raises(RuntimeError, match="no-such-compiler"):
        mps.read_mps(str(path), options=CPU, native=True)
    # the Python parser still reads it when asked for
    _same_problem(mps.read_mps(str(path), options=CPU, native=False),
                  ref_mps.parse_mps(fixtures.SIMPLE))
