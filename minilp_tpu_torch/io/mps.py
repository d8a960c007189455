"""MPS-format reader and writer (reference C7: `src/mps.rs` or test helper
[CODE]); the PyTorch port's copy of `minilp_tpu/io/mps.py`.

Parses fixed- or free-format MPS files (optionally gzipped) into a
`minilp_tpu_torch.Problem`: ROWS (N/L/G/E), COLUMNS (with INTORG/INTEND integrality
markers), RHS (including the objective-constant convention), RANGES, and
BOUNDS (UP/LO/FX/FR/MI/PL/BV/UI/LI).  Used by the Netlib-style test/bench
path (SURVEY.md §4.5 call stack).

Semantics follow the Netlib `lp/data` conventions:
  * default variable bounds are [0, +inf);
  * an UP bound u < 0 on a variable with no explicit lower bound makes the
    lower bound -inf (the classical MPS quirk);
  * a RANGES entry r on row i with rhs b gives:  L: [b-|r|, b],
    G: [b, b+|r|],  E: [b, b+r] for r ≥ 0 else [b+r, b];
  * an RHS entry against the objective row is the negated objective constant.

Ranged rows become two constraints in the Problem (our rows carry a single
comparison op, like the reference's `add_constraint` [API]).
"""

from __future__ import annotations

import dataclasses
import gzip
import math
from typing import Dict, List, Optional, Tuple

from ..api import ComparisonOp, LinearExpr, OptimizationDirection, Problem, Variable
from ..options import DEFAULT_OPTIONS, SolverOptions


@dataclasses.dataclass
class MpsProblem:
    """A parsed MPS model: the Problem plus name/metadata maps."""

    problem: Problem
    name: str
    #: MPS column name -> Variable
    variables: Dict[str, Variable]
    #: MPS row name -> list of constraint indices in the Problem (ranged rows map to two)
    rows: Dict[str, List[int]]
    #: objective constant (add to problem objective to match the MPS optimum)
    obj_constant: float
    #: columns declared integer via INTORG/INTEND markers
    integer_vars: List[str]

    def objective_value(self, solution) -> float:
        """Solution objective including the MPS objective constant."""
        return solution.objective() + self.obj_constant


def _tokens(line: str) -> List[str]:
    return line.split()


def read_mps(
    path: str,
    direction: OptimizationDirection = OptimizationDirection.Minimize,
    options: SolverOptions = DEFAULT_OPTIONS,
    native: Optional[bool] = None,
) -> MpsProblem:
    """Read an MPS file (gzipped if the name ends in .gz) into a Problem.

    `native=None` (default) uses the C++ tokenizer (native/mps_parser.cpp,
    built with g++ at first use and loaded with ctypes) when the file is
    large enough to matter (over 1 MB of text), the pure-Python parser
    otherwise; True forces the native parser, False the Python one.  A
    failed build of the native parser raises: nothing falls back to the
    Python parser.
    """
    if path.endswith(".gz"):
        with gzip.open(path, "rt") as f:
            text = f.read()
    else:
        with open(path, "rt") as f:
            text = f.read()
    if native or (native is None and len(text) > 1_000_000):
        from . import mps_native

        return mps_native.parse_mps_native(
            text, direction=direction, options=options
        )
    return parse_mps(text, direction=direction, options=options)


def parse_mps(
    text: str,
    direction: OptimizationDirection = OptimizationDirection.Minimize,
    options: SolverOptions = DEFAULT_OPTIONS,
) -> MpsProblem:
    name = ""
    obj_row: Optional[str] = None
    row_sense: Dict[str, str] = {}
    row_order: List[str] = []
    # column -> list of (row, coeff); objective coeffs separately
    col_entries: Dict[str, List[Tuple[str, float]]] = {}
    col_order: List[str] = []
    obj_coeffs: Dict[str, float] = {}
    rhs: Dict[str, float] = {}
    ranges: Dict[str, float] = {}
    obj_constant = 0.0
    # bounds: name -> [lo, hi] with None = not set
    bnd_lo: Dict[str, Optional[float]] = {}
    bnd_hi: Dict[str, Optional[float]] = {}
    integer_vars: List[str] = []
    in_integer = False

    section = None
    for raw in text.splitlines():
        if not raw.strip() or raw.lstrip().startswith("*"):
            continue
        if raw[0] not in " \t":
            parts = _tokens(raw)
            section = parts[0].upper()
            if section == "NAME":
                name = parts[1] if len(parts) > 1 else ""
            if section == "OBJSENSE":
                continue
            continue
        parts = _tokens(raw)
        if section == "OBJSENSE":
            s = parts[0].upper()
            direction = (
                OptimizationDirection.Maximize
                if s in ("MAX", "MAXIMIZE")
                else OptimizationDirection.Minimize
            )
        elif section == "ROWS":
            sense, rname = parts[0].upper(), parts[1]
            if sense == "N":
                if obj_row is None:
                    obj_row = rname
                # additional N rows are ignored (free rows), per convention
            else:
                row_sense[rname] = sense
                row_order.append(rname)
        elif section == "COLUMNS":
            if len(parts) >= 3 and parts[1].upper() == "'MARKER'":
                marker = parts[2].upper().strip("'")
                if marker == "INTORG":
                    in_integer = True
                elif marker == "INTEND":
                    in_integer = False
                continue
            # also handle  "MARKER  <name>  'INTORG'"
            if any(p.upper().strip("'") in ("INTORG", "INTEND") for p in parts):
                if any(p.upper().strip("'") == "INTORG" for p in parts):
                    in_integer = True
                else:
                    in_integer = False
                continue
            cname = parts[0]
            if cname not in col_entries:
                col_entries[cname] = []
                col_order.append(cname)
                if in_integer:
                    integer_vars.append(cname)
            for k in range(1, len(parts) - 1, 2):
                rname, val = parts[k], float(parts[k + 1])
                if rname == obj_row:
                    obj_coeffs[cname] = obj_coeffs.get(cname, 0.0) + val
                elif rname in row_sense:
                    col_entries[cname].append((rname, val))
                # entries on unknown/free rows are ignored
        elif section == "RHS":
            # first token is the RHS set name (may be omitted in sloppy files:
            # detect by whether it names a row)
            toks = parts
            if toks[0] in row_sense or toks[0] == obj_row:
                pairs = toks
            else:
                pairs = toks[1:]
            for k in range(0, len(pairs) - 1, 2):
                rname, val = pairs[k], float(pairs[k + 1])
                if rname == obj_row:
                    obj_constant = -val
                else:
                    rhs[rname] = val
        elif section == "RANGES":
            toks = parts
            pairs = toks if toks[0] in row_sense else toks[1:]
            for k in range(0, len(pairs) - 1, 2):
                ranges[pairs[k]] = float(pairs[k + 1])
        elif section == "BOUNDS":
            btype = parts[0].upper()
            # layout: TYPE SETNAME COLNAME [VALUE]
            if len(parts) >= 3:
                cname = parts[2] if len(parts) >= 3 else parts[1]
                val = float(parts[3]) if len(parts) > 3 else None
                # sloppy files sometimes omit the set name
                if parts[1] in col_entries and (
                    cname not in col_entries or len(parts) == 3
                ):
                    cname = parts[1]
                    val = float(parts[2]) if len(parts) > 2 else None
            else:
                continue
            if btype == "UP":
                bnd_hi[cname] = val
                if val is not None and val < 0 and cname not in bnd_lo:
                    bnd_lo[cname] = -math.inf
            elif btype == "LO":
                bnd_lo[cname] = val
            elif btype == "FX":
                bnd_lo[cname] = val
                bnd_hi[cname] = val
            elif btype == "FR":
                bnd_lo[cname] = -math.inf
                bnd_hi[cname] = math.inf
            elif btype == "MI":
                bnd_lo[cname] = -math.inf
            elif btype == "PL":
                bnd_hi[cname] = math.inf
            elif btype == "BV":
                bnd_lo[cname] = 0.0
                bnd_hi[cname] = 1.0
                if cname not in integer_vars:
                    integer_vars.append(cname)
            elif btype == "UI":
                bnd_hi[cname] = val
                if cname not in integer_vars:
                    integer_vars.append(cname)
            elif btype == "LI":
                bnd_lo[cname] = val
                if cname not in integer_vars:
                    integer_vars.append(cname)
        elif section == "ENDATA":
            break

    if obj_row is None:
        raise ValueError("MPS file has no objective (N) row")

    prob = Problem(direction, options)
    variables: Dict[str, Variable] = {}
    for cname in col_order:
        lo = bnd_lo.get(cname, 0.0)
        hi = bnd_hi.get(cname, math.inf)
        lo = -math.inf if lo is None else lo
        hi = math.inf if hi is None else hi
        variables[cname] = prob.add_var(
            obj_coeffs.get(cname, 0.0),
            (None if lo == -math.inf else lo, None if hi == math.inf else hi),
        )

    # rows: group entries per row
    row_terms: Dict[str, LinearExpr] = {r: LinearExpr() for r in row_order}
    for cname, entries in col_entries.items():
        v = variables[cname]
        for rname, val in entries:
            row_terms[rname].add(val, v)

    rows: Dict[str, List[int]] = {}
    for rname in row_order:
        sense = row_sense[rname]
        b = rhs.get(rname, 0.0)
        expr = row_terms[rname]
        idxs: List[int] = []
        if rname in ranges:
            r = ranges[rname]
            if sense == "L":
                blo, bhi = b - abs(r), b
            elif sense == "G":
                blo, bhi = b, b + abs(r)
            else:
                blo, bhi = (b, b + r) if r >= 0 else (b + r, b)
            idxs.append(prob.num_constraints)
            prob.add_constraint(expr, ComparisonOp.Ge, blo)
            idxs.append(prob.num_constraints)
            prob.add_constraint(expr, ComparisonOp.Le, bhi)
        else:
            op = {"L": ComparisonOp.Le, "G": ComparisonOp.Ge, "E": ComparisonOp.Eq}[sense]
            idxs.append(prob.num_constraints)
            prob.add_constraint(expr, op, b)
        rows[rname] = idxs

    return MpsProblem(
        problem=prob,
        name=name,
        variables=variables,
        rows=rows,
        obj_constant=obj_constant,
        integer_vars=integer_vars,
    )


def write_mps(
    problem: Problem,
    name: str = "MINILP",
    ranges: Optional[Dict[int, float]] = None,
) -> str:
    """Serialize a `Problem` to (free-format) MPS text.

    The inverse of `parse_mps` up to representation: rows are emitted in
    constraint order as `R{i}`, columns as `X{j}`; bounds cover the full MPS
    vocabulary the reader accepts (UP/LO/FX/FR/MI — whatever each variable's
    (lo, hi) needs beyond the default [0, +inf)); a Maximize direction is
    written as an OBJSENSE section.  `ranges` maps a constraint index to an
    MPS RANGES value on that row (the writer emits the entry verbatim; the
    reader expands it to the two-sided row per the Netlib convention), which
    lets tests exercise the RANGES path end-to-end without external data —
    C7's round-trip gate (VERDICT r4 #9; reference vendors real `*.mps.gz`
    files instead [CODE]).
    """
    ranges = ranges or {}
    out: List[str] = [f"NAME {name}"]
    if problem.direction == OptimizationDirection.Maximize:
        out.append("OBJSENSE")
        out.append("    MAX")
    out.append("ROWS")
    out.append(" N  COST")
    sense_char = {ComparisonOp.Le: "L", ComparisonOp.Ge: "G",
                  ComparisonOp.Eq: "E"}
    for i, (_terms, op, _rhs) in enumerate(problem._constraints):
        out.append(f" {sense_char[op]}  R{i}")
    # column-major entries (MPS groups by column)
    col_rows: Dict[int, List[Tuple[str, float]]] = {
        j: [] for j in range(problem.num_vars)
    }
    for i, (terms, _op, _rhs) in enumerate(problem._constraints):
        for j, coeff in terms:
            if coeff != 0.0:
                col_rows[j].append((f"R{i}", coeff))
    out.append("COLUMNS")
    for j in range(problem.num_vars):
        entries = list(col_rows[j])
        if problem._obj[j] != 0.0:
            entries.insert(0, ("COST", problem._obj[j]))
        if not entries:
            # a column with no entries anywhere must still be declared so the
            # reader creates the variable (emit a zero objective entry)
            entries = [("COST", 0.0)]
        for rname, coeff in entries:
            out.append(f"    X{j}  {rname}  {coeff!r}")
    out.append("RHS")
    for i, (_terms, _op, rhs) in enumerate(problem._constraints):
        if rhs != 0.0:
            out.append(f"    RHS  R{i}  {rhs!r}")
    if ranges:
        out.append("RANGES")
        for i in sorted(ranges):
            out.append(f"    RNG  R{i}  {ranges[i]!r}")
    out.append("BOUNDS")
    for j in range(problem.num_vars):
        lo = problem._lo[j]
        hi = problem._hi[j]
        lo = -math.inf if lo is None else lo
        hi = math.inf if hi is None else hi
        if lo == hi:
            out.append(f" FX BND  X{j}  {lo!r}")
            continue
        if lo == -math.inf and hi == math.inf:
            out.append(f" FR BND  X{j}")
            continue
        if lo == -math.inf:
            out.append(f" MI BND  X{j}")
        elif lo != 0.0:
            out.append(f" LO BND  X{j}  {lo!r}")
        if hi != math.inf:
            out.append(f" UP BND  X{j}  {hi!r}")
    out.append("ENDATA")
    return "\n".join(out) + "\n"
