"""ctypes bindings for the native MPS parser (native/mps_parser.cpp).

Provides `parse_mps_native(text)` returning the same `MpsProblem` as the pure
Python `parse_mps`, ~30–50× faster on large Netlib/Mittelmann files.  The
shared library is built from the checkout's `native/mps_parser.cpp` with
`g++` at first use, into `build/minilp_tpu_torch/` (listed in
`.gitignore`), under a name that carries a hash of the source and flags.
Nothing here runs at import time, and nothing falls back: a missing
compiler or a failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import pathlib
import shutil
import subprocess
from typing import Optional

import numpy as np

from ..api import ComparisonOp, LinearExpr, OptimizationDirection, Problem
from ..options import DEFAULT_OPTIONS, SolverOptions
from .mps import MpsProblem

_ROOT = pathlib.Path(__file__).resolve().parents[2]
SOURCE = _ROOT / "native" / "mps_parser.cpp"
BUILD_DIR = _ROOT / "build" / "minilp_tpu_torch"
#: the C++ compiler (a name on PATH or a path)
CXX = "g++"
CXX_FLAGS = ["-O3", "-shared", "-fPIC", "-std=c++17"]
_lib: Optional[ctypes.CDLL] = None


def build() -> pathlib.Path:
    """Compile the parser (once per source and flags) and return the path
    of the shared library; raises when the compiler is missing or fails."""
    digest = hashlib.sha256(
        SOURCE.read_bytes() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libmps_parser_{digest}.so"
    if out.exists():
        return out
    cxx = shutil.which(CXX)
    if cxx is None:
        raise RuntimeError(
            f"the native MPS parser is built with {CXX!r}, which is not "
            "installed; pass native=False to read_mps for the Python parser"
        )
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"building the native MPS parser failed:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    return out


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is not None:
        return _lib
    lib = ctypes.CDLL(str(build()))
    lib.mps_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64]
    lib.mps_parse.restype = ctypes.c_int
    for fn in ("mps_error", "mps_name"):
        getattr(lib, fn).restype = ctypes.c_char_p
    for fn in ("mps_num_rows", "mps_num_cols", "mps_num_triplets",
               "mps_num_rhs", "mps_num_ranges", "mps_num_bounds",
               "mps_num_integer", "mps_row_names_size", "mps_col_names_size"):
        getattr(lib, fn).restype = ctypes.c_int64
    for fn in ("mps_copy_row_sense", "mps_copy_integer", "mps_copy_row_names",
               "mps_copy_col_names"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
        getattr(lib, fn).restype = None
    for fn in ("mps_copy_rhs", "mps_copy_ranges"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p, ctypes.c_void_p]
        getattr(lib, fn).restype = None
    for fn in ("mps_copy_triplets", "mps_copy_bounds"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 3
        getattr(lib, fn).restype = None
    _lib = lib
    return lib


_BOUND_TYPES = ["UP", "LO", "FX", "FR", "MI", "PL", "BV", "UI", "LI"]


def parse_mps_native(
    text: str,
    direction: OptimizationDirection = OptimizationDirection.Minimize,
    options: SolverOptions = DEFAULT_OPTIONS,
) -> MpsProblem:
    lib = _load()
    raw = text.encode()
    rc = lib.mps_parse(raw, len(raw))
    if rc != 0:
        raise ValueError(f"MPS parse error: {lib.mps_error().decode()}")

    n_rows = lib.mps_num_rows()
    n_cols = lib.mps_num_cols()
    n_tri = lib.mps_num_triplets()
    n_rhs = lib.mps_num_rhs()
    n_rng = lib.mps_num_ranges()
    n_bnd = lib.mps_num_bounds()
    n_int = lib.mps_num_integer()

    def i32(n):
        return np.zeros(max(n, 1), dtype=np.int32)

    def f64(n):
        return np.zeros(max(n, 1), dtype=np.float64)

    sense = i32(n_rows)
    lib.mps_copy_row_sense(sense.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    tc, tr, tv = i32(n_tri), i32(n_tri), f64(n_tri)
    lib.mps_copy_triplets(
        tc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        tv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    rr, rv = i32(n_rhs), f64(n_rhs)
    lib.mps_copy_rhs(
        rr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    gr, gv = i32(n_rng), f64(n_rng)
    lib.mps_copy_ranges(
        gr.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        gv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    bc, bt, bv = i32(n_bnd), i32(n_bnd), f64(n_bnd)
    lib.mps_copy_bounds(
        bc.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bt.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        bv.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
    )
    ic = i32(n_int)
    lib.mps_copy_integer(ic.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))

    rn_buf = ctypes.create_string_buffer(int(lib.mps_row_names_size()) + 1)
    lib.mps_copy_row_names(rn_buf)
    row_names = rn_buf.raw[: lib.mps_row_names_size()].decode().split("\n")[:-1]
    cn_buf = ctypes.create_string_buffer(int(lib.mps_col_names_size()) + 1)
    lib.mps_copy_col_names(cn_buf)
    col_names = cn_buf.raw[: lib.mps_col_names_size()].decode().split("\n")[:-1]
    name = lib.mps_name().decode()

    # ---- assemble the Problem (same semantics as the Python reader) --------
    lo = np.zeros(n_cols)
    hi = np.full(n_cols, math.inf)
    lo_set = np.zeros(n_cols, dtype=bool)
    for k in range(n_bnd):
        j, t, v = int(bc[k]), _BOUND_TYPES[int(bt[k])], float(bv[k])
        if t == "UP":
            hi[j] = v
            if v < 0 and not lo_set[j]:
                lo[j] = -math.inf
        elif t == "LO":
            lo[j] = v
            lo_set[j] = True
        elif t == "FX":
            lo[j] = hi[j] = v
            lo_set[j] = True
        elif t == "FR":
            lo[j] = -math.inf
            hi[j] = math.inf
            lo_set[j] = True
        elif t == "MI":
            lo[j] = -math.inf
            lo_set[j] = True
        elif t == "PL":
            hi[j] = math.inf
        elif t == "BV":
            lo[j], hi[j] = 0.0, 1.0
            lo_set[j] = True
        elif t == "UI":
            hi[j] = v
        elif t == "LI":
            lo[j] = v
            lo_set[j] = True

    obj = np.zeros(n_cols)
    obj_mask = tr == -1
    np.add.at(obj, tc[obj_mask], tv[obj_mask])

    obj_constant = 0.0
    rhs = np.zeros(n_rows)
    for k in range(n_rhs):
        if rr[k] == -1:
            obj_constant = -float(rv[k])
        else:
            rhs[rr[k]] = rv[k]
    ranges = {int(gr[k]): float(gv[k]) for k in range(n_rng)}

    prob = Problem(direction, options)
    variables = {}
    for j in range(n_cols):
        variables[col_names[j]] = prob.add_var(
            float(obj[j]),
            (None if lo[j] == -math.inf else float(lo[j]),
             None if hi[j] == math.inf else float(hi[j])),
        )

    # rows: collect terms per row from triplets
    exprs = [LinearExpr() for _ in range(n_rows)]
    con_mask = ~obj_mask
    for col, row, val in zip(tc[con_mask], tr[con_mask], tv[con_mask]):
        exprs[row].add(float(val), variables[col_names[col]])

    rows = {}
    sense_map = {0: ComparisonOp.Le, 1: ComparisonOp.Ge, 2: ComparisonOp.Eq}
    for i in range(n_rows):
        op = sense_map[int(sense[i])]
        b = float(rhs[i])
        idxs = []
        if i in ranges:
            r = ranges[i]
            if op == ComparisonOp.Le:
                blo, bhi = b - abs(r), b
            elif op == ComparisonOp.Ge:
                blo, bhi = b, b + abs(r)
            else:
                blo, bhi = (b, b + r) if r >= 0 else (b + r, b)
            idxs.append(prob.num_constraints)
            prob.add_constraint(exprs[i], ComparisonOp.Ge, blo)
            idxs.append(prob.num_constraints)
            prob.add_constraint(exprs[i], ComparisonOp.Le, bhi)
        else:
            idxs.append(prob.num_constraints)
            prob.add_constraint(exprs[i], op, b)
        rows[row_names[i]] = idxs

    return MpsProblem(
        problem=prob,
        name=name,
        variables=variables,
        rows=rows,
        obj_constant=obj_constant,
        integer_vars=sorted({col_names[j] for j in ic[:n_int]}),
    )
