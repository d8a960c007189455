"""Build and load the port's CUDA kernels.

Each kernel source in `minilp_tpu_torch/csrc/` has a plain C interface: one
`nvcc` call compiles it into a shared library for Hopper (`sm_90a`), which is
loaded with `ctypes`.  The build happens at first use in a process, into
`build/minilp_tpu_torch/` at the root of the checkout (listed in
`.gitignore`), under a name that carries a hash of the source and the flags,
so an edited source is never served from a stale library.  Nothing here runs
at import time, and nothing falls back: a missing `nvcc` or a failed compile
raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import time

CSRC = pathlib.Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "minilp_tpu_torch"

#: Hopper only; no --use_fast_math: approximate division would change ratios,
#: pivot choices and the handling of inf.  -Xptxas -v reports registers,
#: shared memory and spills into the build log.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]


class Built:
    """A loaded kernel library plus what its build reported."""

    def __init__(self, lib: ctypes.CDLL, path: pathlib.Path, seconds: float,
                 log: str):
        self.lib = lib
        self.path = path
        self.seconds = seconds  # 0.0 when an existing build was loaded
        self.log = log


_loaded: dict[str, Built] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(cuda_home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
        "kernels of minilp_tpu_torch are built from source at first use"
    )


def load(name: str) -> Built:
    """Compile `csrc/<name>.cu` (once per source and flags) and load it."""
    if name in _loaded:
        return _loaded[name]
    src = CSRC / f"{name}.cu"
    text = src.read_bytes()
    digest = hashlib.sha256(text + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    out = BUILD_DIR / f"lib{name}_{digest}.so"
    seconds, log = 0.0, ""
    if not out.exists():
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
        t0 = time.perf_counter()
        proc = subprocess.run(cmd, capture_output=True, text=True)
        seconds = time.perf_counter() - t0
        log = proc.stdout + proc.stderr
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(f"nvcc failed for {src.name}:\n{log}")
        os.replace(tmp, out)  # atomic: a concurrent build never sees a partial file
    built = Built(ctypes.CDLL(str(out)), out, seconds, log)
    _loaded[name] = built
    return built
