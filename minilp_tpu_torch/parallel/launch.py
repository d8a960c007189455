"""A local world of ranks for the sharded engines: one process per rank.

The JAX package calls a sharded function from one process, and XLA runs it
on every device of the mesh.  With `torch.distributed` every rank is a
process of its own that runs the same function on its own block, so a
caller (a test, `chip_smoke.py`, the dry run) needs a world of ranks:

    results = run_world("minilp_tpu_torch.parallel.launch:run_calls", 4,
                        backend="gloo", device="cpu", args=(calls,))

`run_world` starts `world_size` processes as `python -m
minilp_tpu_torch.parallel.launch DIR RANK` (not `multiprocessing`, whose
spawn re-imports the caller's main module), with `MASTER_ADDR`,
`MASTER_PORT`, `RANK` and `WORLD_SIZE` set.  Each rank initialises the
process group, calls the target (a function of this package, named as
"module:function", with the pickled `args` and `device=`), and writes its
result, tensors as numpy arrays, into the temporary directory DIR.  When a
rank exits with an error, or the world outlives `timeout_s`, every rank is
killed and `run_world` raises with the output of each failed rank; the process
group's own timeout (the same `timeout_s`) ends a collective that a rank
never joins.
"""

from __future__ import annotations

import importlib
import os
import pathlib
import pickle
import shutil
import socket
import subprocess
import sys
import tempfile
import time
import traceback

import torch

_ROOT = pathlib.Path(__file__).resolve().parents[2]


def free_port() -> int:
    """A TCP port on localhost that is free at the time of the call."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def to_host(value):
    """`value` with every tensor, in dicts, tuples and lists, as a numpy
    array (named tuples become dicts)."""
    if isinstance(value, torch.Tensor):
        return value.detach().cpu().numpy()
    if isinstance(value, tuple) and hasattr(value, "_asdict"):
        return {k: to_host(v) for k, v in value._asdict().items()}
    if isinstance(value, dict):
        return {k: to_host(v) for k, v in value.items()}
    if isinstance(value, (list, tuple)):
        return type(value)(to_host(v) for v in value)
    return value


def _tail(path: pathlib.Path, n: int = 4000) -> str:
    return path.read_text(errors="replace")[-n:] if path.exists() else ""


def run_world(target: str, world_size: int, *, backend: str, device: str,
              args=(), timeout_s: float = 120.0) -> list:
    """Run `target(*args, device=device)` on every rank of a new local world
    of `world_size` processes; returns each rank's result, in rank order."""
    tmp = pathlib.Path(tempfile.mkdtemp(prefix="minilp_world_"))
    procs = []
    try:
        with open(tmp / "spec.pkl", "wb") as f:
            pickle.dump(dict(target=target, args=args, backend=backend,
                             device=device, timeout_s=timeout_s), f)
        env = dict(os.environ, MASTER_ADDR="127.0.0.1", MASTER_PORT=str(free_port()),
                   WORLD_SIZE=str(world_size),
                   PYTHONPATH=os.pathsep.join(
                       [str(_ROOT)] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        for rank in range(world_size):
            with open(tmp / f"log_{rank}.txt", "wb") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, "-m", "minilp_tpu_torch.parallel.launch",
                     str(tmp), str(rank)],
                    env=dict(env, RANK=str(rank)), stdout=log, stderr=subprocess.STDOUT,
                    stdin=subprocess.DEVNULL, cwd=str(_ROOT)))
        deadline = time.monotonic() + timeout_s
        while True:
            codes = [p.poll() for p in procs]
            if any(code not in (None, 0) for code in codes):
                # a peer of a failed rank fails too (a collective loses its
                # partner): give them a moment, then report every failure
                time.sleep(1.0)
                codes = [p.poll() for p in procs]
                raise RuntimeError("\n".join(
                    f"rank {r} of {world_size} exited with code {code} "
                    f"({target}):\n{_tail(tmp / f'log_{r}.txt')}"
                    for r, code in enumerate(codes) if code not in (None, 0)))
            if all(code == 0 for code in codes):
                break
            if time.monotonic() > deadline:
                tails = "\n".join(f"--- rank {r} ---\n{_tail(tmp / f'log_{r}.txt', 1500)}"
                                  for r in range(world_size))
                raise TimeoutError(
                    f"the world of {world_size} ranks outlived {timeout_s} s "
                    f"({target}):\n{tails}")
            time.sleep(0.02)
        results = []
        for rank in range(world_size):
            with open(tmp / f"result_{rank}.pkl", "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        shutil.rmtree(tmp, ignore_errors=True)


def _resolve(target: str):
    module, _, name = target.partition(":")
    return getattr(importlib.import_module(module), name)


def run_calls(calls, *, device):
    """Rank target: each call is (mesh shape or None, "module:function",
    args, kwargs).  With a mesh shape (n_data, n_model) the function gets
    the mesh of that shape (made once, by every rank) as its first
    argument; without one it gets `device=`.  Returns per call its result,
    its wall seconds (the device synchronised) and the collectives it
    made."""
    from . import collectives
    from .mesh import make_mesh

    sync = torch.cuda.synchronize if torch.device(device).type == "cuda" else (lambda: None)
    meshes, out = {}, []
    for shape, fn, args, kwargs in calls:
        if shape is not None and shape not in meshes:
            meshes[shape] = make_mesh(*shape, device=device)
        f = _resolve(fn)
        if shape is None:
            kwargs = dict(kwargs, device=device)
        else:
            args = (meshes[shape],) + tuple(args)
        calls0, secs0 = collectives.stats["calls"], collectives.stats["seconds"]
        sync()
        t0 = time.perf_counter()
        res = f(*args, **kwargs)
        sync()
        out.append(dict(result=to_host(res), wall_s=time.perf_counter() - t0,
                        collectives=collectives.stats["calls"] - calls0,
                        collective_s=collectives.stats["seconds"] - secs0))
    return out


def world_probe(fail_rank=None, skip_rank=None, *, device):
    """Rank target: one all-reduce of ones over the world, which must sum to
    its size.  `fail_rank` raises on that rank before the collective, and
    `skip_rank` leaves without it: the launcher's own check that a failing
    or diverging rank becomes an error within the timeout."""
    import torch.distributed as dist

    rank = dist.get_rank()
    if rank == fail_rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    if rank == skip_rank:
        return None
    one = torch.ones(1, device=device)
    dist.all_reduce(one)
    if int(one.item()) != dist.get_world_size():
        raise AssertionError(f"all_reduce of ones gave {one.item()}")
    return int(one.item())


def _rank_main(world_dir: str, rank: str) -> None:
    import torch.distributed as dist

    from .distributed import init_distributed

    tmp = pathlib.Path(world_dir)
    with open(tmp / "spec.pkl", "rb") as f:
        spec = pickle.load(f)
    torch.set_num_threads(1)  # the ranks share the host's cores
    device = spec["device"]
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(int(rank) % torch.cuda.device_count())
    init_distributed(backend=spec["backend"], timeout_s=spec["timeout_s"])
    try:
        result = to_host(_resolve(spec["target"])(*spec["args"], device=device))
    except BaseException:
        traceback.print_exc()
        sys.stderr.flush()
        os._exit(1)  # leave at once: a peer may wait in a collective
    part = tmp / f"result_{rank}.pkl.part"
    with open(part, "wb") as f:
        pickle.dump(result, f)
    part.rename(tmp / f"result_{rank}.pkl")
    dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(*sys.argv[1:3])
