"""Deterministic reductions across the ranks of a process group, PyTorch port
of `minilp_tpu/parallel/collectives.py`.

As in the JAX package, the sharded engines need partial sums (`psum`), exact
min/max (`pmin`, `pmax`) and a combined argmax-with-index for the global
entering column, with ties going to the lowest global index, so that a
sharded solve takes the single-device pivot sequence.  Each of them returns
a new tensor (JAX's collectives are functional; an in-place `all_reduce` on
a caller's tensor would change the caller's data).

Every collective is built from `all_reduce` alone, the one collective that
gloo supports on CUDA tensors besides `broadcast`, so the same code runs
under gloo on the CPU, under gloo across ranks that share one card, and
under NCCL.  Values that one rank owns are gathered exactly: the owner puts
the bits of its values in a buffer of zeros and the group sums the bits as
integers (`exact_sum`); a float sum would turn −0.0 into +0.0.

`stats` counts the collectives of this process and the host seconds spent
in them (on a CUDA tensor under NCCL only the launch; under gloo the host
staging and the exchange).
"""

from __future__ import annotations

import time

import torch
import torch.distributed as dist

#: this process's collectives so far: {"calls": int, "seconds": float}
stats = {"calls": 0, "seconds": 0.0}

_BITS = {torch.float64: torch.int64, torch.float32: torch.int32,
         torch.float16: torch.int16, torch.bfloat16: torch.int16}


def _all_reduce(x: torch.Tensor, op, group) -> torch.Tensor:
    """`op` over the group, on a copy of `x` (returned)."""
    y = x.clone()
    t0 = time.perf_counter()
    dist.all_reduce(y, op=op, group=group)
    stats["seconds"] += time.perf_counter() - t0
    stats["calls"] += 1
    return y


def psum(x: torch.Tensor, group) -> torch.Tensor:
    """Partial-sum reduction (residual norms, reduced-cost partials)."""
    return _all_reduce(x, dist.ReduceOp.SUM, group)


def pmax(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MAX, group)


def pmin(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce(x, dist.ReduceOp.MIN, group)


def _to_bits(x: torch.Tensor) -> torch.Tensor:
    """The bits of `x` as int64 (floats sign-extended from their own width)."""
    x = x.contiguous()
    if x.dtype in _BITS:
        return x.view(_BITS[x.dtype]).to(torch.int64)
    return x.to(torch.int64)


def _from_bits(bits: torch.Tensor, dtype) -> torch.Tensor:
    if dtype in _BITS:
        return bits.to(_BITS[dtype]).view(dtype)
    return bits.to(dtype)


def exact_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The group's sum of `x`, exact where at most one rank holds a nonzero
    value in each element (an owner's value, zeros elsewhere): the bits are
    summed as integers, so −0.0, ±inf and NaN arrive as the owner sent them."""
    return _from_bits(_all_reduce(_to_bits(x), dist.ReduceOp.SUM, group), x.dtype)


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(group size, *x.shape): every rank's `x`, exactly, in rank order."""
    rank = dist.get_rank(group)
    buf = torch.zeros((dist.get_world_size(group),) + tuple(x.shape),
                      dtype=x.dtype, device=x.device)
    buf[rank] = x
    return exact_sum(buf, group)


def argmax_with_index(score: torch.Tensor, global_index: torch.Tensor, group):
    """Global (max score, smallest index among ties) across the group.

    `score`: () local best score (−inf when the rank has no candidate);
    `global_index`: () the candidate's global column index.  One gather of
    one (score, index) pair per rank, as the JAX package's `all_gather`;
    returns 0-d (best_score, best_index), the same on every rank.
    """
    pair = torch.stack([_to_bits(score.reshape(())), global_index.reshape(()).to(torch.int64)])
    got = all_gather(pair, group)
    scores = _from_bits(got[:, 0], score.dtype)
    best = scores.max()
    big = torch.iinfo(torch.int64).max
    # ties → smallest global index, matching single-device argmax semantics
    idx = torch.where(scores == best, got[:, 1], big).min()
    return best, idx
