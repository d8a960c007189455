"""A (data, model) layout of a `torch.distributed` world, PyTorch port of
`minilp_tpu/parallel/mesh.py`.

The JAX package lays its devices out as a `jax.sharding.Mesh` and lets
`shard_map` insert the collectives.  Here every rank of a process group runs
the same function on its own block (SPMD): `make_mesh` lays the world's
ranks out row-major as an (n_data, n_model) grid, as the JAX package
reshapes its device list, and makes one process group per row (the ranks
that share a data index: the 'model' axis) and per column (the ranks that
share a model index: the 'data' axis).  `batch_block` / `column_block` /
`row_block` cut a global tensor into this rank's block (the counterparts of
`batch_sharding` / `column_sharding`), `replicated` places a whole tensor on
the rank's device, and `assemble` puts a sharded tensor back together on
every rank of an axis, bit for bit.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import torch
import torch.distributed as dist

from .collectives import exact_sum

#: Mesh axis over which independent scenario LPs are sharded (pure DP).
BATCH_AXIS = "data"
#: Mesh axis over which the columns of A are sharded for parallel pricing (TP).
COL_AXIS = "model"


@dataclasses.dataclass(frozen=True, eq=False)
class Mesh:
    """This rank's view of the layout: the axis sizes, its coordinates, the
    process group along each axis (the ranks it shares that axis with) and
    the torch device its blocks live on."""

    shape: dict        # axis name -> size
    coords: dict       # axis name -> this rank's index on the axis
    groups: dict       # axis name -> process group of this rank's row/column
    device: torch.device


def rank_device(device) -> torch.device:
    """`device` with the CUDA index of this rank's current device filled in."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def make_mesh(
    n_data: Optional[int] = None,
    n_model: int = 1,
    *,
    device="cuda",
    ranks: Optional[Sequence[int]] = None,
) -> Optional[Mesh]:
    """A 2-D ('data', 'model') layout of `ranks` (default: the whole world);
    defaults to all of them on the data axis.

    Every rank of the world must call it, with the same arguments: it calls
    `dist.new_group` for every row and column of the layout in one fixed
    order, the groups a rank is not in included (otherwise the ranks
    deadlock).  A rank outside `ranks` gets None.
    """
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs an initialized process group "
                           "(parallel.distributed.init_distributed)")
    ranks = list(range(dist.get_world_size()) if ranks is None else ranks)
    if n_data is None:
        n_data = len(ranks) // n_model
    if n_data * n_model != len(ranks):
        raise ValueError(f"mesh {n_data}x{n_model} does not cover {len(ranks)} ranks")
    grid = [ranks[i * n_model:(i + 1) * n_model] for i in range(n_data)]
    rows = [dist.new_group(row) for row in grid]                       # 'model' axis
    cols = [dist.new_group([row[k] for row in grid]) for k in range(n_model)]  # 'data' axis
    me = dist.get_rank()
    if me not in ranks:
        return None
    i, k = divmod(ranks.index(me), n_model)
    return Mesh(
        shape={BATCH_AXIS: n_data, COL_AXIS: n_model},
        coords={BATCH_AXIS: i, COL_AXIS: k},
        groups={BATCH_AXIS: cols[k], COL_AXIS: rows[i]},
        device=rank_device(device),
    )


def _block(mesh: Mesh, x, axis: str, dim: int) -> torch.Tensor:
    x = torch.as_tensor(x, device=mesh.device)
    size, parts = x.shape[dim], mesh.shape[axis]
    if size % parts:
        raise ValueError(f"dimension {dim} of size {size} does not divide over "
                         f"the {parts} ranks of axis {axis!r}")
    n = size // parts
    return x.narrow(dim, mesh.coords[axis] * n, n).contiguous()


def batch_block(mesh: Mesh, x) -> torch.Tensor:
    """This rank's slice of the leading (scenario batch) axis: pure DP."""
    return _block(mesh, x, BATCH_AXIS, 0)


def column_block(mesh: Mesh, x) -> torch.Tensor:
    """This rank's block of the last (column) axis over the model axis."""
    x = torch.as_tensor(x)
    return _block(mesh, x, COL_AXIS, x.dim() - 1)


def row_block(mesh: Mesh, x, axis: str = COL_AXIS) -> torch.Tensor:
    """This rank's block of the leading (row) axis over `axis`."""
    return _block(mesh, x, axis, 0)


def replicated(mesh: Mesh, x) -> torch.Tensor:
    """The whole tensor on this rank's device."""
    return torch.as_tensor(x, device=mesh.device)


def assemble(mesh: Mesh, x_loc: torch.Tensor, axis: str, dim: int) -> torch.Tensor:
    """The whole tensor from the blocks that the ranks of `axis` hold along
    `dim`, on every rank of the axis, bit for bit (`collectives.exact_sum`:
    each element has one owner)."""
    n = x_loc.shape[dim]
    shape = list(x_loc.shape)
    shape[dim] = n * mesh.shape[axis]
    full = torch.zeros(shape, dtype=x_loc.dtype, device=x_loc.device)
    full.narrow(dim, mesh.coords[axis] * n, n).copy_(x_loc)
    return exact_sum(full, mesh.groups[axis])
