"""Meshes of ranks and the data axis's row sharding, the PyTorch
counterpart of ``scgrhc.parallel.mesh``.

A mesh axis is a group of ranks (:mod:`scgrhc_torch.parallel.comm`), one
card each, with a name:

  * ``data`` — the batch, segment and window dimension;
  * ``time`` — the time steps of one long record (``models.cp.apply_cp``);
  * ``stage`` and ``model`` — ``parallel.pp`` and ``parallel.tp``.

A 1-D mesh (:func:`make_mesh`) spans the world; a 2-D mesh
(:func:`make_grid`) lays the world out row-major over its axes, as
``np.asarray(devices).reshape(shape)`` does, and gives each axis its
process group.  On the data axis, sharding follows ``P(axis)``: rank r
holds the r-th contiguous block of dim 0.  A training batch that does not
divide the mesh is padded with masked rows (:func:`pad_idx_mask`), as
``scgrhc``'s training pads it; the chunks of evaluation and streaming are
split with :func:`row_block`, padded with :func:`pad_rows` and gathered
back with :func:`fetch_rows`.  A mesh of one (``Mesh(1, 0)``, or
:func:`make_mesh` without a group) is one process's path: its block is
every row, nothing is padded and nothing is gathered.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from scgrhc_torch.parallel import comm

DATA_AXIS = "data"
TIME_AXIS = "time"


@dataclass(frozen=True)
class Mesh:
    """One mesh axis: ``size`` ranks, of which this process is rank
    ``rank``; ``group`` is the axis's process group (None: the world)."""

    size: int
    rank: int
    axis: str = DATA_AXIS
    group: object = field(default=None, compare=False, repr=False)

    def block(self, rows: int) -> slice:
        """This rank's block of ``rows`` rows (a multiple of the size)."""
        assert rows % self.size == 0, f"{rows} rows not divisible by mesh size {self.size}"
        k = rows // self.size
        return slice(self.rank * k, (self.rank + 1) * k)


def make_mesh(n: int | None = None, axis: str = DATA_AXIS) -> Mesh:
    """The 1-D mesh over every rank of the world, on ``axis``; ``n``, where
    given, must be the world's size (a mesh spans every rank)."""
    size = comm.process_count()
    if n is not None and n != size:
        raise ValueError(f"a {n}-rank {axis!r} mesh needs a world of {n} ranks, have {size}")
    return Mesh(size, comm.process_index(), axis)


def make_grid(shape: tuple[int, ...], axes: tuple[str, ...]) -> dict[str, Mesh]:
    """A mesh of ``shape`` over the world's ranks laid out row-major, one
    :class:`Mesh` per axis name, each with its process group (the ranks
    that differ from this one only along that axis).  A collective: every
    rank calls it, with the same arguments."""
    size = math.prod(shape)
    if size != comm.process_count():
        raise ValueError(f"a {'x'.join(map(str, shape))} mesh needs {size} ranks, have "
                         f"{comm.process_count()}")
    ranks = np.arange(size).reshape(shape)
    grid = {}
    for d, axis in enumerate(axes):
        lines = np.moveaxis(ranks, d, -1).reshape(-1, shape[d])
        group = None
        for line in lines:  # every group, on every rank, in one order
            g = comm.new_group(line.tolist()) if comm.is_initialized() else None
            if comm.process_index() in line:
                group = g
        grid[axis] = Mesh(shape[d], comm.shard_index(group), axis, group)
    return grid


def round_up(n: int, size: int) -> int:
    return -(-n // size) * size


def pad_idx_mask(idx, n_dev: int):
    """Pad a batch's (B,) gather index (a tensor) with row 0 up to a
    multiple of ``n_dev``, and the (B',) float32 0/1 mask that makes the pad
    rows inert, both on idx's device.  Returns (idx, mask) with mask None
    when nothing is padded."""
    bs, pad = idx.shape[0], -idx.shape[0] % n_dev
    if not pad:
        return idx, None
    dev = idx.device
    return (torch.cat((idx, idx.new_zeros(pad))),
            torch.cat((torch.ones(bs, device=dev), torch.zeros(pad, device=dev))))


def place_global(arr, mesh: Mesh):
    """This rank's block of dim 0 of the global ``arr`` (every rank holds the
    same global value, as every process reads the same files)."""
    return arr[mesh.block(arr.shape[0])]


def fetch_global(x, mesh: Mesh):
    """The global value of a dim-0-sharded tensor: every rank's block,
    gathered in rank order to every rank (``process_allgather(tiled=True)``).
    A collective: every rank calls it in the same order."""
    if mesh.size == 1:
        return x
    return comm.all_gather(x, mesh.group)


def row_block(mesh: Mesh, n: int) -> tuple[int, int, int]:
    """(start, stop, k): this rank's rows [start, stop) of n rows split in
    blocks of k = ⌈n / size⌉; a block short of k rows (the last ranks')
    is padded to k with :func:`pad_rows`."""
    k = -(-n // mesh.size)
    start = min(n, mesh.rank * k)
    return start, min(n, start + k), k


def pad_rows(a, k: int, fill=0.0):
    """a with rows of ``fill`` (a scalar, or one row's values) appended up
    to k rows; a itself when it has k."""
    if a.shape[0] == k:
        return a
    row = torch.as_tensor(fill, dtype=a.dtype, device=a.device)
    return torch.cat((a, row.expand(k - a.shape[0], *a.shape[1:])))


def fetch_rows(mesh: Mesh, n: int, *blocks):
    """Each of ``blocks`` (every rank's k rows of n, :func:`row_block`)
    gathered in rank order to every rank and cut to the n real rows, with
    one all-gather for all of them (they share a dtype)."""
    if mesh.size == 1:
        return [b[:n] for b in blocks]
    widths = [math.prod(b.shape[1:]) for b in blocks]
    flat = fetch_global(torch.cat([b.reshape(b.shape[0], -1) for b in blocks], dim=1), mesh)[:n]
    return [part.reshape(n, *b.shape[1:])
            for part, b in zip(flat.split(widths, dim=1), blocks)]
