"""The communication layer over ``torch.distributed``, the PyTorch
counterpart of ``scgrhc.parallel.comm``.

The port runs one process per card, launched as PyTorch users launch one
(``torchrun --nproc-per-node=N -m scgrhc_torch <dir>``, or any launcher
that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``): ``scgrhc``'s multi-controller mode with one controller
per card.  The world of ranks carries the meshes of
:mod:`scgrhc_torch.parallel.mesh`: a 1-D mesh (the ``data``, ``time`` or
``stage`` axis) spans it, and a 2-D (``data``, ``model``) mesh gives each
axis a process group of its own (:func:`new_group`).  Without those
variables nothing is initialized and every helper here is the identity of
one process.  Under
a group every helper runs its collective, at world size 1 too (where it is
the identity on the values, and exercises the backend).

Backend rule (a rule, never a retry: a backend that fails to start raises,
and no rank carries on alone or on the CPU):

  * ``nccl`` when each rank has its own card: the device is left to the
    rank (``None`` or ``"cuda"``, which resolve to ``cuda:{LOCAL_RANK}``);
  * ``gloo`` on the CPU (``"cpu"``);
  * ``gloo`` when the caller pins the rank to one card (``"cuda:N"``),
    which is how several ranks share a card: NCCL refuses two ranks on one
    device.  Gloo stages CUDA tensors through the host; the compute stays
    on the card.

Rank 0 prints the world, its backend and the rule's reason.

Under the ``nccl`` rule each rank's current card is set to
``cuda:{LOCAL_RANK}``, so the device ``cuda`` (the entry points' default)
is the rank's own card.

Single writer: every rank computes (the collectives need them all), and
only rank 0 writes the shared files.  :func:`on_primary` runs a stage's
work on rank 0 and holds every rank there until it returns, and makes a
failure on rank 0 an error on every rank, so that no rank waits on a
collective the others will never reach.  That wait is not bounded by the
group's timeout (``TIMEOUT_S``, which catches a dead peer in a
collective): rank 0's work alone (the data stage over a whole cohort, a
first build of the kernels, a checkpoint write) may take longer, so the
other ranks wait for it over a second, gloo group whose timeout is
``STAGE_TIMEOUT_S``.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

TIMEOUT_S = 120.0  # a dead peer raises instead of hanging in a collective
STAGE_TIMEOUT_S = 6 * 3600.0  # the longest that rank 0 may work alone in on_primary

_stage_group = None  # gloo, STAGE_TIMEOUT_S: on_primary's wait


def backend_for(device) -> tuple[str, str]:
    """(backend, reason) for ranks running on ``device``."""
    dev = None if device is None else torch.device(device)
    if dev is not None and dev.type == "cpu":
        return "gloo", "ranks on the CPU"
    if dev is not None and dev.index is not None:
        return "gloo", f"ranks pinned to {dev}, which they may share"
    return "nccl", "one card per rank (cuda:LOCAL_RANK)"


def init_distributed(init_method: str | None = None, world_size: int | None = None,
                     rank: int | None = None, *, device=None,
                     timeout_s: float = TIMEOUT_S) -> bool:
    """Join the world of ranks; True when this call created the group.

    With no arguments, the launcher's environment (``env://``): a no-op when
    ``WORLD_SIZE`` is unset or 1.  The arguments mirror ``scgrhc``'s
    ``coordinator_address``, ``num_processes`` and ``process_id``; with
    them a group is made at any world size (e.g. ``file://`` stores in
    tests, or one rank over NCCL).  ``device`` picks the backend
    (:func:`backend_for`); under NCCL the rank's card becomes the current
    one, and a ``LOCAL_RANK`` past the host's cards raises."""
    global _stage_group
    if dist.is_initialized():
        return False
    if init_method is None and world_size is None:
        world_size = int(os.environ.get("WORLD_SIZE", "1"))
        if world_size <= 1:
            return False
    if world_size is None:
        world_size = int(os.environ["WORLD_SIZE"])
    if rank is None:
        rank = int(os.environ["RANK"])
    backend, reason = backend_for(device)
    if backend == "nccl":
        local = int(os.environ.get("LOCAL_RANK", rank))
        if local >= torch.cuda.device_count():
            raise RuntimeError(
                f"LOCAL_RANK {local} but this host has {torch.cuda.device_count()} CUDA "
                "device(s): launch one rank per card, or pin every rank to one card "
                "(--device cuda:0)"
            )
        torch.cuda.set_device(local)
    dist.init_process_group(backend, init_method=init_method or "env://",
                            world_size=world_size, rank=rank,
                            timeout=datetime.timedelta(seconds=timeout_s))
    _stage_group = dist.new_group(backend="gloo",
                                  timeout=datetime.timedelta(seconds=STAGE_TIMEOUT_S))
    if rank == 0:
        print(f"scgrhc_torch: {world_size} rank(s) over {backend} ({reason})", flush=True)
    return True


def refuse_lone_rank() -> None:
    """Raise when the environment names a world (``WORLD_SIZE`` > 1) and no
    process group is up: each process would otherwise run alone, and all
    would write the same files."""
    world = os.environ.get("WORLD_SIZE", "1")
    if not dist.is_initialized() and world.isdigit() and int(world) > 1:
        raise RuntimeError(
            f"WORLD_SIZE={world} but no process group is up: call "
            "scgrhc_torch.parallel.comm.init_distributed() first (the CLI does)"
        )


def destroy() -> None:
    global _stage_group
    if dist.is_initialized():
        dist.destroy_process_group()
    _stage_group = None


def is_initialized() -> bool:
    return dist.is_initialized()


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    """True on the rank that writes the shared files (rank 0)."""
    return process_index() == 0


def _flag_device() -> torch.device:
    """Where the group's small tensors live: the card for NCCL, the host
    for gloo."""
    if dist.get_backend() == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def barrier(name: str = "scgrhc") -> None:
    """Hold every rank here until all have come.  No-op without a group."""
    if dist.is_initialized():
        dist.all_reduce(torch.zeros(1, device=_flag_device()))


def on_primary(name: str, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on rank 0 only; every rank waits here until
    it returns, for up to ``STAGE_TIMEOUT_S``.  If it raised, rank 0 raises
    its error and every other rank a RuntimeError naming it.  Returns fn's
    result on rank 0, None on the others; without a group, simply fn's
    result."""
    if not dist.is_initialized():
        return fn(*args, **kwargs)
    out, err = None, None
    if is_primary():
        try:
            out = fn(*args, **kwargs)
        except Exception as e:
            err = e
    msg = [None if err is None else f"{type(err).__name__}: {err}"]
    dist.broadcast_object_list(msg, src=0, group=_stage_group)
    if err is not None:
        raise err
    if msg[0] is not None:
        raise RuntimeError(f"{name}: rank 0 failed: {msg[0]}")
    return out


def new_group(ranks):
    """A process group of ``ranks`` (world ranks) on the world's backend.
    Every rank of the world calls it, for every group, in the same order."""
    return dist.new_group(ranks=list(ranks), timeout=datetime.timedelta(seconds=TIMEOUT_S))


def broadcast_object(obj, src: int = 0):
    """Rank ``src``'s picklable obj on every rank, over the stage group: the
    wait may be as long as ``STAGE_TIMEOUT_S`` (a daemon's followers wait
    here for rank 0's next request)."""
    if not dist.is_initialized():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, group=_stage_group)
    return box[0]


def gather_objects(obj) -> list:
    """Every rank's picklable obj, in rank order, on every rank (over the
    stage group)."""
    if not dist.is_initialized():
        return [obj]
    out = [None] * process_count()
    dist.all_gather_object(out, obj, group=_stage_group)
    return out


# -- collectives: over the world by default, or over one axis of a mesh -----
# (``group``, :attr:`scgrhc_torch.parallel.mesh.Mesh.group`); in place on x,
# which is returned.  Without a process group each is the identity.

def shard_index(group=None) -> int:
    """This rank's index along the axis whose group is ``group`` (``scgrhc``'s
    ``lax.axis_index``); 0 without a process group."""
    return dist.get_rank(group) if dist.is_initialized() else 0


def broadcast(x, src: int = 0, group=None):
    """Rank ``src``'s x (``src`` indexes the group's ranks) on every rank."""
    if dist.is_initialized():
        dist.broadcast(x, src=_global(src, group), group=group)
    return x


def all_reduce_sum(x, group=None):
    if dist.is_initialized():
        dist.all_reduce(x, group=group)
    return x


def all_reduce_mean(x):
    """Mean over the ranks (``scgrhc``'s ``pmean``)."""
    if dist.is_initialized():
        dist.all_reduce(x)
        x.div_(process_count())
    return x


def all_reduce_max(x):
    if dist.is_initialized():
        dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


def all_gather_list(x, group=None) -> list:
    """Every rank's x in rank order; every rank's x has the same shape.  The
    list form, which gloo takes for CUDA tensors too."""
    if not dist.is_initialized():
        return [x]
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x.contiguous(), group=group)
    return parts


def all_gather(x, group=None, dim: int = 0):
    """Every rank's x, concatenated along ``dim`` in rank order (``scgrhc``'s
    ``all_gather(..., tiled=True)``)."""
    if not dist.is_initialized():
        return x
    return torch.cat(all_gather_list(x, group), dim=dim)


def neighbour_edges(first, last, group=None):
    """The halo exchange along an axis (``scgrhc.models.cp``'s
    ``_edge_from_left`` / ``_edge_from_right``): (the left neighbour's
    ``last``, the right neighbour's ``first``), None at the axis's two ends.

    One all-gather of every rank's (first, last) pair, a few KB: it runs
    under gloo, whose send/recv take CPU tensors only, and under NCCL alike,
    and it is one collective per exchange where a pair of sends would be
    two.  Every rank calls it in the same order."""
    if not dist.is_initialized():
        return None, None
    pairs = all_gather_list(torch.stack((first, last)), group)
    r = dist.get_rank(group)
    return (pairs[r - 1][1] if r > 0 else None,
            pairs[r + 1][0] if r + 1 < len(pairs) else None)


def send(x, dst: int, group=None):
    """Start sending x to rank ``dst`` of the group; returns a callable that
    waits until x may be reused.  Gloo's send takes CPU tensors only, so a
    CUDA tensor goes through pinned host memory there; that copy waits for
    the work that made x, and the send then runs beside the next work."""
    if x.is_cuda and dist.get_backend(group) == "gloo":
        x = torch.empty(x.shape, dtype=x.dtype, pin_memory=True).copy_(x)
    req = dist.isend(x.contiguous(), _global(dst, group), group=group)

    def wait():
        req.wait()
        return x

    return wait


def recv(x, src: int, group=None):
    """Start receiving into x from rank ``src`` of the group; returns a
    callable that waits and gives the received tensor (x itself, or a copy
    of the host buffer on x's device under gloo)."""
    buf = x
    if x.is_cuda and dist.get_backend(group) == "gloo":
        buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    req = dist.irecv(buf, _global(src, group), group=group)

    def wait():
        req.wait()
        return x.copy_(buf) if buf is not x else x

    return wait


def _global(rank: int, group) -> int:
    """The world rank of rank ``rank`` of ``group``."""
    return rank if group is None else dist.get_global_rank(group, rank)
