"""The communication layer over ``torch.distributed``, the PyTorch
counterpart of ``scgrhc.parallel.comm``.

The port runs one process per card, launched as PyTorch users launch one
(``torchrun --nproc-per-node=N -m scgrhc_torch <dir>``, or any launcher
that sets ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``): ``scgrhc``'s multi-controller mode with one controller
per card.  The world of ranks is the ``data`` mesh
(:mod:`scgrhc_torch.parallel.mesh`).  Without those variables nothing is
initialized and every helper here is the identity of one process.  Under
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


# -- collectives over the data axis: in place on x, which is returned --------

def broadcast(x, src: int = 0):
    """Rank ``src``'s x on every rank."""
    if dist.is_initialized():
        dist.broadcast(x, src=src)
    return x


def all_reduce_sum(x):
    if dist.is_initialized():
        dist.all_reduce(x)
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


def all_gather(x):
    """Every rank's x, concatenated along dim 0 in rank order (``scgrhc``'s
    ``all_gather(..., tiled=True)``); every rank's x has the same shape.  The
    list form, which gloo takes for CUDA tensors too."""
    if not dist.is_initialized():
        return x
    parts = [torch.empty_like(x) for _ in range(process_count())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)
