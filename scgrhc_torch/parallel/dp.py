"""Data-parallel WGAN-GP training over the world of ranks, the PyTorch
counterpart of ``scgrhc.parallel.dp``.

The train state is replicated (every rank holds the same weights and Adam
state), the batch is sharded on the ``data`` axis, and each rank runs
:func:`scgrhc_torch.train.wgan.train_step` on its block so that the step
computes ``scgrhc``'s global-batch step:

  * every masked mean divides the rank's masked sum by the GLOBAL count
    (``count``), and the gradients are summed over the ranks, so the summed
    gradient is that of the global batch's loss;
  * each model's gradients (and its loss, for the log) are all-reduced as
    one flat bucket (:func:`all_reduce_bucket`) after each backward and
    before its Adam step: 6 all-reduces a step at ``n_critic`` 5;
  * every draw (the dropout masks, the GP's eps) is made at the global
    batch's shape from the step's one generator, and the rank takes its
    block (:class:`BlockDraws`), as GSPMD shards ``scgrhc``'s one-key
    draws.  A padded batch draws at its real rows' shape, so it too makes
    the draws of one process (``scgrhc``'s padded batch draws at the padded
    shape and takes another trajectory).

So a step at any world size computes the step of one process up to the
order of the gradient sum.  The GP needs no collective: each sample's
input gradient is its own, and both models use instance norm.  A mesh of
one is one process's step, bit for bit.

``torch.nn.parallel.DistributedDataParallel`` is not used: its reducer
fires on gradients accumulated into ``.grad``, which
``torch.autograd.grad`` (the GP's input gradient and every update here)
never touches, and the critic runs three forwards an update.
"""

from __future__ import annotations

import torch

from scgrhc_torch.core.trace import annotate
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import Mesh, make_mesh, pad_idx_mask, place_global
from scgrhc_torch.train.wgan import train_step


class BlockDraws:
    """The draw function of one rank's block of a step: U[0, 1) at the
    global batch's shape (``rows`` real rows, zeros for the pad rows up to
    ``padded``) from the step's ``torch.Generator``, this rank's block
    returned."""

    def __init__(self, generator: torch.Generator | None, mesh: Mesh, rows: int, padded: int):
        self.generator, self.mesh, self.rows, self.padded = generator, mesh, rows, padded

    def __call__(self, shape, device, dtype=None):
        full = torch.rand((self.rows, *shape[1:]), generator=self.generator, device=device,
                          dtype=dtype)
        if self.padded > self.rows:
            full = torch.cat((full, full.new_zeros((self.padded - self.rows, *shape[1:]))))
        out = place_global(full, self.mesh)
        assert out.shape[0] == shape[0], f"draw of {shape[0]} rows for a block of {out.shape[0]}"
        return out


def all_reduce_bucket(tensors):
    """The tensors summed over the ranks, as one flat all-reduce in the
    first one's dtype; without a group, the tensors themselves."""
    if not comm.is_initialized():
        return list(tensors)
    with annotate("grad_reduce"):
        dtype = tensors[0].dtype
        flat = comm.all_reduce_sum(torch.cat([t.reshape(-1).to(dtype) for t in tensors]))
        out, i = [], 0
        for t in tensors:
            out.append(flat[i:i + t.numel()].view_as(t).to(t.dtype))
            i += t.numel()
    return out


def _state_tensors(state):
    for module, opt in ((state.generator, state.g_opt), (state.critic, state.d_opt)):
        yield from module.parameters()
        for s in opt.state.values():
            yield from (v for v in s.values() if torch.is_tensor(v) and v.is_floating_point())


class DataParallelTrainer:
    """``train_step`` with the state replicated and the batch sharded.

    A batch whose size does not divide the mesh is padded with masked rows
    (:func:`scgrhc_torch.parallel.mesh.pad_idx_mask`); the block split
    asserts divisibility, so that an uneven shard never runs."""

    def __init__(self, mesh: Mesh | None = None):
        self.mesh = mesh if mesh is not None else make_mesh()
        self.n = self.mesh.size

    def place_state(self, state):
        """Rank 0's weights and Adam state on every rank, in place."""
        if comm.is_initialized():
            with torch.no_grad():
                ts = list(_state_tensors(state))
                flat = torch.cat([t.reshape(-1) for t in ts])
                comm.broadcast(flat)
                i = 0
                for t in ts:
                    t.copy_(flat[i:i + t.numel()].view_as(t))
                    i += t.numel()
        return state

    def step(self, state, scg, rhc, idx, rng, cfg):
        """One step on the global batch ``(scg[idx], rhc[idx])`` (``idx``, the
        batch's B row indices, a tensor on scg's device): this rank's block
        of the padded index gathered onto the state's device and run
        through ``train_step``.  Returns the global losses, as
        ``train_step`` does.  The span ``train_step`` holds it all."""
        with annotate("train_step"):
            dev = next(state.generator.parameters()).device
            padded, mask = pad_idx_mask(idx, self.n)
            rows = place_global(padded, self.mesh)
            if mask is not None:
                mask = place_global(mask, self.mesh).to(dev)
            draws = BlockDraws(rng, self.mesh, len(idx), len(padded))
            return train_step(state, scg[rows].to(dev), rhc[rows].to(dev), draws, cfg, mask,
                              count=len(idx), reduce=all_reduce_bucket)
