"""Tensor parallelism over the ``model`` mesh axis, the PyTorch counterpart
of ``scgrhc.parallel.tp``.

:func:`param_pspecs` is ``scgrhc``'s rule: a parameter whose dim 0
divides the axis size (and the size is > 1) is sharded on dim 0; the rest
(the 1-channel heads: the attention ``psi`` convs and ``final``) are
replicated.  :func:`shard_params` keeps this rank's shards and runs the
tensor-parallel forward that XLA's GSPMD derives for ``scgrhc`` from that
layout, by layer:

  * the double-conv blocks' convs (weight (O, I, 3)) are out-channel
    sharded: K1f's (sample, channel) rows are independent, instance norm
    included, so each rank runs K1f at O/tp on the whole input and the
    channels are all-gathered before the next layer, which needs them all;
  * the up-convs' dim 0 is their INPUT channels (weight (I, O, 3)), so
    each rank convolves its I/tp input channels into partial sums of every
    output channel, adds its shard of the bias to its own O/tp of them, and
    the partial sums are all-reduced;
  * the attention gates' ``W_g`` and ``W_x`` are out-sharded (their norms
    are per channel, so local), and ``psi`` (replicated) takes partial
    sums over the rank's channels, all-reduced;
  * ``final`` runs replicated.

A forward at tp > 1 makes 20 collectives over the model axis (14 channel
all-gathers, 3 up-conv and 3 ``psi`` all-reduces).  On a 2-D (data,
model) mesh (:func:`make_dp_tp_mesh`) the batch is split over the data
axis first and gathered back after, one collective more.  At tp = 8 the
first block's 64 channels become 8 a rank, below the conv core's 16-row
minimum, and K1f takes its streaming path (``kConvStreamBelow`` in
``csrc/conv3.cuh``), which the card tests hold to the plain version.

The model is small (about 10 M parameters), so tensor parallelism is not
load-bearing here, as in ``scgrhc``: these are the axis's hooks.
"""

from __future__ import annotations

import copy

import torch.nn.functional as F
from torch import nn

from scgrhc_torch.ops.kernels.conv_block import conv_in_relu
from scgrhc_torch.ops.nn import conv1d, conv_transpose1d
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel.mesh import DATA_AXIS, fetch_rows, make_grid, pad_rows, row_block

MODEL_AXIS = "model"


def make_dp_tp_mesh(dp: int, tp: int) -> dict:
    """The 2-D (data, model) mesh over the world's dp·tp ranks, row-major
    (rank i·tp + j is data row i, model column j), one
    :class:`~scgrhc_torch.parallel.mesh.Mesh` per axis.  A collective."""
    return make_grid((dp, tp), (DATA_AXIS, MODEL_AXIS))


def _split(shape, tp: int) -> bool:
    return len(shape) >= 1 and shape[0] % tp == 0 and shape[0] >= tp > 1


def param_pspecs(gen, tp_size: int) -> dict:
    """{state-dict key: spec}: ``(MODEL_AXIS, None, ...)`` for a parameter
    whose dim 0 is sharded, ``(None, ...)`` for a replicated one (the
    entries of ``scgrhc``'s PartitionSpecs)."""
    return {k: ((MODEL_AXIS,) if _split(v.shape, tp_size) else (None,)) + (None,) * (v.dim() - 1)
            for k, v in gen.state_dict().items()}


def shard_params(gen, mesh: dict) -> "TensorParallelGenerator":
    """The tensor-parallel generator over ``mesh`` (:func:`make_dp_tp_mesh`)
    holding this rank's shards of ``gen``'s parameters (``gen`` is left as
    it was)."""
    return TensorParallelGenerator(gen, mesh)


class TensorParallelGenerator(nn.Module):
    """x (B, C, T), the same on every rank → (B, 1, T) on every rank, as
    ``Generator.forward`` in eval mode: the generator's own forward with
    the three sharded ops below passed in (module doc)."""

    def __init__(self, gen, mesh: dict):
        super().__init__()
        self.model, self.data = mesh[MODEL_AXIS], mesh[DATA_AXIS]
        tp, r = self.model.size, self.model.rank
        self.gen = copy.deepcopy(gen)
        specs = param_pspecs(gen, tp)
        self._shards = set()
        for name, p in self.gen.named_parameters():
            if specs[name][0] == MODEL_AXIS:
                p.data = p.data.chunk(tp)[r].clone()
                self._shards.add(p)

    def _own(self, t, dim: int):
        """This rank's shard of t along ``dim``."""
        return t.chunk(self.model.size, dim=dim)[self.model.rank]

    def _block(self, blk, x):
        """K1f at this rank's out-channels, gathered where they are sharded."""
        for conv in blk.convs:
            x = conv_in_relu(x, conv.weight, conv.bias)
            if conv.weight in self._shards:
                x = comm.all_gather(x, self.model.group, dim=1)
        return x

    def _up(self, d, w, b):
        """ConvTranspose1d k3 s1: L → L + 2, on input-channel shards."""
        if w not in self._shards:  # I = 2·O here, so an unsharded I leaves O unsharded
            return conv_transpose1d(d, w, b)
        part = F.conv_transpose1d(self._own(d, 1), w)
        if b in self._shards:
            self._own(part, 1).add_(b.to(part.dtype)[None, :, None])
        elif self.model.rank == 0:
            part.add_(b.to(part.dtype)[None, :, None])
        return comm.all_reduce_sum(part, self.model.group)

    def _psi(self, h, w, b):
        """The gate's ψ conv (replicated) on h, which holds this rank's
        channels where ``W_g`` and ``W_x`` are sharded: partial sums."""
        if h.shape[1] == w.shape[1]:
            return conv1d(h, w, b)
        s = comm.all_reduce_sum(conv1d(h, self._own(w, 1)), self.model.group)
        return s + b.to(s.dtype)[None, :, None]

    def forward(self, x):
        n, g = x.shape[0], self.gen
        a, b, k = row_block(self.data, n)
        x = pad_rows(x[a:b], k).to(g.dtype)
        y = g.decode(x, *g.encode(x, self._block), self._block, up=self._up, psi=self._psi)
        return fetch_rows(self.data, n, y)[0]
