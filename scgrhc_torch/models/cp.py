"""Continuous whole-record inference, on one rank or time-sharded over
several: the PyTorch counterpart of ``scgrhc.models.cp``.

* :func:`apply_continuous` runs the U-Net over an arbitrarily long record
  as ONE sequence, where the windowed path
  (:mod:`scgrhc_torch.parallel.stream`) runs independent windows: the
  convs keep their k3 p1 zero padding at the record's ends, pooling
  becomes SAME-padded (the max over the samples there are), the
  ConvTranspose k3 s1 upsampling becomes the equivalent SAME conv with the
  kernel flipped and its channel axes swapped, and every instance norm
  normalizes over the whole record.  Every op preserves the length, so L
  in gives L out with no window seams.

* :func:`apply_cp` is the same forward sharded over a mesh's ``time``
  axis: each rank holds a contiguous L/W block of the record.  Every
  length-preserving local op takes its neighbours' edge columns
  (:func:`with_halo`; zeros at the record's two ends, the continuous
  mode's zero padding, and -inf for the pools), and every instance norm
  sums its statistics over the ranks.  The output is the continuous
  mode's, gathered to every rank.

The double-conv blocks are K1f's function over the whole record: one
launch a layer in :func:`apply_continuous`
(:func:`scgrhc_torch.models.generator.fused_block`), and in
:func:`apply_cp` its two phases with the (sum, sum of squares) of each row
all-reduced between them
(:func:`scgrhc_torch.ops.kernels.conv_block.conv_in_relu_part` and
:func:`~scgrhc_torch.ops.kernels.conv_block.conv_in_relu_apply`): 14 of
each a record on the card, the plain versions on the CPU.  The attention
gates' norms are :func:`scgrhc_torch.ops.nn.instance_norm_global` in both
modes (the JAX package's ``_instance_norm_global``), so that one rank's
``apply_cp`` takes ``apply_continuous``'s arithmetic.

A time-sharded forward makes 20 halo exchanges (14 block convs, 3
up-convs, 3 pools; one all-gather of a (2, N, C, 1) edge pair each), 23
norm all-reduces (14 K1f layers, 9 attention norms) and one all-gather of
the output: 44 collectives.

Weights are the ordinary :class:`~scgrhc_torch.models.generator.Generator`:
no retraining or conversion.
"""

from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from scgrhc_torch.models.generator import fused_block
from scgrhc_torch.ops.kernels.conv_block import conv_in_relu_apply, conv_in_relu_part
from scgrhc_torch.ops.nn import conv1d, instance_norm_global
from scgrhc_torch.parallel import comm


def _conv_transpose3_halo(xh, w, b):
    """ConvTranspose1d k3 s1 (weight (I, O, 3)) centre-cropped, on a block
    with its edge columns xh (N, I, len + 2) → (N, O, len): a conv with the
    kernel flipped and its channel axes swapped."""
    return conv1d(xh, w.flip(-1).transpose(0, 1), b)


def conv_transpose3(x, w, b):
    """ConvTranspose1d k3 s1 centre-cropped to x's length: a SAME conv with
    the kernel flipped and its channel axes swapped."""
    return _conv_transpose3_halo(F.pad(x, (1, 1)), w, b)


def max_pool3_same(x):
    """k3 s1 max pool padded with -inf: each end takes the max over the
    samples there are."""
    return F.max_pool1d(x, kernel_size=3, stride=1, padding=1)


def _unet(gen, x, block, pool, up, norm):
    """The generator's forward with its length-preserving ops passed in."""
    return gen.decode(x, *gen.encode(x, block, pool=pool), block, up=up, norm=norm)


def apply_continuous(gen, x, block=fused_block):
    """Continuous whole-record forward: x (N, C, L) → (N, 1, L) in the
    ``final`` weights' dtype, computed in the generator's dtype (the
    serving path calls it at N = 1)."""
    return _unet(gen, x.to(gen.dtype), block, max_pool3_same, conv_transpose3,
                 instance_norm_global)


def with_halo(x, mesh, fill: float = 0.0):
    """x (N, C, k), this rank's block → (N, C, k + 2) with its left
    neighbour's last column and its right neighbour's first (``scgrhc``'s
    ``_with_halo``); ``fill`` at the record's two ends, which the rank
    knows from its place on the axis."""
    left, right = comm.neighbour_edges(x[..., 0], x[..., -1], mesh.group)
    end = x.new_full(x.shape[:-1], fill)
    left = end if left is None else left
    right = end if right is None else right
    return torch.cat((left[..., None], x, right[..., None]), dim=-1)


def apply_cp(gen, record, mesh):
    """Time-sharded continuous forward over ``mesh`` (the ``time`` axis, W
    ranks): record (C, L), the same on every rank, with L divisible by W →
    (1, 1, L) on every rank, in the ``final`` weights' dtype.  Rank r
    computes steps [r·L/W, (r + 1)·L/W) (module doc)."""
    c, length = record.shape
    if length % mesh.size:
        raise ValueError(f"record length {length} not divisible by the {mesh.size} ranks of "
                         f"the {mesh.axis!r} axis")
    x = record[None, :, mesh.block(length)].to(gen.dtype)
    reduce = partial(comm.all_reduce_sum, group=mesh.group)

    def block(blk, a):
        for conv in blk.convs:
            c, sums = conv_in_relu_part(with_halo(a, mesh), conv.weight, conv.bias)
            a = conv_in_relu_apply(c, reduce(sums), length, a.dtype)
        return a

    def pool(a):
        return F.max_pool1d(with_halo(a, mesh, float("-inf")), kernel_size=3, stride=1)

    def up(a, w, b):
        return _conv_transpose3_halo(with_halo(a, mesh), w, b)

    y = _unet(gen, x, block, pool, up, partial(instance_norm_global, reduce=reduce))
    return comm.all_gather(y[0, 0], mesh.group).reshape(1, 1, length)
