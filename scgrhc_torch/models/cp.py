"""Continuous whole-record inference on one device, the PyTorch counterpart of
``scgrhc.models.cp.apply_continuous``.

The U-Net runs over an arbitrarily long record as ONE sequence, where the
windowed path (:mod:`scgrhc_torch.parallel.stream`) runs independent
windows: the convs keep their k3 p1 zero padding at the record's ends,
pooling becomes SAME-padded (the max over the samples there are), the
ConvTranspose k3 s1 upsampling becomes the equivalent SAME conv with the
kernel flipped and its channel axes swapped, and every instance norm
normalizes over the whole record.  Every op preserves the length, so L in
gives L out with no window seams.

The double-conv blocks are K1f's function (conv k3 p1 + bias, one-pass
clamped instance norm, relu) over the whole record, so they go through
:func:`scgrhc_torch.models.generator.fused_block`: 14 K1f launches a record
on the card, the plain version on the CPU.  At one record the attention
gate's instance norm over L is the JAX package's ``_instance_norm_global``
on one device, so :class:`scgrhc_torch.models.attention.AttentionGate`
serves unchanged.

Weights are the ordinary :class:`~scgrhc_torch.models.generator.Generator`:
no retraining or conversion.  Not ported: ``apply_cp``, the same forward
sharded over a mesh's time axis with halo exchanges.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scgrhc_torch.models.generator import fused_block
from scgrhc_torch.ops.nn import conv1d


def conv_transpose3(x, w, b):
    """ConvTranspose1d k3 s1 (weight (I, O, 3)) centre-cropped to x's length:
    a SAME conv with the kernel flipped and its channel axes swapped."""
    return conv1d(x, w.flip(-1).transpose(0, 1), b, padding=1)


def max_pool3_same(x):
    """k3 s1 max pool padded with -inf: each end takes the max over the
    samples there are."""
    return F.max_pool1d(x, kernel_size=3, stride=1, padding=1)


def apply_continuous(gen, x, block=fused_block):
    """Continuous whole-record forward: x (N, C, L) → (N, 1, L) in the
    ``final`` weights' dtype, computed in the generator's dtype (the
    serving path calls it at N = 1)."""
    x = x.to(gen.dtype)
    e1 = block(gen.enc1, x)
    e2 = block(gen.enc2, max_pool3_same(e1))
    e3 = block(gen.enc3, max_pool3_same(e2))
    d = block(gen.bottleneck, max_pool3_same(e3))
    for up, att, dec, skip in ((gen.up3, gen.att3, gen.dec3, e3),
                               (gen.up2, gen.att2, gen.dec2, e2),
                               (gen.up1, gen.att1, gen.dec1, e1)):
        d = conv_transpose3(d, up.weight, up.bias)
        d = block(dec, torch.cat((d, att(d, skip)), dim=1))
    fw, fb = gen.final.weight, gen.final.bias
    return conv1d(d.to(fw.dtype), fw, fb)
