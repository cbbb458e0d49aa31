"""Additive (soft) attention gate for the U-Net skip connections, the
PyTorch counterpart of ``scgrhc.models.attention`` (reference:
waveform_train.py:16-64).

1x1 convs + instance norm on the gating signal g and the skip activation
x, ReLU, a 1x1 conv → instance norm → sigmoid giving a per-position weight
ψ, output ``x * ψ``.  The submodule names give the reference state-dict
keys ``W_x.0.weight``, ``W_g.0.bias``, ``psi.0.weight``, ...
"""

from __future__ import annotations

import torch
from torch import nn

from scgrhc_torch.ops.nn import conv1d, conv_init, instance_norm, relu, sigmoid


class Conv(nn.Module):
    """Weight and bias of one (transposed) 1-D convolution, initialised as
    PyTorch's default from an explicit generator.  The forward lives in the
    caller, which chooses the op (plain conv, transposed conv, kernel)."""

    def __init__(self, out_ch: int, in_ch: int, k: int, generator: torch.Generator,
                 transpose: bool = False, dtype=torch.float32):
        super().__init__()
        w, b = conv_init(generator, out_ch, in_ch, k, transpose=transpose, dtype=dtype)
        self.weight = nn.Parameter(w)
        self.bias = nn.Parameter(b)


class AttentionGate(nn.Module):
    def __init__(self, f_x: int, f_g: int, f_int: int, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.W_x = nn.Sequential(Conv(f_int, f_x, 1, generator, dtype=dtype))
        self.W_g = nn.Sequential(Conv(f_int, f_g, 1, generator, dtype=dtype))
        self.psi = nn.Sequential(Conv(1, f_int, 1, generator, dtype=dtype))

    def forward(self, g, x, norm=instance_norm, psi=conv1d):
        """g: gating signal (decoder), x: skip activation (encoder); ``norm``
        the instance norm (the continuous modes pass theirs) and ``psi(h, w,
        b)`` the ψ conv (the tensor-parallel forward passes its own)."""
        wg, wx, wp = self.W_g[0], self.W_x[0], self.psi[0]
        g1 = norm(conv1d(g, wg.weight, wg.bias))
        x1 = norm(conv1d(x, wx.weight, wx.bias))
        return x * sigmoid(norm(psi(relu(g1 + x1), wp.weight, wp.bias)))
