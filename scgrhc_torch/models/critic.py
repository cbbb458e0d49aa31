"""Conditional PatchGAN critic over channel-concatenated [SCG ‖ RHC], the
PyTorch counterpart of ``scgrhc.models.critic`` (reference:
waveform_train.py:198-246).

Five conv k3 s1 p1 layers (C+1)→64→128→256→512→1: ``relu`` after the
first (no norm), ``in_relu`` after the three hidden ones, ``linear`` at
the score (no sigmoid: a WGAN critic), giving a per-position score map
(N, 1, T).  Every layer runs through
:func:`scgrhc_torch.ops.kernels.critic_fused.fused_layer` (K2f forward,
K2dx/K2dw backward, twice differentiable); ``layer=critic_layer_plain``
runs the same weights through the plain version.

With ``ct``, the forward also returns the scores' input gradient, built
in the forward direction from each layer's input gradient (K2dx, or the
plain version's) rather than by a ``create_graph`` backward.  The
gradient penalty differentiates it, and so its whole graph is recorded by
the calling thread: nodes that a ``create_graph`` backward records come
from the autograd engine's CUDA worker thread, whose sequence numbers set
the order in which the parameter gradient sums its terms, and that order
then differs between a process's first steps and its later ones.

State-dict keys are the reference ``nn.Sequential``'s
(``model.{0,2,5,8,11}.{weight,bias}``), registered in that order, so the
Adam state ids of a reference or ``scgrhc`` checkpoint line up.
"""

from __future__ import annotations

import torch
from torch import nn

from scgrhc_torch.models.attention import Conv
from scgrhc_torch.ops.kernels.critic_fused import (
    critic_layer_bwd_dx_plain,
    critic_layer_plain,
    fused_layer,
    fused_layer_bwd_dx,
)

NDF = 64  # reference: waveform_train.py:224
SEQ_IDX = (0, 2, 5, 8, 11)  # the convs' indices in the reference nn.Sequential
LAYER_MODES = ("relu", "in_relu", "in_relu", "in_relu", "linear")
# each layer function's twice-differentiable input gradient
INPUT_GRAD = {fused_layer: fused_layer_bwd_dx, critic_layer_plain: critic_layer_bwd_dx_plain}


class Critic(nn.Module):
    """x (N, C_scg + 1, T) → (N, 1, T) patch scores.  ``generator`` is a CPU
    ``torch.Generator`` for the initial weights (PyTorch's default conv
    init, U(±1/√fan_in)); ``None`` seeds one with 0."""

    def __init__(self, in_channels: int, generator: torch.Generator | None = None,
                 condition_channels: int = 1, ndf: int = NDF, dtype=torch.float32,
                 device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        widths = [in_channels + condition_channels, ndf, ndf * 2, ndf * 4, ndf * 8, 1]
        self.model = nn.ModuleDict({
            str(idx): Conv(widths[i + 1], widths[i], 3, generator, dtype=dtype)
            for i, idx in enumerate(SEQ_IDX)
        })
        if device is not None:
            self.to(device)

    def forward(self, x, layer=fused_layer, ct=None):
        """Scores; with ``ct`` (a cotangent of the scores' shape), the pair
        (scores, the gradient of ``<scores, ct>`` with respect to x)."""
        layers = list(zip(self.model.values(), LAYER_MODES))
        inputs, h = [], x
        for conv, mode in layers:
            inputs.append(h)
            h = layer(h, conv.weight, conv.bias, mode)
        if ct is None:
            return h
        g = ct
        for (conv, mode), h_in in zip(reversed(layers), reversed(inputs)):
            g = INPUT_GRAD[layer](h_in, conv.weight, conv.bias, g, mode)
        return h, g

