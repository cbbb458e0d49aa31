"""K1f and K1b: fused ``relu(instance_norm(conv1d(x, w, b, padding=1)))``,
forward and backward, and :class:`ConvInReLU`, the autograd Function that
joins them.

Replaces the TPU kernel ``scgrhc/ops/pallas/conv_block.py::conv_in_relu``:
K1f its ``_fwd_kernel``, K1b its ``_bwd_kernel`` (the custom_vjp's
``_cir_bwd``).  The CUDA source is ``scgrhc_torch/csrc/conv_in_relu.cu``
over ``conv3.cuh``; its header says what bounds both on the H100
(operations on the f32 FMA units) and how the design keeps the layer's
intermediate out of device memory.  The plain versions are
:mod:`.conv3`'s in the ``in_relu`` mode.

The layer is first-order only, like the TPU kernel: the generator is never
under a second-order gradient.
"""

from __future__ import annotations

import torch

from scgrhc_torch.ops.kernels import conv3


def conv_in_relu_plain(x, w, b):
    """The plain PyTorch forward: conv in f32 (f64 for f64 input) on the
    upcast inputs, one-pass instance norm, relu, cast to x's dtype."""
    return conv3.layer_plain(x, w, b, "in_relu")


def conv_in_relu_bwd_plain(x, w, b, dy, need_dx: bool = True):
    """The plain backward ``(dx, dw, db)`` at the output cotangent ``dy``:
    dx in x's dtype (None unless ``need_dx``), dw (O, C_in, 3) and db (O,)
    in f32, summed over samples."""
    return conv3.layer_bwd_plain(x, w, b, dy, "in_relu", need_dx=need_dx)


def conv_in_relu(x, w, b):
    """K1f: x (N, C_in, T), w (O, C_in, 3), b (O,) → (N, O, T) in x's dtype.

    A tensor on the CPU takes :func:`conv_in_relu_plain`.  A CUDA tensor
    launches the kernel, or raises on what the kernel does not take
    (:func:`.conv3.check_inputs`)."""
    if conv3.on_cpu(x, "conv_in_relu"):
        return conv_in_relu_plain(x, w, b)
    y = conv3.launch_fwd("scgrhc_conv_in_relu", "conv_in_relu", x, w, b)
    conv_in_relu.launches += 1
    return y


def conv_in_relu_bwd(x, w, b, dy, need_dx: bool = True):
    """K1b: :func:`conv_in_relu_bwd_plain` on the CPU; on CUDA one kernel
    launch (its dc, dx and dw/db passes), dx skipped unless ``need_dx``."""
    if conv3.on_cpu(x, "conv_in_relu_bwd"):
        return conv_in_relu_bwd_plain(x, w, b, dy, need_dx)
    out = conv3.launch_bwd("scgrhc_conv_in_relu_bwd", "conv_in_relu_bwd", x, w, b, dy,
                           None, need_dx, True)
    conv_in_relu_bwd.launches += 1
    return out


conv_in_relu.launches = 0
conv_in_relu_bwd.launches = 0


class ConvInReLU(torch.autograd.Function):
    """K1f forward, K1b backward.  No residual beyond the inputs is kept: the
    backward recomputes the conv, as the TPU kernel does.  dx is not
    computed for an input that needs no gradient (the generator's SCG
    input)."""

    @staticmethod
    def forward(ctx, x, w, b):
        ctx.save_for_backward(x, w, b)
        return conv_in_relu(x, w, b)

    @staticmethod
    def backward(ctx, dy):
        x, w, b = ctx.saved_tensors
        dx, dw, db = conv_in_relu_bwd(x, w, b, dy.contiguous(), ctx.needs_input_grad[0])
        return dx, dw.to(w.dtype), db.to(b.dtype)
