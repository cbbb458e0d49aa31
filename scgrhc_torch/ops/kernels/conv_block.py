"""K1f: fused ``relu(instance_norm(conv1d(x, w, b, padding=1)))``, forward.

Replaces the TPU kernel ``scgrhc/ops/pallas/conv_block.py::conv_in_relu``
(its ``_fwd_kernel``).  The CUDA source is ``scgrhc_torch/csrc/
conv_in_relu.cu``; its header says what bounds it on the H100
(operations: 6·C_in·O·T FLOPs per sample, on the f32 FMA units) and how
the design keeps a layer's intermediate out of device memory without the
TPU's whole-sample VMEM tile (one block per sample and 16 output
channels, conv sums in registers, input channels staged through shared
memory in chunks of 8).

Serving needs no gradient, so there is no ``autograd.Function`` yet; the
backward (TPU ``_bwd_kernel``) comes with the training slice.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from scgrhc_torch.ops.kernels import _build
from scgrhc_torch.ops.nn import instance_norm, stats_dtype

_DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1}


def conv_in_relu_plain(x, w, b):
    """The plain PyTorch version: conv in f32 (f64 for f64 input) on the
    upcast inputs, one-pass instance norm, relu, cast to x's dtype."""
    acc = stats_dtype(x.dtype)
    c = F.conv1d(x.to(acc), w.to(acc), padding=1) + b.to(acc)[None, :, None]
    return torch.relu(instance_norm(c)).to(x.dtype)


def conv_in_relu(x, w, b):
    """x (N, C_in, T), w (O, C_in, 3), b (O,) → (N, O, T) in x's dtype.

    A tensor on the CPU takes :func:`conv_in_relu_plain`.  A CUDA tensor
    launches the kernel, or raises on what the kernel does not take
    (dtype other than float32/bfloat16, mixed dtypes or devices, wrong
    shapes, non-contiguous tensors, T over the kernel's limit)."""
    if x.device.type == "cpu":
        return conv_in_relu_plain(x, w, b)
    if x.device.type != "cuda":
        raise ValueError(f"conv_in_relu: unsupported device {x.device}")
    if x.dtype not in _DTYPE_CODE or w.dtype != x.dtype or b.dtype != x.dtype:
        raise TypeError(
            "conv_in_relu kernel takes float32 or bfloat16 x, w, b of one dtype, "
            f"got {x.dtype}, {w.dtype}, {b.dtype}"
        )
    if x.dim() != 3 or w.dim() != 3 or b.dim() != 1:
        raise ValueError("conv_in_relu expects x (N, C_in, T), w (O, C_in, 3), b (O,)")
    n, cin, t = x.shape
    o = w.shape[0]
    if w.shape != (o, cin, 3) or b.shape != (o,):
        raise ValueError(
            f"conv_in_relu shape mismatch: x {tuple(x.shape)}, w {tuple(w.shape)}, "
            f"b {tuple(b.shape)}"
        )
    if not (x.is_contiguous() and w.is_contiguous() and b.is_contiguous()):
        raise ValueError("conv_in_relu kernel takes contiguous tensors")
    if w.device != x.device or b.device != x.device:
        raise ValueError("conv_in_relu: x, w and b must be on one device")
    lib = _build.library()
    max_len = lib.scgrhc_conv_in_relu_max_len()
    if not (1 <= n <= 65535 and 1 <= t <= max_len):
        raise ValueError(
            f"conv_in_relu kernel takes 1 <= N <= 65535 and 1 <= T <= {max_len}, "
            f"got N={n}, T={t}"
        )
    y = torch.empty((n, o, t), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        err = lib.scgrhc_conv_in_relu(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(),
            n, cin, o, t, _DTYPE_CODE[x.dtype],
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    _build.check(err, "conv_in_relu")
    conv_in_relu.launches += 1
    return y


conv_in_relu.launches = 0
