"""K1f and K1b: fused ``relu(instance_norm(conv1d(x, w, b, padding=1)))``,
forward and backward, and :class:`ConvInReLU`, the autograd Function that
joins them.

Replaces the TPU kernel ``scgrhc/ops/pallas/conv_block.py::conv_in_relu``:
K1f its ``_fwd_kernel``, K1b its ``_bwd_kernel`` (the custom_vjp's
``_cir_bwd``).  The CUDA source is the layer's,
``scgrhc_torch/csrc/conv_layer.cu`` over ``conv3.cuh``: K1f and K1b are
its entry points in the ``in_relu`` mode, launched through
:func:`.conv3.launch_fwd` and :func:`.conv3.launch_bwd` as the critic's
layer is: the conv on the tensor-core core (f32 on Hopper's warpgroup
MMA, from weights split into a scratch once a launch), c through an f32
scratch (N, O, T) and a row pass for the instance norm.  Its header says
what bounds both on the H100 (operations, on the tensor cores) and why c
may round-trip through device memory.  The plain versions are :mod:`.conv3`'s in the
``in_relu`` mode; the wrappers take them on the CPU only.

The layer is first-order only, like the TPU kernel: the generator is never
under a second-order gradient.

Time-sharded, over a record split along time (``models.cp.apply_cp``), a
row's instance-norm statistics span every rank's block, so K1f runs in two
phases with a cross-rank sum between them, which ``models.cp`` makes:
:func:`conv_in_relu_part` takes the block with its neighbours' edge
columns and gives the f32 c and each row's (sum, sum of squares), and
:func:`conv_in_relu_apply` normalizes with the summed pairs and the
record's length.  ``scgrhc`` runs the same layer as an XLA conv and
``_instance_norm_global`` (``scgrhc/models/cp.py:93-108``).
"""

from __future__ import annotations

import torch

from scgrhc_torch.ops.kernels import _build, conv3
from scgrhc_torch.ops.nn import IN_EPS


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
    y = conv3.launch_fwd("conv_in_relu", x, w, b, "in_relu")
    conv_in_relu.launches += 1
    return y


def conv_in_relu_bwd(x, w, b, dy, need_dx: bool = True):
    """K1b: :func:`conv_in_relu_bwd_plain` on the CPU; on CUDA one kernel
    launch (its dc, dx and dw/db passes), dx skipped unless ``need_dx``."""
    if conv3.on_cpu(x, "conv_in_relu_bwd"):
        return conv_in_relu_bwd_plain(x, w, b, dy, need_dx)
    out = conv3.launch_bwd("conv_in_relu_bwd", x, w, b, dy, "in_relu", need_dx, True)
    conv_in_relu_bwd.launches += 1
    return out


def conv_in_relu_part_plain(xh, w, b):
    """The first phase's plain version: ``(c, sums)`` with c = conv1d(xh, w,
    padding=1) + b in f32 (f64 for f64 input) over the halo'd block xh
    (N, C_in, len + 2), (N, O, len + 2), and sums (N·O, 2) each row's
    (sum, sum of squares) over c's columns 1 .. len."""
    c = conv3.conv(xh, w, b)
    ci = c[..., 1:-1]
    return c, torch.stack((ci.sum(-1), (ci * ci).sum(-1)), -1).reshape(-1, 2)


def conv_in_relu_apply_plain(c, sums, count: int, dtype):
    """The second phase's plain version: relu((c − mean)·rsqrt(var + eps))
    over c's columns 1 .. len, with mean = s / count and var = max(q / count
    − mean², 0) from each row's sums, cast to ``dtype``."""
    ci = c[..., 1:-1]
    s, q = sums.reshape(*ci.shape[:2], 2).unbind(-1)
    mean = (s / count)[..., None]
    var = torch.clamp_min(q[..., None] / count - mean * mean, 0.0)
    return torch.relu((ci - mean) * torch.rsqrt(var + IN_EPS)).to(dtype)


def conv_in_relu_part(xh, w, b):
    """K1f's first phase: xh (N, C_in, len + 2), the block with its
    neighbours' edge columns (zeros at the record's ends) → ``(c, sums)``
    as :func:`conv_in_relu_part_plain` gives them: c the f32 scratch that
    the second phase reads, sums (N·O, 2) f32.  The plain version on the
    CPU; one launch on CUDA."""
    if conv3.on_cpu(xh, "conv_in_relu_part"):
        return conv_in_relu_part_plain(xh, w, b)
    conv3.check_inputs("conv_in_relu_part", xh, w, b)
    n, cin, lh = xh.shape
    o, length = w.shape[0], lh - 2
    if length < 1:
        raise ValueError(f"conv_in_relu_part takes a block of >= 1 step and its 2 halo "
                         f"columns, got {lh} columns")
    f32 = dict(dtype=torch.float32, device=xh.device)
    c = torch.empty((n, o, lh), **f32)
    part = torch.empty((n * o * -(-length // conv3.ROW_PIECE), 2), **f32)
    sums = torch.empty((n * o, 2), **f32)
    plan = conv3.conv_plan(n, cin, o, lh, "in_relu", "fwd", xh.dtype)
    ws = torch.empty(conv3.wsplit_numel(cin, o), **f32) if plan.path == "wgmma" else None
    with torch.cuda.device(xh.device):
        err = _build.library().scgrhc_conv_in_relu_part(
            xh.data_ptr(), w.data_ptr(), b.data_ptr(), c.data_ptr(), part.data_ptr(),
            sums.data_ptr(), None if ws is None else ws.data_ptr(), n, cin, o, length,
            conv3.DTYPE_CODE[xh.dtype], conv3._stream(xh))
    _build.check(err, "conv_in_relu_part")
    conv3.count_launches(plan, n)
    conv_in_relu_part.launches += 1
    return c, sums


def conv_in_relu_apply(c, sums, count: int, dtype):
    """K1f's second phase: ``(c, sums)`` of :func:`conv_in_relu_part`, the
    sums added over the ranks, and the record's length ``count`` → y (N, O,
    len) in ``dtype``.  The plain version on the CPU; one launch on CUDA."""
    if conv3.on_cpu(c, "conv_in_relu_apply"):
        return conv_in_relu_apply_plain(c, sums, count, dtype)
    n, o, lh = c.shape
    if (c.dtype != torch.float32 or sums.dtype != torch.float32 or sums.shape != (n * o, 2)
            or not (c.is_contiguous() and sums.is_contiguous()) or sums.device != c.device
            or dtype not in conv3.DTYPE_CODE or not lh - 2 <= count < 2 ** 31):
        raise ValueError(f"conv_in_relu_apply takes conv_in_relu_part's f32 c and sums, a "
                         f"count >= the block's length and a float32 or bfloat16 output; got c "
                         f"{c.dtype} {tuple(c.shape)}, sums {sums.dtype} {tuple(sums.shape)}, "
                         f"count {count}, {dtype}")
    y = torch.empty((n, o, lh - 2), dtype=dtype, device=c.device)
    with torch.cuda.device(c.device):
        err = _build.library().scgrhc_conv_in_relu_apply(
            c.data_ptr(), sums.data_ptr(), y.data_ptr(), n, o, lh - 2, count,
            conv3.DTYPE_CODE[dtype], conv3._stream(c))
    _build.check(err, "conv_in_relu_apply")
    conv_in_relu_apply.launches += 1
    return y


conv_in_relu.launches = 0
conv_in_relu_bwd.launches = 0
conv_in_relu_part.launches = 0
conv_in_relu_apply.launches = 0


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
