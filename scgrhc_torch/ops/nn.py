"""Functional neural-net primitives (NCH layout), the PyTorch counterpart of
``scgrhc.ops.nn``.

Weight layouts are PyTorch's own, as in the JAX package, so checkpoints
carry over by relabeling alone:

  * ``conv1d``            weight (O, I, K), bias (O,)   — ``nn.Conv1d``
  * ``conv_transpose1d``  weight (I, O, K), bias (O,)   — ``nn.ConvTranspose1d``
  * ``instance_norm``     affine-free, eps 1e-5, biased variance, ONE-PASS
                          statistics (E[x²]−mean², clamped at 0) — the form
                          ``scgrhc.ops.nn.instance_norm`` uses; the two-pass
                          ``nn.InstanceNorm1d`` differs in f32
  * ``max_pool1d_k3s1``   kernel 3, stride 1 (L → L-2)
  * ``dropout``           inverted dropout, train-only, drawing from an
                          explicit ``torch.Generator``

These are plain PyTorch: the JAX package runs them outside Pallas too.
The bias is added after the convolution, in the output dtype, as the JAX
package does.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

IN_EPS = 1e-5  # torch InstanceNorm1d default


def conv1d(x, w, b=None, padding: int = 0):
    """(N, C, L) ⊛ (O, C, K) → (N, O, L'), cross-correlation."""
    out = F.conv1d(x, w, padding=padding)
    if b is not None:
        out = out + b.to(out.dtype)[None, :, None]
    return out.to(x.dtype)


def conv_transpose1d(x, w, b=None):
    """``nn.ConvTranspose1d(kernel_size=K, stride=1, padding=0)``, weight
    (I, O, K): L → L + K - 1."""
    out = F.conv_transpose1d(x, w)
    if b is not None:
        out = out + b.to(out.dtype)[None, :, None]
    return out.to(x.dtype)


def stats_dtype(dtype: torch.dtype) -> torch.dtype:
    """Instance-norm statistics run in f32, or f64 for f64 input."""
    return torch.float64 if dtype == torch.float64 else torch.float32


def instance_norm(x, eps: float = IN_EPS):
    """Per-(sample, channel) normalization over time, no affine parameters,
    with one-pass biased statistics in f32 (f64 for f64 input)."""
    x32 = x.to(stats_dtype(x.dtype))
    mean = x32.mean(dim=-1, keepdim=True)
    msq = (x32 * x32).mean(dim=-1, keepdim=True)
    var = torch.clamp_min(msq - mean * mean, 0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def instance_norm_global(x, reduce=None, eps: float = IN_EPS):
    """:func:`instance_norm` over the whole record when x is this rank's
    block of a record split along time
    (``scgrhc.models.cp._instance_norm_global``): each rank's one-pass sums
    and step count in one buffer, ``reduce(buf)`` its sum over the ranks,
    mean = s / n and the variance E[x²] − mean² clamped at 0.  ``reduce``
    None: x is the whole record, and nothing is reduced (the same
    arithmetic)."""
    x32 = x.to(stats_dtype(x.dtype))
    s = x32.sum(dim=-1)
    buf = torch.cat((s.reshape(-1), (x32 * x32).sum(dim=-1).reshape(-1),
                     s.new_full((1,), x.shape[-1])))
    if reduce is not None:
        buf = reduce(buf)
    s, ss, n = buf[:s.numel()], buf[s.numel():-1], buf[-1]
    mean = (s / n).reshape(*x.shape[:-1], 1)
    var = torch.clamp_min((ss / n).reshape(mean.shape) - mean * mean, 0.0)
    return ((x32 - mean) * torch.rsqrt(var + eps)).to(x.dtype)


def max_pool1d_k3s1(x):
    """kernel 3, stride 1; ceil_mode is a no-op at stride 1 → L-2."""
    return F.max_pool1d(x, kernel_size=3, stride=1)


def dropout(x, rate: float, rng: torch.Generator | None, train: bool):
    """Inverted dropout (``nn.Dropout``): keeps each element with
    probability 1 - rate and scales it by 1 / (1 - rate); the identity
    when not training.  The mask is drawn from ``rng``, a generator on x's
    device."""
    if not train or rate == 0.0:
        return x
    keep = 1.0 - rate
    mask = rand(x.shape, rng, x.device) < keep
    return torch.where(mask, x / keep, 0.0)


def rand(shape, rng, device, dtype=None):
    """U[0, 1) draws of ``shape`` from ``rng``: a ``torch.Generator`` (or
    None), or a draw function ``rng(shape, device, dtype)`` that a caller
    passes to make the draws its own way."""
    if callable(rng):
        return rng(shape, device, dtype)
    return torch.rand(shape, generator=rng, device=device, dtype=dtype)


def relu(x):
    return torch.relu(x)


def sigmoid(x):
    return torch.sigmoid(x)


def conv_init(generator: torch.Generator, out_ch: int, in_ch: int, k: int,
              transpose: bool = False, dtype=torch.float32):
    """PyTorch's Conv1d/ConvTranspose1d default init: U(±1/√fan_in) for
    weight and bias, fan_in = in_ch·k (out_ch·k for a transposed conv).

    ``generator`` is a CPU ``torch.Generator``; the draws land on the CPU
    and the caller moves them.  Returns ``(weight, bias)``."""
    if transpose:
        shape = (in_ch, out_ch, k)
        fan_in = out_ch * k
    else:
        shape = (out_ch, in_ch, k)
        fan_in = in_ch * k
    bound = 1.0 / math.sqrt(fan_in)

    def uniform(size):
        u = torch.rand(size, generator=generator, dtype=torch.float32)
        return ((u * 2.0 - 1.0) * bound).to(dtype)

    return uniform(shape), uniform((out_ch,))
