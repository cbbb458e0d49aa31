"""int8 generator inference (``dtype: "int8"``), the PyTorch counterpart of
``scgrhc.models.quant``.

An inference-only post-training quantization of the U-Net body: the 14
double-conv convs and the 3 upsampling convs (pre-lowered to ordinary
convs: kernel flipped, channel axes swapped, padding K − 1) take int8
weights with symmetric per-output-channel float32 scales, and int8
activations with one symmetric float32 scale per tensor.  Each product is
int8 × int8 with int32 sums, dequantized with ``sx · ws`` and given its
float32 bias.  The attention gates, the final 1×1 conv and every instance
norm stay float32.  Every quantized conv is followed by an instance norm,
which takes out any per-channel scale error of the weights.

The product is :func:`int8_conv`: the three taps as one int8 matrix
product (``torch._int_mm``, exact int32 sums; cuBLASLt's int8 tensor-core
path on the card).  The JAX package computes it with XLA's integer
convolution outside any Pallas kernel, so there is no TPU kernel to port
here.  A float32 convolution over the int8 values is not the same
function: its sums are exact only below 2^24, and a 512-channel k3 layer
reaches 1536 · 127².

The activation scale spans a whole tensor, so one window's output depends
on the other windows of its batch: callers chunk as the JAX package does
(``eval_batch`` in evaluation).  When the ranks of a data mesh split a
chunk, :meth:`QuantGenerator.sharded` makes each scale the max over the
chunk's real windows on every rank (the caller's max-reduction, one
``all_reduce(MAX)`` for each of the 17 scales), so each window's output is
that of one process; the pad windows that round a chunk up to the mesh
take no part in it.

Rounding is half to even on both sides (``torch.round``, ``jnp.round``)
after the same float32 division, so the int8 values match the JAX
package's bit for bit.
"""

from __future__ import annotations

import contextlib
import copy

import torch
import torch.nn.functional as F
from torch import nn

from scgrhc_torch.models.generator import BLOCKS, _pad_size
from scgrhc_torch.ops.nn import conv1d, instance_norm, max_pool1d_k3s1

Q = 127.0
EPS = 1e-12
# torch._int_mm on CUDA takes more than 16 rows, and inner and column
# counts that are multiples of 8; zero rows and columns are exact padding.
MIN_ROWS, ALIGN = 17, 8


def quantize_weight(w):
    """(O, I, K) float32 → int8 weights and per-output-channel float32
    scales ``max|w| / 127`` (at least 1e-12)."""
    s = torch.clamp_min(w.abs().amax(dim=(1, 2)) / Q, EPS)
    wq = torch.clamp(torch.round(w / s[:, None, None]), -Q, Q).to(torch.int8)
    return wq, s


def act_scale(x):
    """The symmetric per-tensor scale of x: ``max|x| / 127`` (at least
    1e-12), a float32 scalar tensor."""
    return torch.clamp_min(x.abs().amax() / Q, EPS)


def _same(t):
    return t


def quantize_act(x, s=None):
    """float32 x → (int8 x, its float32 scale), at scale ``s`` or x's own."""
    s = act_scale(x) if s is None else s
    return torch.clamp(torch.round(x / s), -Q, Q).to(torch.int8), s


def _pad_to(a, dim: int, size: int):
    extra = size - a.shape[dim]
    if extra <= 0:
        return a
    pad = [0, 0] * (a.dim() - 1 - dim) + [0, extra]
    return F.pad(a, pad)


def int8_conv(xq, wq, padding: int):
    """conv1d(xq, wq, padding) with exact int32 sums: xq (N, C, T) int8, wq
    (O, C, K) int8 → (N, O, T + 2·padding − K + 1) int32.  The K taps
    become one (N·T', C·K) × (C·K, O) int8 matrix product."""
    n, c, t = xq.shape
    o, _, k = wq.shape
    tout = t + 2 * padding - k + 1
    cols = F.pad(xq, (padding, padding)).unfold(2, k, 1)  # (N, C, T', K)
    a = cols.permute(0, 2, 1, 3).reshape(n * tout, c * k)
    b = wq.reshape(o, c * k)
    inner = -(-(c * k) // ALIGN) * ALIGN
    a = _pad_to(_pad_to(a, 1, inner), 0, MIN_ROWS)
    b = _pad_to(_pad_to(b, 1, inner), 0, -(-o // ALIGN) * ALIGN)
    y = torch._int_mm(a, b.t())[: n * tout, :o]
    return y.reshape(n, tout, o).transpose(1, 2).contiguous()


class QConv(nn.Module):
    """One quantized conv: int8 weights ``wq`` (O, I, K), their float32
    scales ``ws`` (O,), the float32 bias ``b`` (O,), and its padding."""

    def __init__(self, w, b, padding: int):
        super().__init__()
        wq, ws = quantize_weight(w.detach().float())
        self.register_buffer("wq", wq)
        self.register_buffer("ws", ws)
        self.register_buffer("b", b.detach().float().clone())
        self.padding = padding

    def forward(self, xq, sx):
        """(int8 x, its scale) → float32 ``int8_conv · sx · ws + b``."""
        y = int8_conv(xq, self.wq, self.padding)
        return y.float() * (sx * self.ws)[None, :, None] + self.b[None, :, None]


class QuantGenerator(nn.Module):
    """The quantized inference generator (``Generator.cast(torch.int8)``):
    x (N, C, T) → (N, 1, T) float32, as ``Generator.forward`` in eval mode
    (reference: waveform_train.py:175-195).  Weights are buffers, copied
    and quantized from ``gen``, which is left as it was."""

    def __init__(self, gen):
        super().__init__()
        for name, _, _ in BLOCKS:
            self.add_module(name, nn.ModuleList(
                QConv(conv.weight, conv.bias, 1) for conv in getattr(gen, name).convs))
        for name in ("up3", "up2", "up1"):
            up = getattr(gen, name)  # weight (I, O, K) → its ordinary conv (O, I, K)
            self.add_module(name, QConv(up.weight.detach().float().flip(-1).transpose(0, 1),
                                        up.bias, up.weight.shape[-1] - 1))
        for name in ("att3", "att2", "att1", "final"):
            self.add_module(name, copy.deepcopy(getattr(gen, name)).float())
        self.in_channels = gen.in_channels
        self._rows, self._reduce_max = None, _same  # set by sharded()

    @contextlib.contextmanager
    def sharded(self, rows: int, reduce_max):
        """Within the block, this rank holds a block of a chunk split over
        the ranks, whose first ``rows`` windows are real, and
        ``reduce_max(t)`` is the max of a tensor over the ranks: each
        activation scale is that of the real windows of every rank."""
        self._rows, self._reduce_max = rows, reduce_max
        try:
            yield self
        finally:
            self._rows, self._reduce_max = None, _same

    def _scale(self, x):
        """:func:`act_scale` of x's real windows (all of them outside
        :meth:`sharded`), max-reduced over the ranks.  The max of the ranks'
        scales is the scale of their max: x ↦ max(x / 127, 1e-12) is
        monotone."""
        real = x[:self._rows]
        return self._reduce_max(act_scale(real) if len(real) else x.new_tensor(EPS))

    def _quantize(self, x):
        return quantize_act(x, self._scale(x))

    def _block(self, convs, x):
        """2 × (int8 conv k3 p1 → instance norm → relu); x float32 or an
        already quantized (int8 x, scale) pair; float32 out."""
        xq, sx = x if isinstance(x, tuple) else self._quantize(x)
        h = torch.relu(instance_norm(convs[0](xq, sx)))
        return torch.relu(instance_norm(convs[1](*self._quantize(h))))

    def _pool(self, x):
        """Max pool, then quantize at the unpooled tensor's scale: rounding
        and clipping are monotone and x ≥ 0 after the relu, so this is the
        JAX package's quantize-then-pool, bit for bit."""
        return quantize_act(max_pool1d_k3s1(x), self._scale(x))

    def forward(self, x, rng=None, train: bool = False):
        """``train`` raises: dropout would be an eval-mode identity here."""
        if train:
            raise ValueError("int8 quantized generator is inference-only")
        x = x.float()
        e1 = self._block(self.enc1, x)
        e2 = self._block(self.enc2, self._pool(e1))
        e3 = self._block(self.enc3, self._pool(e2))
        d = self._block(self.bottleneck, self._pool(e3))
        for up, att, dec, skip in ((self.up3, self.att3, self.dec3, e3),
                                   (self.up2, self.att2, self.dec2, e2),
                                   (self.up1, self.att1, self.dec1, e1)):
            d = _pad_size(up(*self._quantize(d)), skip)
            d = self._block(dec, torch.cat((d, att(d, skip)), dim=1))
        return _pad_size(conv1d(d, self.final.weight, self.final.bias), x)
