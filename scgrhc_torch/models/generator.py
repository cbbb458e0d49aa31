"""1-D attention U-Net generator (SCG channels → RHC pressure waveform), the
PyTorch counterpart of ``scgrhc.models.generator`` (reference:
waveform_train.py:67-195).

Encoder 64→128→256, bottleneck 512, decoder with attention-gated skip
concatenation, ConvTranspose upsampling (k3 s1, L→L+2), MaxPool
downsampling (k3 s1, L→L-2), dropout 0.3 after every pool and every
upsampling in train mode, and a final 1x1 conv to one channel.

The double-conv blocks run through
:class:`scgrhc_torch.ops.kernels.conv_block.ConvInReLU` (K1f forward, K1b
backward), whose kernels take their plain versions for tensors on the
CPU.  ``block=plain_block`` runs the same weights through the plain
version on any device.  Dropout goes through the module-level name
``dropout``, looked up at call time, so a test can inject masks.

State-dict keys are the reference's (``enc1.0.weight``, ``enc1.3.bias``,
``att3.W_x.0.weight``, ``up3.weight``, ``final.bias``), registered in the
reference's parameter order, so a reference or ``scgrhc`` checkpoint's
``g_state_dict`` loads through ``load_state_dict``.

Quirk parity: ``_pad_size(A, B)``'s shorter branch pads and returns **B**
(reference: waveform_train.py:165-173); dead at the pipeline's 750-sample
windows, kept for identical semantics.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from scgrhc_torch.models.attention import AttentionGate, Conv
from scgrhc_torch.ops.kernels.conv_block import ConvInReLU, conv_in_relu_plain
from scgrhc_torch.ops.nn import conv1d, conv_transpose1d, dropout, max_pool1d_k3s1

DROPOUT_RATE = 0.3  # reference: waveform_train.py:117

# (name, in, out) for the double-conv blocks, in forward order.
BLOCKS = (
    ("enc1", None, 64),  # in filled from in_channels
    ("enc2", 64, 128),
    ("enc3", 128, 256),
    ("bottleneck", 256, 512),
    ("dec3", 512, 256),
    ("dec2", 256, 128),
    ("dec1", 128, 64),
)


class DoubleConv(nn.Module):
    """2 × (conv k3 p1 → instance norm → relu) (reference:
    waveform_train.py:119-141); its convs sit at the reference's
    ``nn.Sequential`` indices 0 and 3."""

    def __init__(self, in_ch: int, out_ch: int, generator: torch.Generator,
                 dtype=torch.float32):
        super().__init__()
        self.add_module("0", Conv(out_ch, in_ch, 3, generator, dtype=dtype))
        self.add_module("3", Conv(out_ch, out_ch, 3, generator, dtype=dtype))

    @property
    def convs(self) -> tuple[Conv, Conv]:
        return self._modules["0"], self._modules["3"]


def fused_block(blk: DoubleConv, x):
    """The double-conv block through :class:`ConvInReLU` (two K1f launches
    forward, two K1b backward)."""
    for conv in blk.convs:
        x = ConvInReLU.apply(x, conv.weight, conv.bias)
    return x


def plain_block(blk: DoubleConv, x):
    """The same block through K1f's plain version."""
    for conv in blk.convs:
        x = conv_in_relu_plain(x, conv.weight, conv.bias)
    return x


def _pad_size(a, b):
    """Reference size-reconciler incl. its shorter-branch quirk
    (waveform_train.py:165-173)."""
    la, lb = a.shape[-1], b.shape[-1]
    if la > lb:
        return a[..., :lb]
    if la < lb:
        return F.pad(b, (0, lb - la))
    return a


class Generator(nn.Module):
    """x (N, C, T) SCG → (N, 1, T) normalized RHC.

    ``generator`` is a CPU ``torch.Generator`` for the initial weights
    (PyTorch's default conv init); ``None`` seeds one with 0."""

    def __init__(self, in_channels: int, generator: torch.Generator | None = None,
                 dtype=torch.float32, device=None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        for name, cin, cout in BLOCKS:
            cin = in_channels if cin is None else cin
            self.add_module(name, DoubleConv(cin, cout, generator, dtype=dtype))
        self.att3 = AttentionGate(256, 256, 128, generator, dtype=dtype)
        self.att2 = AttentionGate(128, 128, 64, generator, dtype=dtype)
        self.att1 = AttentionGate(64, 64, 32, generator, dtype=dtype)
        self.up3 = Conv(256, 512, 3, generator, transpose=True, dtype=dtype)
        self.up2 = Conv(128, 256, 3, generator, transpose=True, dtype=dtype)
        self.up1 = Conv(64, 128, 3, generator, transpose=True, dtype=dtype)
        self.final = Conv(1, 64, 1, generator, dtype=dtype)
        self.in_channels = in_channels
        if device is not None:
            self.to(device)

    @property
    def dtype(self) -> torch.dtype:
        """The compute dtype: that of the double-conv weights."""
        return self.enc1.convs[0].weight.dtype

    def cast(self, dtype) -> "Generator":
        """Cast every weight for reduced-precision compute EXCEPT ``final``,
        which keeps its dtype, so the output epilogue runs at its own
        precision (``scgrhc.models.generator.cast_params``).  In place;
        returns self.  The int8 inference tree is not ported."""
        if dtype == torch.int8:
            raise NotImplementedError("int8 generator inference is not yet ported")
        for name, child in self.named_children():
            if name != "final":
                child.to(dtype)
        return self

    def encode(self, x, block=fused_block, drop=lambda a: a):
        """Encoder half: enc1..enc3 + bottleneck (reference:
        waveform_train.py:175-181).  Returns the skips and the bottleneck."""
        e1 = block(self.enc1, x)
        e2 = block(self.enc2, drop(max_pool1d_k3s1(e1)))
        e3 = block(self.enc3, drop(max_pool1d_k3s1(e2)))
        b = block(self.bottleneck, drop(max_pool1d_k3s1(e3)))
        return e1, e2, e3, b

    def decode(self, x, e1, e2, e3, b, block=fused_block, drop=lambda a: a):
        """Decoder half: up/attention/dec ×3 + final 1×1 conv (reference:
        waveform_train.py:183-195).  ``x`` is only consulted for the
        output length reconciliation quirk (``_pad_size(f, x)``)."""
        d = b
        for up, att, dec, skip in (
            (self.up3, self.att3, self.dec3, e3),
            (self.up2, self.att2, self.dec2, e2),
            (self.up1, self.att1, self.dec1, e1),
        ):
            d = _pad_size(drop(conv_transpose1d(d, up.weight, up.bias)), skip)
            a = att(d, skip)
            d = block(dec, torch.cat((d, a), dim=1))
        # output epilogue in the final weights' own dtype (f32 under a
        # bf16 cast: full-precision predictions)
        fw, fb = self.final.weight, self.final.bias
        return _pad_size(conv1d(d.to(fw.dtype), fw, fb), x)

    def forward(self, x, block=fused_block, rng: torch.Generator | None = None,
                train: bool = False):
        """``train`` applies dropout at its six sites, drawing from ``rng``
        (a generator on x's device), in forward order."""

        def drop(a):
            return dropout(a, DROPOUT_RATE, rng, train)

        x = x.to(self.dtype)
        e1, e2, e3, b = self.encode(x, block, drop)
        return self.decode(x, e1, e2, e3, b, block, drop)
