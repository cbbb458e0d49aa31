"""The published generator and critic (github.com/jwang6174/scg-rhc-waveform,
waveform_train.py:16-246) as plain functions of a dict of weights.

Generator: a 1-D attention U-Net.  Encoder double-conv blocks 64, 128, 256
and a 512 bottleneck, each ``2 x (conv k3 p1 -> instance norm -> relu)``,
with a max pool (k3 s1) and dropout 0.3 before each block past the first;
the decoder upsamples with ConvTranspose1d (k3 s1), drops out, gates the
skip with an additive attention gate (1x1 convs, instance norms, relu,
sigmoid) and runs a double-conv block on the concatenation; a final 1x1
conv gives one channel.  Critic: five conv k3 p1 layers
(C+1) -> 64 -> 128 -> 256 -> 512 -> 1: relu, three instance norm + relu,
and a linear score map.  Instance norms are affine-free with eps 1e-5 and
the biased variance, computed here in float64 by two passes, whatever the
dtype of the activations.

Weights are keyed by the reference's state-dict names (``enc1.0.weight``,
``att3.W_x.0.weight``, ``up3.weight``, ``model.5.bias``...).
:func:`generator_shapes` and :func:`critic_shapes` give every weight's
shape and fan-in in that order.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

IN_EPS = 1e-5
DROPOUT = 0.3
NDF = 64
BLOCKS = (("enc1", None, 64), ("enc2", 64, 128), ("enc3", 128, 256),
          ("bottleneck", 256, 512), ("dec3", 512, 256), ("dec2", 256, 128),
          ("dec1", 128, 64))
GATES = (("att3", 256, 256, 128), ("att2", 128, 128, 64), ("att1", 64, 64, 32))
UPS = (("up3", 512, 256), ("up2", 256, 128), ("up1", 128, 64))
CRITIC_IDX = (0, 2, 5, 8, 11)
CRITIC_MODES = ("relu", "in_relu", "in_relu", "in_relu", "linear")


def generator_shapes(in_channels: int) -> list[tuple[str, tuple[int, ...], int]]:
    """(name, shape, fan_in) of every generator weight, in registration order."""
    out = []

    def conv(name, cout, cin, k):
        out.append((f"{name}.weight", (cout, cin, k), cin * k))
        out.append((f"{name}.bias", (cout,), cin * k))

    for name, cin, cout in BLOCKS:
        conv(f"{name}.0", cout, in_channels if cin is None else cin, 3)
        conv(f"{name}.3", cout, cout, 3)
    for name, f_x, f_g, f_int in GATES:
        conv(f"{name}.W_x.0", f_int, f_x, 1)
        conv(f"{name}.W_g.0", f_int, f_g, 1)
        conv(f"{name}.psi.0", 1, f_int, 1)
    for name, cin, cout in UPS:  # ConvTranspose1d: weight (in, out, k), fan-in out * k
        out.append((f"{name}.weight", (cin, cout, 3), cout * 3))
        out.append((f"{name}.bias", (cout,), cout * 3))
    conv("final", 1, 64, 1)
    return out


def critic_shapes(in_channels: int) -> list[tuple[str, tuple[int, ...], int]]:
    """(name, shape, fan_in) of every critic weight, in registration order."""
    widths = [in_channels + 1, NDF, NDF * 2, NDF * 4, NDF * 8, 1]
    out = []
    for i, idx in enumerate(CRITIC_IDX):
        fan = widths[i] * 3
        out.append((f"model.{idx}.weight", (widths[i + 1], widths[i], 3), fan))
        out.append((f"model.{idx}.bias", (widths[i + 1],), fan))
    return out


def instance_norm(x):
    """Affine-free instance norm over the last axis, in float64, two-pass."""
    x64 = x.double()
    mean = x64.mean(dim=-1, keepdim=True)
    var = ((x64 - mean) ** 2).mean(dim=-1, keepdim=True)
    return ((x64 - mean) / torch.sqrt(var + IN_EPS)).to(x.dtype)


def dropout(x, rng):
    """Inverted dropout whose mask is ``U[0, 1) < 0.7``, drawn from ``rng`` at
    x's shape in float32."""
    keep = 1.0 - DROPOUT
    mask = torch.rand(x.shape, generator=rng, device=x.device) < keep
    return torch.where(mask, x / keep, torch.zeros((), dtype=x.dtype, device=x.device))


def _double_conv(p, name, x):
    for i in (0, 3):
        w, b = p[f"{name}.{i}.weight"], p[f"{name}.{i}.bias"]
        x = torch.relu(instance_norm(F.conv1d(x, w, b, padding=1)))
    return x


def _gate(p, name, g, x):
    def conv(key, a):
        return F.conv1d(a, p[f"{name}.{key}.0.weight"], p[f"{name}.{key}.0.bias"])

    g1 = instance_norm(conv("W_g", g))
    x1 = instance_norm(conv("W_x", x))
    return x * torch.sigmoid(instance_norm(conv("psi", torch.relu(g1 + x1))))


def generator(p: dict, x, rng=None):
    """x (N, C, T) -> (N, 1, T).  ``rng`` (a ``torch.Generator`` on x's
    device) turns on the six dropouts, drawn in forward order."""

    def pool(a):
        return F.max_pool1d(a, kernel_size=3, stride=1)

    def drop(a):
        return a if rng is None else dropout(a, rng)

    e1 = _double_conv(p, "enc1", x)
    e2 = _double_conv(p, "enc2", drop(pool(e1)))
    e3 = _double_conv(p, "enc3", drop(pool(e2)))
    h = _double_conv(p, "bottleneck", drop(pool(e3)))
    for (up, _, _), (gate, *_), dec, skip in zip(UPS, GATES, ("dec3", "dec2", "dec1"),
                                                 (e3, e2, e1)):
        h = drop(F.conv_transpose1d(h, p[f"{up}.weight"], p[f"{up}.bias"]))
        if h.shape[-1] != skip.shape[-1]:
            raise ValueError(f"decoder length {h.shape[-1]} != skip length {skip.shape[-1]}")
        h = _double_conv(p, dec, torch.cat((h, _gate(p, gate, h, skip)), dim=1))
    return F.conv1d(h, p["final.weight"], p["final.bias"])


def critic(p: dict, x):
    """x (N, C + 1, T) -> (N, 1, T) patch scores."""
    h = x
    for idx, mode in zip(CRITIC_IDX, CRITIC_MODES):
        h = F.conv1d(h, p[f"model.{idx}.weight"], p[f"model.{idx}.bias"], padding=1)
        if mode == "relu":
            h = torch.relu(h)
        elif mode == "in_relu":
            h = torch.relu(instance_norm(h))
    return h
