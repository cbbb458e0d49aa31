"""The yardstick's operation and byte counts, launch tables and peaks.

Operations are the convolutions' multiply-adds (2 per product), counted from
the layer shapes of :mod:`benchmark.reference.model`: one pass (a forward,
an input gradient or a weight gradient) of a conv of weight ``w`` over
``n`` sequences of length ``L`` is ``2 * n * L * |w|``, with ``L`` a
transposed conv's input length.  Instance norms, activations, pools and
Adam are not counted, so a rate from these counts is a floor of the work
done.  Bytes count each input of a launch read once and each output written
once, in float32.

The launch table lists the port's conv launches (K1f, K1b: the generator's
14 double-conv layers; K2f, K2dx, K2dw: the critic's 5 layers) that one
WGAN-GP step makes, with the shapes each runs at.
"""

from __future__ import annotations

from dataclasses import dataclass

from benchmark.reference import model

# NVIDIA H100 SXM data sheet, dense: TF32 495 TFLOP/s, of which the 3xTF32
# products that keep float32 get a third; HBM3 3.35 TB/s.
PEAK_FLOPS = 495e12 / 3
PEAK_BYTES = 3.35e12
F32 = 4

# the CUDA kernels of the port's conv core (scgrhc_torch/csrc/conv3.cuh),
# which every K1f, K1b, K2f, K2dx and K2dw launch runs, and nothing else
CONV_KERNELS = ("conv_mma_kernel", "conv_stream_kernel", "dx_stream_kernel", "dw_mma_kernel",
                "dw_stream_kernel", "dw_reduce_kernel", "db_kernel", "dc_linear_kernel",
                "row_kernel", "row_part_kernel", "row_sum_kernel", "row_apply_kernel")


def _generator_lengths(t: int) -> dict[str, int]:
    """The length each generator weight's layer runs at, for a T-sample window."""
    return {"enc1": t, "dec1": t, "att1": t, "final": t, "enc2": t - 2, "dec2": t - 2,
            "att2": t - 2, "up1": t - 2, "enc3": t - 4, "dec3": t - 4, "att3": t - 4,
            "up2": t - 4, "bottleneck": t - 6, "up3": t - 6}


def generator_pass_flops(in_channels: int, t: int, n: int = 1) -> float:
    """One pass of every generator conv over n windows of length t."""
    lengths = _generator_lengths(t)
    return sum(2.0 * n * lengths[name.split(".")[0]] * _numel(shape)
               for name, shape, _ in model.generator_shapes(in_channels)
               if name.endswith("weight"))


def critic_pass_flops(in_channels: int, t: int, n: int = 1) -> float:
    return sum(2.0 * n * t * _numel(shape) for name, shape, _ in model.critic_shapes(in_channels)
               if name.endswith("weight"))


def step_conv_flops(in_channels: int, b: int, t: int, n_critic: int) -> float:
    """The conv operations of one WGAN-GP step at batch b: the generator's
    n_critic + 1 forwards and one backward (2 passes); per critic update 3
    critic forwards, the penalty's input gradient (1 pass), the scored
    terms' backward (2 x 2) and the penalty's second order (4), 12 in all;
    and the generator update's critic forward (1)."""
    return ((n_critic + 3) * generator_pass_flops(in_channels, t, b)
            + (12 * n_critic + 1) * critic_pass_flops(in_channels, t, b))


def _numel(shape) -> int:
    out = 1
    for s in shape:
        out *= s
    return out


@dataclass(frozen=True)
class Launch:
    kind: str  # K1f, K1b, K2f, K2dx, K2dw
    n: int
    cin: int
    cout: int
    length: int
    mode: str = "in_relu"
    need_dx: bool = True

    @property
    def flops(self) -> float:
        one = 2.0 * self.n * self.length * self.cin * self.cout * 3
        if self.kind == "K1b":
            return one * (2 if self.need_dx else 1)
        return one

    @property
    def bytes(self) -> float:
        x = self.n * self.cin * self.length
        y = self.n * self.cout * self.length
        w, b = self.cin * self.cout * 3, self.cout
        if self.kind in ("K1f", "K2f"):
            count = x + w + b + y
        elif self.kind == "K1b":
            count = x + w + b + y + w + b + (x if self.need_dx else 0)
        elif self.kind == "K2dx":  # the linear layer's input gradient needs no x
            count = (0 if self.mode == "linear" else x + b) + w + y + x
        else:  # K2dw
            count = x + y + (0 if self.mode == "linear" else w + b) + w + b
        return F32 * count

    @property
    def least_seconds(self) -> float:
        return max(self.flops / PEAK_FLOPS, self.bytes / PEAK_BYTES)


def k1f_layers(in_channels: int, t: int):
    """(cin, cout, length) of the generator's 14 double-conv layers, in order."""
    lengths = _generator_lengths(t)
    out = []
    for name, cin, cout in model.BLOCKS:
        cin = in_channels if cin is None else cin
        out += [(cin, cout, lengths[name]), (cout, cout, lengths[name])]
    return out


def k1f_launches(in_channels: int, n: int, t: int) -> list[Launch]:
    """One generator forward's 14 K1f launches over n windows."""
    return [Launch("K1f", n, ci, co, ln) for ci, co, ln in k1f_layers(in_channels, t)]


def critic_layers(in_channels: int):
    """(cin, cout, mode) of the critic's 5 layers."""
    w = [in_channels + 1, model.NDF, model.NDF * 2, model.NDF * 4, model.NDF * 8, 1]
    return [(w[i], w[i + 1], model.CRITIC_MODES[i]) for i in range(5)]


def train_step_launches(in_channels: int, b: int, t: int, n_critic: int) -> list[Launch]:
    """The conv launches of one WGAN-GP step (critic_fuse off, no reuse_pred):
    the generator's n_critic + 1 forwards (14 K1f each) and one backward (14
    K1b, the first layer's input needing no gradient); per critic update 3
    critic forwards (K2f), the penalty's input gradient (K2dx on all 5
    layers), the scored forwards' backward (K2dx on layers 1-4 and K2dw on
    all 5, twice) and the penalty forward's backward (K2dx on layers 1-3,
    K2dw on layers 0-3); and the generator update's critic forward (5 K2f)."""
    out = []
    for _ in range(n_critic + 1):
        out += k1f_launches(in_channels, b, t)
    out += [Launch("K1b", b, ci, co, ln, need_dx=i > 0)
            for i, (ci, co, ln) in enumerate(k1f_layers(in_channels, t))]
    crit = critic_layers(in_channels)

    def layer(kind, i):
        ci, co, mode = crit[i]
        return Launch(kind, b, ci, co, t, mode)

    for _ in range(n_critic):
        out += [layer("K2f", i) for _ in range(3) for i in range(5)]
        out += [layer("K2dx", i) for i in (0, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3, 4, 1, 2, 3)]
        out += [layer("K2dw", i) for i in (0, 1, 2, 3, 4, 0, 1, 2, 3, 4, 0, 1, 2, 3)]
    out += [layer("K2f", i) for i in range(5)]
    return out

