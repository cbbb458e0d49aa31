"""The training step's conv kernels (K1f, K1b, K2f, K2dx, K2dw over the
conv core, ``csrc/conv3.cuh``) against their roofline: the least time the
card could take for the traced steps' launches, each the larger of its
operations at 495/3 TFLOP/s and its bytes at 3.35 TB/s, over the device
time of the conv core's kernels in the trace."""

from benchmark.lib.flops import CONV_KERNELS

LAYER = "kernels"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(run):
    if run.summary is None or not run.on_card or not run.traced.get("launches"):
        return None
    seconds = run.summary.kernel_seconds(CONV_KERNELS)
    if seconds <= 0:
        return None
    return 100.0 * sum(x.least_seconds for x in run.traced["launches"]) / seconds
