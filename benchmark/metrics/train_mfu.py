"""The training step's share of the card's peak: the conv operations of
the window's steps (counted from the layer shapes, a floor of the work)
over the window's seconds, against 495/3 TFLOP/s, the 3xTF32 rate that
keeps float32 (NVIDIA H100 SXM, dense)."""

from benchmark.lib.flops import PEAK_FLOPS

LAYER = "train step"
SOURCE = "host_clock"
MOVES = "train_windows_per_s"


def read(run):
    if not run.on_card or not run.window.get("seconds"):
        return None
    return 100.0 * run.window["conv_flops"] / run.window["seconds"] / PEAK_FLOPS
