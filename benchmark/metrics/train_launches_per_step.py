"""Kernel launches on the card per training step: every kernel in the
traced steps' CUDA activity (the port's, cuDNN's and PyTorch's) over the
steps traced.  A count."""

LAYER = "train step"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(run):
    if run.summary is None or not run.on_card or not run.traced.get("steps"):
        return None
    return run.summary.launches / run.traced["steps"]
