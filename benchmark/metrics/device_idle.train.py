"""Share of the traced training steps in which nothing ran on the card:
the window less the union of its kernel, copy and set intervals."""

LAYER = "device"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"


def read(run):
    if run.summary is None or not run.on_card or run.summary.window_s <= 0:
        return None
    return 100.0 * (1.0 - run.summary.busy_s / run.summary.window_s)
