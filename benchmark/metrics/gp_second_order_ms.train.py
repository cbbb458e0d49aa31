"""Device milliseconds per traced training step of the GP's second order: the
program's ``gp_second_order`` spans, one rerun of a plain critic layer under
autograd at each ``BwdDx`` node (``_plain_vjp``, cuDNN's plain
convolutions), timed by the CUDA events that each span records on the card's
stream at its enter and exit (``scgrhc_torch.core.trace.phase_totals``),
over the steps traced.  Only the traced window's profiler records spans, so
the totals are those steps'.  None off the card, and for a program without
the phase counters."""

LAYER = "train step"
SOURCE = "device_trace"
MOVES = "train_windows_per_s"
SPAN = "gp_second_order"


def read(run):
    if not run.on_card or not run.traced.get("steps"):
        return None
    from scgrhc_torch.core import trace

    totals = getattr(trace, "phase_totals", None)
    if totals is None:
        return None
    ms = totals().get(SPAN, {}).get("device_ms")
    return None if ms is None else ms / run.traced["steps"]
