"""Profiling hooks, the port's copy of ``scgrhc.core.trace``.

``timelog`` prints keep the reference's log lines
(:mod:`scgrhc_torch.core.timelog`); this module adds device traces on top:
``torch.profiler`` timelines of the host's operators and, on the card, of
every kernel (CUPTI), written as Chrome traces that Perfetto or
``chrome://tracing`` open, with named spans around the hot loops.

Enable by setting ``SCGRHC_PROFILE_DIR=/path`` (each instrumented stage then
writes under ``/path/<label>/``) or by calling :func:`trace` with
``out_dir``.  Unset, :func:`trace` and :func:`annotate` return a
``nullcontext`` and import nothing, so the hot loops stay instrumented
unconditionally: ``trace("train")`` around the epoch loop,
``annotate("train_step")`` / ``annotate("train_epoch")`` around each step
or epoch (``scgrhc_torch.train.run``), and ``trace("eval_<split>")``
around each checkpoint's scoring (``scgrhc_torch.eval.run``).
"""

from __future__ import annotations

import os
from contextlib import nullcontext

ENV_VAR = "SCGRHC_PROFILE_DIR"


def profile_dir() -> str | None:
    return os.environ.get(ENV_VAR) or None


def trace(label: str, out_dir: str | None = None, device=None):
    """A ``torch.profiler.profile`` over the enclosed block, written as a
    Chrome trace into ``<dir>/<label>/`` when it ends.

    The file is named after the host, the process and the time
    (``torch.profiler.tensorboard_trace_handler``), so a second block with
    the same label, such as the next checkpoint of an eval loop, adds a
    file and overwrites none.  Kernels are traced (CUDA activity) when
    ``device`` is a CUDA device, or, with ``device=None``, when a card is
    present.  No-op unless ``out_dir`` or ``$SCGRHC_PROFILE_DIR`` is set.
    """
    out = out_dir or profile_dir()
    if not out:
        return nullcontext()
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    path = os.path.join(out, label)
    os.makedirs(path, exist_ok=True)
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return profile(activities=activities, on_trace_ready=tensorboard_trace_handler(path))


def annotate(name: str):
    """A named span inside a trace (``torch.profiler.record_function``: a
    host range, and on the card the matching device range).  A
    ``nullcontext`` when tracing is off."""
    if not profile_dir():
        return nullcontext()
    from torch.profiler import record_function

    return record_function(name)
