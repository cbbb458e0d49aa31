"""Profiling hooks, the port's copy of ``scgrhc.core.trace``.

``timelog`` prints keep the reference's log lines
(:mod:`scgrhc_torch.core.timelog`); this module adds device traces on top:
``torch.profiler`` timelines of the host's operators and, on the card, of
every kernel (CUPTI), written as Chrome traces that Perfetto or
``chrome://tracing`` open, with named spans at the training step's phases.

:func:`trace` starts a profiler when ``SCGRHC_PROFILE_DIR=/path`` is set
(each instrumented stage then writes under ``/path/<label>/``) or when
called with ``out_dir``; otherwise it returns a ``nullcontext``.  It sits
around the epoch loop (``trace("train")``, ``scgrhc_torch.train.run``) and
each checkpoint's scoring (``trace("eval_<split>")``,
``scgrhc_torch.eval.run``).

:func:`annotate` opens a span whenever any ``torch.profiler`` is recording,
whoever started it (:func:`trace`, a caller's own ``profile``, a
benchmark's traced window): PyTorch's own flag
``torch.autograd.profiler._is_profiler_enabled`` decides, not the
environment.  With none recording it returns one shared ``nullcontext``:
a bool read, nothing imported, nothing made.  The spans:

  * ``train_step`` (``parallel/dp.py``, ``DataParallelTrainer.step``): the
    batch gather and the whole ``train_step``;
  * ``critic_loss``, ``critic_grad`` (the parameter gradient),
    ``generator_loss``, ``generator_grad`` and ``adam`` (``train/wgan.py``):
    every device operation of ``train_step`` falls in one of them or in
    ``grad_reduce``, except the losses' stacking;
  * ``gp_second_order`` (``ops/kernels/critic_fused.py``,
    ``BwdDx.backward``): the closed-form vjp of one K2dx node on the conv
    core's kernels (in bf16 the plain layer's vjp under autograd), inside
    ``critic_grad``, on autograd's thread;
  * ``grad_reduce`` (``parallel/dp.py``): a bucket's all-reduce, only when a
    process group exists;
  * ``train_epoch``, ``losses_read_back`` and ``checkpoint_save``
    (``train/run.py``): the epoch mode's steps, the losses' ``.tolist()``
    and the blocking part of a checkpoint save.

Each recorded span adds to a total for its name: ``calls`` and, once CUDA
is initialized, ``device_ms`` between two CUDA events recorded on the
current stream at its enter and exit (pooled, read lazily).
:func:`phase_totals` returns them, :func:`reset_phases` clears them, and
:func:`trace` writes them as ``phases.json`` beside its Chrome trace.
"""

from __future__ import annotations

import json
import os
import sys
import threading
from contextlib import contextmanager, nullcontext

ENV_VAR = "SCGRHC_PROFILE_DIR"
PHASES_FILE = "phases.json"
_OFF = nullcontext()
# pending event pairs past which a span resolves those already complete
_RESOLVE_AT = 1024


def profile_dir() -> str | None:
    return os.environ.get(ENV_VAR) or None


def recording() -> bool:
    """Whether a ``torch.profiler`` is recording in this process."""
    prof = sys.modules.get("torch.autograd.profiler")
    return prof is not None and prof._is_profiler_enabled


class _Phases:
    """Per-name totals of the recorded spans: calls, and the device time of
    the event pairs already resolved and of those still pending."""

    def __init__(self):
        self.lock = threading.Lock()
        self.calls: dict[str, int] = {}
        self.ms: dict[str, float] = {}
        self.pending: list = []  # (name, start event, end event)
        self.pool: list = []

    def event(self):
        with self.lock:
            if self.pool:
                return self.pool.pop()
        import torch

        return torch.cuda.Event(enable_timing=True)

    def add(self, name: str, pair) -> None:
        with self.lock:
            self.calls[name] = self.calls.get(name, 0) + 1
            if pair is not None:
                self.pending.append((name, *pair))
                if len(self.pending) >= _RESOLVE_AT:
                    self._resolve(wait=False)

    def _resolve(self, wait: bool) -> None:
        """Fold pending pairs into ``ms``: all of them (``wait``), or those
        the device has passed.  The caller holds the lock."""
        left = []
        for name, start, end in self.pending:
            if wait:
                end.synchronize()
            elif not end.query():
                left.append((name, start, end))
                continue
            self.ms[name] = self.ms.get(name, 0.0) + start.elapsed_time(end)
            self.pool += (start, end)
        self.pending = left

    def totals(self) -> dict:
        with self.lock:
            self._resolve(wait=True)
            return {name: {"calls": n, **({"device_ms": self.ms[name]} if name in self.ms else {})}
                    for name, n in self.calls.items()}

    def reset(self) -> None:
        with self.lock:
            self.pool += [e for _, *pair in self.pending for e in pair]
            self.calls, self.ms, self.pending = {}, {}, []


_PHASES = _Phases()


def phase_totals() -> dict:
    """``{name: {"calls", "device_ms"}}`` of the spans recorded since the
    last reset (``device_ms`` only where CUDA events were recorded); waits
    for the device to pass the pending events."""
    return _PHASES.totals()


def reset_phases() -> None:
    _PHASES.reset()


class _Span:
    """A ``record_function`` range that adds to the phase totals."""

    __slots__ = ("name", "range", "pair")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        import torch
        from torch.profiler import record_function

        self.range = record_function(self.name)
        self.range.__enter__()
        self.pair = None
        if torch.cuda.is_initialized():
            self.pair = (_PHASES.event(), _PHASES.event())
            self.pair[0].record()
        return self

    def __exit__(self, *exc):
        if self.pair is not None:
            self.pair[1].record()
        self.range.__exit__(*exc)
        _PHASES.add(self.name, self.pair)
        return False


def annotate(name: str):
    """A named span (``torch.profiler.record_function``: a host range, and on
    the card the device work launched inside it) that adds to the phase
    totals, while a profiler records; a shared ``nullcontext`` otherwise."""
    return _Span(name) if recording() else _OFF


def trace(label: str, out_dir: str | None = None, device=None):
    """A ``torch.profiler.profile`` over the enclosed block, written as a
    Chrome trace into ``<dir>/<label>/`` when it ends, with the block's
    phase totals beside it as ``phases.json`` (none without spans).

    The trace file is named after the host, the process and the time
    (``torch.profiler.tensorboard_trace_handler``), so a second block with
    the same label, such as the next checkpoint of an eval loop, adds a
    file and overwrites none.  Kernels are traced (CUDA activity) when
    ``device`` is a CUDA device, or, with ``device=None``, when a card is
    present.  No-op unless ``out_dir`` or ``$SCGRHC_PROFILE_DIR`` is set.
    """
    out = out_dir or profile_dir()
    if not out:
        return _OFF
    import torch
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    path = os.path.join(out, label)
    os.makedirs(path, exist_ok=True)
    on_card = (torch.cuda.is_available() if device is None
               else torch.device(device).type == "cuda")
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    return _profiled(profile(activities=activities,
                             on_trace_ready=tensorboard_trace_handler(path)), path)


@contextmanager
def _profiled(prof, path: str):
    reset_phases()
    try:
        with prof:
            yield prof
        totals = phase_totals()
    finally:
        reset_phases()
    if totals:
        with open(os.path.join(path, PHASES_FILE), "w") as f:
            json.dump(totals, f, indent=1, sort_keys=True)
