"""Numerical-debug mode, the port's copy of ``scgrhc.core.debug``.

``SCGRHC_DEBUG=nan|nojit|all``, read when the package is imported
(:func:`enable_from_env`), or :func:`enable` called directly:

* ``nan`` turns on ``torch.autograd.set_detect_anomaly(True)``.  Every
  autograd node then records the stack of the forward that made it, and a
  backward that returns NaN raises ``RuntimeError`` naming that node and
  printing that stack: the training step's gradients, the gradient
  penalty's input gradient (``create_graph`` paths included) and the
  kernels' own backward Functions (``ConvInReLU``, the critic's ``Layer``,
  ``BwdDx``, ``BwdDwDb``), which all run as autograd nodes.  What
  ``jax_debug_nans`` catches that it does not: a NaN made in a forward
  with no backward, such as serving, evaluation, the data stage or a
  critic loss that is never differentiated.  JAX checks the output of
  every primitive; anomaly mode checks only what a backward returns.  It
  costs host time on every node, so it is a debugging mode, not a
  default.
* ``nojit`` is accepted and changes nothing.  In ``scgrhc`` it sets
  ``jax_disable_jit`` so that each primitive runs eagerly and can be
  stepped through; the port already runs eagerly (PyTorch has no ``jit``
  on its path to disable), so every line can be stepped through as it is.
* ``all`` is both.

Neither mode changes which code runs: a CUDA tensor still launches its
kernel, never a plain version.
"""

from __future__ import annotations

import os

ENV_VAR = "SCGRHC_DEBUG"
MODES = ("nan", "nojit", "all")


def enable(mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"{ENV_VAR} must be one of {MODES}, got {mode!r}")
    if mode in ("nan", "all"):
        import torch

        torch.autograd.set_detect_anomaly(True)


def enable_from_env() -> None:
    mode = os.environ.get(ENV_VAR, "").lower()
    if mode:
        enable(mode)
