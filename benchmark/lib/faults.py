"""Faults planted underneath the timed path, to show that ``correct`` comes
out false and to read the numbers a broken program gives.  Used by the
tests and by ``calibrate.py``; a measured run never imports this module.
The faults of the training step (``scgrhc_torch.parallel.dp.train_step``,
which the window's ``DataParallelTrainer.step`` calls):

* ``frozen``: the step returns its state unchanged (and finite losses);
* ``half``: half of the batch left out, the means taken over the rest.
"""

from __future__ import annotations

import contextlib

TRAIN = ("frozen", "half")


@contextlib.contextmanager
def _patched(module, name: str, fn):
    original = getattr(module, name)
    setattr(module, name, fn(original))
    try:
        yield
    finally:
        setattr(module, name, original)


def _frozen(original):
    def step(state, scg, rhc, rng, cfg, *args, **kwargs):
        import torch

        zeros = torch.zeros(cfg.n_critic, device=scg.device)
        return zeros, zeros.sum()

    return step


def _half(original):
    def step(state, scg, rhc, rng, cfg, mask=None, count=None, reduce=None):
        h = scg.shape[0] // 2

        def draws(shape, device, dtype=None):
            return rng((scg.shape[0], *shape[1:]), device, dtype)[:shape[0]]

        return original(state, scg[:h], rhc[:h], draws, cfg, None, None, reduce)

    return step


def train_fault(kind: str):
    """A context in which the training step has the fault ``kind``
    (``program``: none)."""
    if kind == "program":
        return contextlib.nullcontext()
    from scgrhc_torch.parallel import dp

    return _patched(dp, "train_step", {"frozen": _frozen, "half": _half}[kind])

