"""Everything random in a run comes from ``--seed`` through these helpers.

Weights are drawn on the device with a ``torch.Generator`` in one call per
model, in float32, and scaled to PyTorch's default conv init,
U(-1/sqrt(fan_in), 1/sqrt(fan_in)) for weight and bias alike.
"""

from __future__ import annotations

import math

import numpy as np
import torch


def subseed(seed: int, *words: int) -> int:
    """A 63-bit seed for one use of the run's seed, named by ``words``."""
    state = np.random.SeedSequence([int(seed), *[int(w) for w in words]]).generate_state(2)
    return int((int(state[0]) << 31) ^ int(state[1])) & ((1 << 63) - 1)


def generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def weights(shapes, seed: int, device) -> dict[str, torch.Tensor]:
    """{name: tensor} for ``shapes`` ((name, shape, fan_in) triples), drawn
    on ``device`` in one call."""
    counts = [math.prod(shape) for _, shape, _ in shapes]
    bounds = torch.tensor([1.0 / math.sqrt(fan) for *_, fan in shapes], device=device)
    u = torch.rand(sum(counts), generator=generator(seed, device), device=device)
    flat = (u * 2.0 - 1.0) * torch.repeat_interleave(
        bounds, torch.tensor(counts, device=device))
    return {name: part.view(shape) for (name, shape, _), part in
            zip(shapes, torch.split(flat, counts))}
