"""Deterministic 90/5/5 split (the port's copy of ``scgrhc.data.split``).

The reference splits with two *unseeded* ``sklearn.train_test_split`` calls
(recordutil.py:191-192).  The split-size arithmetic is the same (floor(0.9·n)
train, then an even valid/test split of the rest), driven by a seeded
permutation, so an experiment is reproducible from ``params.seed`` and both
packages split a segment list identically.  ``"seed": null`` draws OS
entropy, like the reference.
"""

from __future__ import annotations

import numpy as np


def split_indices(n: int, seed: int | None) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """→ (train_idx, valid_idx, test_idx) index arrays."""
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    n_train = int(np.floor(0.9 * n))
    rest = perm[n_train:]
    n_valid = int(np.floor(0.5 * len(rest)))
    return perm[:n_train], rest[:n_valid], rest[n_valid:]


def split_segments(segments: list, seed: int | None):
    tr, va, te = split_indices(len(segments), seed)
    pick = lambda idx: [segments[i] for i in idx]  # noqa: E731
    return pick(tr), pick(va), pick(te)
