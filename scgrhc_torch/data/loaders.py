"""Batching loader over a :class:`SegmentStore`, the port's copy of
``scgrhc.data.loaders`` for the native ``scgrhc-loader.v1`` format.

The per-epoch order is ``np.random.default_rng((seed, epoch))``'s
permutation, as in the JAX package, so both packages batch a loader file
identically.  Reading the reference's pickled torch ``DataLoader`` is not
yet ported.
"""

from __future__ import annotations

import pickle

import numpy as np

from scgrhc_torch.data.store import FORMAT_TAG, SegmentStore

LOADER_TAG = "scgrhc-loader.v1"


class SegmentLoader:
    """Epoch iterator yielding dense (scg, rhc) numpy minibatches."""

    def __init__(self, store: SegmentStore, batch_size: int, shuffle: bool = True,
                 seed: int = 0):
        self.store = store
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed

    @property
    def dataset(self) -> SegmentStore:
        return self.store

    def __len__(self) -> int:
        return -(-len(self.store) // self.batch_size)

    def epoch_order(self, epoch: int) -> np.ndarray:
        """The segment permutation of ``epoch``."""
        n = len(self.store)
        if self.shuffle:
            return np.random.default_rng((self.seed, epoch)).permutation(n)
        return np.arange(n)

    def batches(self, epoch: int):
        """The epoch's batches in order; the last one may be short."""
        order = self.epoch_order(epoch)
        for s in range(0, len(order), self.batch_size):
            idx = order[s:s + self.batch_size]
            yield self.store.scg[idx], self.store.rhc[idx]

    def state_dict(self) -> dict:
        return {
            "format": LOADER_TAG,
            "batch_size": self.batch_size,
            "shuffle": self.shuffle,
            "seed": self.seed,
            "store": self.store.state_dict(),
        }

    def save(self, path: str) -> None:
        with open(path, "wb") as f:
            pickle.dump(self.state_dict(), f)


def load_dataloader(path: str, seed: int = 0) -> SegmentLoader:
    """Load a native loader file (or a bare store file, unshuffled, batch
    1), as ``scgrhc.data.loaders.load_dataloader`` does."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict) and obj.get("format") == LOADER_TAG:
        return SegmentLoader(SegmentStore.from_state_dict(obj["store"]), obj["batch_size"],
                             shuffle=obj["shuffle"], seed=obj.get("seed", seed))
    if isinstance(obj, dict) and obj.get("format") == FORMAT_TAG:
        return SegmentLoader(SegmentStore.from_state_dict(obj), 1, shuffle=False)
    raise NotImplementedError(
        f"{path}: reading a pickled torch DataLoader (the reference's loader files) "
        "is not yet ported to scgrhc_torch; convert it with the scgrhc package"
    )
