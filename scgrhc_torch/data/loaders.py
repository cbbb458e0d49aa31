"""Batching loader over a :class:`SegmentStore`, the port's copy of
``scgrhc.data.loaders`` for the native ``scgrhc-loader.v1`` format.

The per-epoch order is ``np.random.default_rng((seed, epoch))``'s
permutation, as in the JAX package, so both packages batch a loader file
identically.  :func:`load_dataloader` also reads the reference's pickled
torch ``DataLoader`` (reference: recordutil.py:219-224) from its
``dataset`` and ``batch_size`` alone, as ``scgrhc.data.loaders`` does.
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


def _store_from_torch_loader(loader) -> SegmentStore:
    """A reference pickled torch DataLoader's dataset → a SegmentStore.  Its
    items are the 7-tuples of recordutil.py:55-66, already normalized
    (C, T) float32 tensors."""
    items = list(loader.dataset)
    return SegmentStore(
        np.stack([np.asarray(it[0], np.float32) for it in items]),
        np.stack([np.asarray(it[1], np.float32) for it in items]),
        [it[2] for it in items],
        np.array([int(it[3]) for it in items], np.int64),
        np.array([int(it[4]) for it in items], np.int64),
        np.array([[float(it[5][0]), float(it[5][1])] for it in items], np.float64),
        np.array([[float(it[6][0]), float(it[6][1])] for it in items], np.float64),
        segment_samples=int(np.asarray(items[0][0]).shape[-1]),
    )


def load_dataloader(path: str, seed: int = 0) -> SegmentLoader:
    """Load a loader file: native (or a bare store file, unshuffled, batch
    1), or a reference pickled torch DataLoader, shuffled with ``seed``, as
    ``scgrhc.data.loaders.load_dataloader`` does."""
    with open(path, "rb") as f:
        obj = pickle.load(f)
    if isinstance(obj, dict) and obj.get("format") == LOADER_TAG:
        return SegmentLoader(SegmentStore.from_state_dict(obj["store"]), obj["batch_size"],
                             shuffle=obj["shuffle"], seed=obj.get("seed", seed))
    if isinstance(obj, dict) and obj.get("format") == FORMAT_TAG:
        return SegmentLoader(SegmentStore.from_state_dict(obj), 1, shuffle=False)
    if not hasattr(obj, "dataset"):
        raise ValueError(f"{path}: not a loader file ({LOADER_TAG}, {FORMAT_TAG} or a pickled "
                         f"torch DataLoader), got {type(obj).__name__}")
    return SegmentLoader(_store_from_torch_loader(obj), getattr(obj, "batch_size", 1) or 1,
                         shuffle=True, seed=seed)
