"""Write the reference's loader artifacts: pickled torch ``DataLoader``s, the
port's copy of ``scgrhc.data.torch_export``.

The reference pickles live ``DataLoader`` objects and reloads them with a
bare ``pickle.load`` (reference: recordutil.py:202-209, 219-224); its eval
walks ``loader.dataset`` item by item (waveform_test.py:58) and its
training iterates the loader with default collation
(waveform_train.py:357).  This module re-encodes a
:class:`~scgrhc_torch.data.store.SegmentStore` as that artifact, so the
reference scripts, ``scgrhc`` and the port all read a dataset the port
built; :func:`scgrhc_torch.data.loaders.load_dataloader` reads it back.

The exported ``DataLoader`` wraps a plain ``list`` of 7-tuples (a list
satisfies the ``Dataset`` protocol), not a class of this package, so the
pickle names only torch internals and loads wherever torch is installed.
Item layout (reference: recordutil.py:55-66): ``(scg (C, T) float32
tensor, rhc (1, T) float32 tensor, record_name, start_idx, stop_idx,
(scg_min, scg_max), (rhc_min, rhc_max))``.
"""

from __future__ import annotations

import os
import pickle

import numpy as np
import torch
from torch.utils.data import DataLoader


def store_to_torch_dataset(store) -> list:
    """SegmentStore → list of reference-layout 7-tuples (torch tensors)."""
    return [
        (
            torch.from_numpy(np.ascontiguousarray(store.scg[i])),
            torch.from_numpy(np.ascontiguousarray(store.rhc[i])),
            store.record_names[i],
            int(store.start_idx[i]),
            int(store.stop_idx[i]),
            (float(store.minmax_scg[i][0]), float(store.minmax_scg[i][1])),
            (float(store.minmax_rhc[i][0]), float(store.minmax_rhc[i][1])),
        )
        for i in range(len(store))
    ]


def export_torch_loader(store, batch_size: int, shuffle: bool, out_path: str) -> str:
    """Pickle a torch DataLoader over the store's segments to ``out_path``
    (reference loader construction: recordutil.py:198-209)."""
    loader = DataLoader(store_to_torch_dataset(store), batch_size=batch_size, shuffle=shuffle)
    with open(out_path, "wb") as f:
        pickle.dump(loader, f)
    return out_path


def export_torch_loaders(params, out_dir: str | None = None) -> list[str]:
    """Re-encode an experiment's three loader files (native or torch) as
    reference torch pickles in ``out_dir``, by default
    ``<dir_path>/torch_loaders``, under the same file names, so a reference
    experiment whose ``dir_path`` points there runs on this dataset.  The
    train loader keeps ``params.batch_size``; valid and test get batch 1;
    all three shuffle, as the reference's (recordutil.py:198-200)."""
    from scgrhc_torch.data.loaders import load_dataloader

    out_dir = out_dir or os.path.join(params.dir_path, "torch_loaders")
    os.makedirs(out_dir, exist_ok=True)
    return [
        export_torch_loader(load_dataloader(path).dataset, batch_size, True,
                            os.path.join(out_dir, os.path.basename(path)))
        for path, batch_size in ((params.train_path, params.batch_size),
                                 (params.valid_path, 1), (params.test_path, 1))
    ]
