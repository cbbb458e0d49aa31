"""Dataset-build stage, the port's copy of ``scgrhc.data.run`` (reference
parity: recordutil.py:172-230).

Builds the experiment's segments (:func:`scgrhc_torch.dsp.segment.get_segments`,
K3 on the device with ``data_backend: "device"``), splits them 90/5/5
(seeded), makes each split a dense :class:`SegmentStore`, and writes the
native loader files at the paths of ``params.json``.  Overwrite guards and
``record_log.txt`` match the reference (recordutil.py:176-181, 211-216).

``loader_backend: "torch"`` writes the reference's own artifacts instead,
pickled torch DataLoaders (:mod:`scgrhc_torch.data.torch_export`), which
``scgrhc`` and the port read back.  Under a process group rank 0 builds
the files (K3 on its card with ``data_backend: "device"``) while the
other ranks wait; a failure on rank 0 is an error on every rank
(:func:`scgrhc_torch.parallel.comm.on_primary`).
"""

from __future__ import annotations

import os
from datetime import datetime
from time import time

from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.data.loaders import SegmentLoader
from scgrhc_torch.data.split import split_segments
from scgrhc_torch.data.store import SegmentStore, get_global_minmax_vals
from scgrhc_torch.data.torch_export import export_torch_loader
from scgrhc_torch.dsp.segment import get_segments
from scgrhc_torch.parallel import comm


def save_dataloaders(params, device=None) -> None:
    """``device``: where K3 runs with ``data_backend: "device"`` (default
    CUDA); the host backend touches no device."""
    if os.path.exists(params.train_path):
        raise Exception("Train file already exists!")
    elif os.path.exists(params.valid_path):
        raise Exception("Valid file already exists!")
    elif os.path.exists(params.test_path):
        raise Exception("Test file already exists!")

    all_segments = get_segments(params, device=device)
    if not all_segments:
        raise Exception("No clean segments found")

    if params.use_global_min_max:
        minmax_scg, minmax_rhc = get_global_minmax_vals(all_segments)
    else:
        minmax_scg = None
        minmax_rhc = None

    train_segments, valid_segments, test_segments = split_segments(all_segments, params.seed)

    def make(segs):
        return SegmentStore.from_segments(segs, params.segment_size, minmax_scg, minmax_rhc)

    splits = ((train_segments, params.batch_size, params.train_path),
              (valid_segments, 1, params.valid_path), (test_segments, 1, params.test_path))
    for segs, batch_size, path in splits:
        if getattr(params, "loader_backend", "native") == "torch":
            # the reference's artifact (recordutil.py:202-209): a pickled
            # torch DataLoader, shuffled
            export_torch_loader(make(segs), batch_size, True, path)
        else:
            SegmentLoader(make(segs), batch_size, shuffle=True, seed=params.seed).save(path)

    with open(os.path.join(params.dir_path, "record_log.txt"), "w") as f:
        f.write(f"Dataset created: {datetime.now()}\n")
        f.write(f"All segments: {len(all_segments)}\n")
        f.write(f"Valid segments: {len(valid_segments)}\n")
        f.write(f"Train segments: {len(train_segments)}\n")
        f.write(f"Test segments: {len(test_segments)}\n")


def run(params, device=None) -> None:
    start_time = time()
    # log-line parity with the reference stage banner (recordutil.py:229)
    print(timelog(f"Run recordutil for {params.dir_path}", start_time))
    comm.refuse_lone_rank()
    # one writer; the others read the shared files once it is done
    comm.on_primary("data_end", save_dataloaders, params, device)
