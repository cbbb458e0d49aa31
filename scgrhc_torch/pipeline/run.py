"""Pipeline orchestrator, the port's copy of ``scgrhc.pipeline.run.run``
(reference parity: waveform_pipeline.py).

``run(params)`` runs the whole experiment: dataset build → train →
evaluate every checkpoint on the valid split → select the best checkpoint
→ evaluate it on the test split.  Stage order, the exceptions swallowed on
the re-runnable stages and the ``checkpoint_best.txt`` handshake are the
reference's (waveform_pipeline.py:10-28).

Under a process group every rank runs every stage: the stages split their
device work over the ranks, and rank 0 alone writes (each stage's
module doc); a data-stage error is printed on every rank, as on one.
"""

from __future__ import annotations

import os

from scgrhc_torch.core.device import resolve_device
from scgrhc_torch.data import run as data_run
from scgrhc_torch.eval import run as eval_run
from scgrhc_torch.select import run as select_run
from scgrhc_torch.train import run as train_run


def run(params, device=None) -> None:
    """The pipeline on ``device`` (default CUDA; raises without it)."""
    dev = resolve_device(device)
    try:
        data_run.run(params, device=dev)
    except Exception as e:  # the stage is idempotent; reruns skip (ref :12-15)
        print(e)

    train_run.run(params, device=dev)

    try:
        eval_run.run(params, "valid", "all", device=dev)
    except Exception as e:  # ref :19-22
        print(e)

    select_run.run(params)

    with open(os.path.join(params.dir_path, "checkpoint_best.txt"), "r") as f:
        best_checkpoint = f.read().splitlines()[0].split()[1]
    eval_run.run(params, "test", best_checkpoint, device=dev)
