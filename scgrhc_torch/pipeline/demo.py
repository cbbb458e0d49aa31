"""Zero-setup demo, the port's copy of ``scgrhc.pipeline.demo``:
synthetic database → the whole pipeline on the card → figures.

``python -m scgrhc_torch demo [workdir] [--epochs N] [--records N]
[--seconds S] [--device D]`` creates a synthetic WFDB database (no clinical
data needed), writes a waveform_06-style experiment config against it
(byte for byte ``scgrhc``'s), runs the pipeline (data → train → test valid
all → select → test test best) on ``device`` (default CUDA), prints the
selection result, and renders the pred_top/pred_rand comparison figures.
Everything lands under ``workdir`` (default ``./scgrhc_demo``).

One difference from ``scgrhc``: without matplotlib (the card's machine
has none) the figures are skipped with a line that says so, after the
pipeline has finished; the pipeline's artifacts are the same.
"""

from __future__ import annotations

import json
import os
from time import time

from scgrhc_torch.core.timelog import timelog


def run(workdir: str = "scgrhc_demo", epochs: int = 2, n_records: int = 2,
        duration_s: float = 60.0, device=None) -> str:
    from scgrhc_torch.core import paths
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.pipeline import plots
    from scgrhc_torch.pipeline.run import run as pipeline_run
    from scgrhc_torch.utils.experiments import make_params_dict
    from scgrhc_torch.utils.synth import make_synthetic_database

    start_time = time()
    workdir = os.path.abspath(workdir)
    os.makedirs(workdir, exist_ok=True)
    print(timelog(f"Run scgrhc demo in {workdir}", start_time))

    db_root = os.path.join(workdir, "db")
    if not os.path.isdir(os.path.join(db_root, "processed_data")):
        make_synthetic_database(db_root, n_records=n_records, duration_s=duration_s)
        print(timelog(f"Synthetic database: {db_root}", start_time))
    paths.set_data_path(db_root)

    exp_dir = os.path.join(workdir, "waveform_06")
    os.makedirs(exp_dir, exist_ok=True)
    cfg = make_params_dict(6, "PA", ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv"],
                           total_epochs=epochs, seed=0, batch_size=16)
    cfg["dir_path"] = exp_dir
    cfg_path = os.path.join(exp_dir, "params.json")
    with open(cfg_path, "w") as f:
        json.dump(cfg, f, indent=2)

    params = Params(cfg_path)
    pipeline_run(params, device=device)

    with open(os.path.join(exp_dir, "checkpoint_best.txt")) as f:
        best_lines = f.read()
    best = best_lines.splitlines()[0].split()[1]
    print(timelog(f"demo | best checkpoint on valid split:\n{best_lines}", start_time))
    try:
        plots.run(params, "test", best, n=3)
    except ImportError as e:
        print(timelog(f"demo | figures skipped: {e}", start_time))
    print(timelog(f"demo | done — artifacts in {exp_dir} "
                  "(checkpoints/, comparisons/, pred_top/, pred_rand/)", start_time))
    return exp_dir
