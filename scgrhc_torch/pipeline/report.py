"""Sweep report, the port's copy of ``scgrhc.pipeline.report``: for each
experiment dir under a root with a ``checkpoint_scores.csv``, the
best-by-``pcc_r`` row (the argmax that waveform_checkpoint.py:61-63 writes
to checkpoint_best.txt) with the config's chamber and channels, ranked
into ``sweep_report.csv`` and printed as a table.

``scgrhc`` reads the scores and writes both outputs with pandas; the port
writes the same bytes without it (:mod:`scgrhc_torch.utils.pandas_text`).
"""

from __future__ import annotations

import csv
import json
import os
from time import time

from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.eval.run import write_csv
from scgrhc_torch.select.run import best_row
from scgrhc_torch.utils.pandas_text import frame_text, read_float

COLUMNS = ["experiment", "chamber", "in_channels", "checkpoint", "pcc_r", "pcc_ci95_lower",
           "pcc_ci95_upper", "rmse", "n_checkpoints_scored"]
_FLOATS = ("pcc_r", "pcc_ci95_lower", "pcc_ci95_upper", "rmse")


def _read_scores(path: str) -> list[dict]:
    """``checkpoint_scores.csv``'s rows, its float columns as pandas parses
    them."""
    with open(path, newline="") as f:
        return [{**r, **{k: read_float(r[k]) for k in _FLOATS}} for r in csv.DictReader(f)]


def collect(root: str = ".") -> list[dict]:
    rows = []
    for name in sorted(os.listdir(root)):
        d = os.path.join(root, name)
        scores_path = os.path.join(d, "checkpoint_scores.csv")
        params_path = os.path.join(d, "params.json")
        if not (os.path.isfile(scores_path) and os.path.isfile(params_path)):
            continue
        scores = _read_scores(scores_path)
        if not scores:
            continue
        best = best_row(scores)
        with open(params_path) as f:
            cfg = json.load(f)
        rows.append({
            "experiment": name,
            "chamber": cfg.get("chamber"),
            "in_channels": "+".join(c.replace("patch_ACC_", "").replace("patch_", "")
                                    for c in cfg.get("in_channels", [])),
            "checkpoint": best["checkpoint"],
            **{k: best[k] for k in _FLOATS},
            "n_checkpoints_scored": len(scores),
        })
    rows.sort(key=lambda r: r["pcc_r"], reverse=True)
    return rows


def run(root: str = ".") -> str | None:
    start_time = time()
    print(timelog(f"Run waveform_report for {root}", start_time))
    rows = collect(root)
    if not rows:
        print("No experiments with checkpoint_scores.csv found")
        return None
    out = os.path.join(root, "sweep_report.csv")
    write_csv(out, COLUMNS, rows)
    print(frame_text(COLUMNS, rows))
    return out
