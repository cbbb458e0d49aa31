"""Checkpoint selection stage, the port's copy of ``scgrhc.select.run``
(reference parity: waveform_checkpoint.py).

Reads every ``comparisons/valid/*.csv``, concatenates all segments'
denormalized real and predicted waveforms, computes one global PCC (with
its Fisher-z CI) and RMSE (with its t-CI) per checkpoint in float64, and
writes ``checkpoint_scores.csv`` and ``checkpoint_best.txt``, the
argmax-``pcc_r`` row as pandas' ``Series.to_string()`` prints it: the
handshake the pipeline parses (waveform_pipeline.py:26-27).  Both files
are written with the standard library, byte for byte as ``scgrhc`` writes
them with pandas.

``scgrhc`` re-scores near-tied leading checkpoints serially, because its
vmapped stacked eval re-fuses float32 sums; the port's eval has one path
(:mod:`scgrhc_torch.eval.infer`), so select reads the CSVs as they are and
touches no device.  Under a process group rank 0 scores and writes while
the other ranks wait (:func:`scgrhc_torch.parallel.comm.on_primary`, the
``select_end`` barrier of ``scgrhc``); the pipeline reads
``checkpoint_best.txt`` next, on every rank.
"""

from __future__ import annotations

import csv
import os
from time import time

import numpy as np

from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.eval import metrics
from scgrhc_torch.eval import run as eval_run
from scgrhc_torch.parallel import comm


def get_float_array(s: str) -> np.ndarray:
    """Parse the reference's stringified list format
    (reference: waveform_checkpoint.py:12-16)."""
    return np.asarray(s.strip("[").strip("]").split(","), dtype=np.float64)


def _score_comparison_csv(path: str):
    """Global scores for one comparison CSV, or None if it has no rows."""
    with open(path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        return None
    all_pred = np.concatenate([get_float_array(r["pred_rhc"]) for r in rows])
    all_real = np.concatenate([get_float_array(r["real_rhc"]) for r in rows])
    return metrics.global_scores(all_real, all_pred)


def get_checkpoint_scores(params, start_time: float) -> list[dict]:
    corrs = []
    comparison_dir_path = os.path.join(params.comparison_dir_path, "valid")
    comparison_paths = sorted(os.listdir(comparison_dir_path))

    for i, comparison_path in enumerate(comparison_paths):
        score = _score_comparison_csv(os.path.join(comparison_dir_path, comparison_path))
        if score is None:  # empty split: nothing to score for this checkpoint
            print(timelog(f"waveform_checkpoint | {params.dir_path} | "
                          f"{i}/{len(comparison_paths)} | empty comparison "
                          f"{comparison_path}, skipped", start_time))
            continue
        checkpoint = f"{comparison_path.split('.')[0]}.checkpoint"
        corrs.append({"checkpoint": checkpoint, **score})
        print(timelog(
            f"waveform_checkpoint | {params.dir_path} | {i}/{len(comparison_paths)} | "
            f"{score['pcc_r']:.3f} [{score['pcc_ci95_lower']:.3f}, "
            f"{score['pcc_ci95_upper']:.3f}] | {score['rmse']:.3f} | "
            f"[{score['rmse_ci95_lower']:.3f}, {score['rmse_ci95_upper']:.3f}]",
            start_time,
        ))
    return corrs


def _float_text(v: float) -> str:
    s = f"{v: .6f}".rstrip("0")
    return s + "0" if s.endswith(".") else s


def series_text(row: dict) -> str:
    """``pd.Series(row, dtype=object).to_string()``: labels left-aligned,
    values right-aligned to one width three spaces after them; a float as
    ``% .6f`` with its trailing zeros cut to one, every other value (NaN as
    ``NaN``) after one space."""
    vals = [_float_text(v) if isinstance(v, float) and v == v
            else " " + ("NaN" if isinstance(v, float) else str(v)) for v in row.values()]
    kw, vw = max(map(len, row)), max(map(len, vals))
    return "\n".join(f"{k.ljust(kw)}   {v.rjust(vw)}" for k, v in zip(row, vals))


def best_row(scores: list[dict]) -> dict:
    """The row of the largest pcc_r (the first one on a tie, NaN skipped),
    as pandas' ``idxmax`` picks it."""
    if not scores:
        raise KeyError("pcc_r")
    finite = [i for i, s in enumerate(scores) if s["pcc_r"] == s["pcc_r"]]
    if not finite:
        raise ValueError("Encountered all NA values")
    return scores[max(finite, key=lambda i: (scores[i]["pcc_r"], -i))]


def run(params) -> None:
    comm.on_primary("select_end", _select, params)


def _select(params) -> None:
    start_time = time()
    print(timelog(f"Run waveform_checkpoint for {params.dir_path}", start_time))
    scores = get_checkpoint_scores(params, start_time)
    eval_run.write_csv(os.path.join(params.dir_path, "checkpoint_scores.csv"),
                       list(scores[0]) if scores else [], scores)
    with open(os.path.join(params.dir_path, "checkpoint_best.txt"), "w") as f:
        f.write(series_text(best_row(scores)))
