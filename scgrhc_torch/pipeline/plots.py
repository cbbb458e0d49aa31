"""Prediction comparison plots, the port's copy of ``scgrhc.pipeline.plots``.

Every reference config names ``pred_top_dir_path`` and
``pred_rand_dir_path`` (paramutil.py:19-20), but no reference script writes
there.  From one checkpoint's comparison CSV this plots the top-N segments
by Pearson r into ``pred_top`` and N random segments into ``pred_rand``
(real against predicted denormalized RHC).

matplotlib is imported when a figure is drawn, and without it :func:`run`
raises an ``ImportError`` that names it.  The random rows are pandas'
``df.sample(n, random_state=seed)``: ``RandomState(seed).choice(len, n,
replace=False)``, in that order.
"""

from __future__ import annotations

import csv
import os
from time import time

import numpy as np

from scgrhc_torch.core.timelog import timelog
from scgrhc_torch.io.catalog import SAMPLE_FREQ
from scgrhc_torch.select.run import get_float_array
from scgrhc_torch.utils.pandas_text import read_float


def _pyplot():
    try:
        import matplotlib

        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
    except ImportError as e:
        raise ImportError(f"plots needs matplotlib, which is not installed ({e})") from e
    return plt


def _plot_rows(rows: list[dict], out_dir: str, tag: str) -> list[str]:
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    paths = []
    for row in rows:
        real = get_float_array(row["real_rhc"])
        pred = get_float_array(row["pred_rhc"])
        t = np.arange(real.size) / SAMPLE_FREQ
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(t, real, label="Real RHC", linewidth=1.0)
        ax.plot(t, pred, label="Predicted RHC", linewidth=1.0)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Pressure (mmHg)")
        ax.set_title(f"{row['filename']} [{row['start_idx']}:{row['stop_idx']}] "
                     f"r={read_float(row['pcc_r']):.3f} rmse={read_float(row['rmse']):.2f}")
        ax.legend(loc="upper right", fontsize=8)
        fig.tight_layout()
        path = os.path.join(out_dir, f"{tag}_{row['filename']}_{row['start_idx']}.png")
        fig.savefig(path, dpi=100)
        plt.close(fig)
        paths.append(path)
    return paths


def run(params, loader_type: str, checkpoint: str, n: int = 5, seed: int = 0) -> list[str]:
    """Write top-N and random-N comparison plots for one checkpoint's CSV."""
    start_time = time()
    checkpoint_str = checkpoint.split(".")[0]
    csv_path = os.path.join(params.comparison_dir_path, loader_type, f"{checkpoint_str}.csv")
    print(timelog(f"Run waveform_plots for {params.dir_path} | {loader_type} | "
                  f"{checkpoint_str}", start_time))
    with open(csv_path, newline="") as f:
        rows = list(csv.DictReader(f))
    if not rows:
        print("No comparisons to plot")
        return []
    # CSV rows are already sorted by pcc_r descending (waveform_test.py:148)
    rand = np.random.RandomState(seed).choice(len(rows), min(n, len(rows)), replace=False)
    tag = f"{loader_type}_{checkpoint_str}"
    out = _plot_rows(rows[:n], params.pred_top_dir_path, tag)
    out += _plot_rows([rows[i] for i in rand], params.pred_rand_dir_path, tag)
    print(timelog(f"waveform_plots | wrote {len(out)} figures", start_time))
    return out
