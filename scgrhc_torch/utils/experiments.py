"""Generator for the 37-experiment sweep configuration matrix, the port's
copy of ``scgrhc.utils.experiments``.

The reference ships 37 hand-written ``waveform_NN/params.json`` files
sweeping target chamber {PA, RV, RA, PCW} × SCG-channel subsets of
{patch_ACC_lat, patch_ACC_hf, patch_ACC_dv, patch_ECG} (reference:
waveform_06..37/params.json; design intents in project_log.txt:1-95).
This module regenerates the same matrix programmatically so a fresh
checkout can materialize every experiment directory without carrying the
reference files:

  * configs 06-37 — the modern schema: segment 1.5 s, lr 1e-4, betas
    (0.5, 0.999), n_critic 2, λ_gp 10, λ_aux 100, 250 epochs,
    min_RHC −50, per-segment min-max; batch 64 for PA/PCW, 16 for RV/RA
    (reference: any waveform_06..37/params.json);
  * per-chamber channel subsets in the reference's order: the full ACC
    triple, the three ACC pairs (PA/RV/RA/PCW rows 1-4), ACC triple+ECG,
    and the three ACC singles — matching waveform_06..37's layout;
  * configs 01-05 — the legacy schema is intentionally NOT generated
    (it cannot be loaded by ``Params``, reference: paramutil.py:9-29).
"""

from __future__ import annotations

import json
import os

LAT, HF, DV, ECG = "patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"

# (experiment number, chamber, in_channels) — reference waveform_06..37.
SWEEP: list[tuple[int, str, list[str]]] = [
    (6, "PA", [LAT, HF, DV]),
    (7, "PA", [LAT, HF]),
    (8, "PA", [LAT, DV]),
    (9, "PA", [HF, DV]),
    (10, "PA", [LAT, HF, DV, ECG]),
    (11, "RV", [LAT, HF, DV]),
    (12, "RV", [LAT, HF]),
    (13, "RV", [LAT, DV]),
    (14, "RV", [HF, DV]),
    (15, "RA", [LAT, HF, DV]),
    (16, "RA", [LAT, HF]),
    (17, "RA", [LAT, DV]),
    (18, "RA", [HF, DV]),
    (19, "PCW", [LAT, HF, DV]),
    (20, "PCW", [LAT, HF]),
    (21, "PCW", [LAT, DV]),
    (22, "PCW", [HF, DV]),
    (23, "PA", [LAT]),
    (24, "PA", [HF]),
    (25, "PA", [DV]),
    (26, "RV", [LAT, HF, DV, ECG]),
    (27, "RV", [LAT]),
    (28, "RV", [HF]),
    (29, "RV", [DV]),
    (30, "PCW", [LAT, HF, DV, ECG]),
    (31, "PCW", [LAT]),
    (32, "PCW", [HF]),
    (33, "PCW", [DV]),
    (34, "RA", [LAT]),
    (35, "RA", [HF]),
    (36, "RA", [DV]),
    (37, "RA", [LAT, HF, DV, ECG]),
]

BATCH_SIZE = {"PA": 64, "PCW": 64, "RV": 16, "RA": 16}


def make_params_dict(
    number: int, chamber: str, in_channels: list[str], root: str = ".", **overrides
) -> dict:
    """One experiment's params.json contents (modern schema, C18)."""
    name = f"waveform_{number:02d}"
    cfg = {
        "dir_path": name if root in (".", "") else os.path.join(root, name),
        "in_channels": list(in_channels),
        "chamber": chamber,
        "segment_size": 1.5,
        "batch_size": BATCH_SIZE[chamber],
        "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle",
        "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top",
        "pred_rand_dir_path": "pred_rand",
        "alpha": 0.0001,
        "beta1": 0.5,
        "beta2": 0.999,
        "n_critic": 2,
        "lambda_gp": 10,
        "lambda_aux": 100,
        "total_epochs": 250,
        "min_RHC": -50,
        "use_global_min_max": False,
    }
    cfg.update(overrides)
    return cfg


def write_experiments(root: str, **overrides) -> list[str]:
    """Materialize waveform_06..37 experiment dirs under ``root``.

    ``overrides`` apply to every config (e.g. ``total_epochs=2`` for a
    smoke sweep, ``seed=0`` for determinism).  Returns the dir paths.
    """
    out = []
    for number, chamber, in_channels in SWEEP:
        cfg = make_params_dict(number, chamber, in_channels, root=root, **overrides)
        d = cfg["dir_path"]
        os.makedirs(d, exist_ok=True)
        with open(os.path.join(d, "params.json"), "w") as f:
            json.dump(cfg, f, indent=2)
        out.append(d)
    return out
