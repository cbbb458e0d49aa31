"""Wall time of ``python -m scgrhc_torch <dir>`` (data → train → test valid
all → select → test test best, each run in a new process, as a user runs
it) for two checkouts on one card, in turns: A, B, B, A, ... .

    python3 scgrhc_torch/bench/ab_wall.py <checkout A> <checkout B> [--rounds 2]

Each run gets a fresh experiment on one synthetic database of 4 records ×
1800 s (seed 0; chamber PA, 4 SCG channels, batch 32, n_critic 5, 2
epochs, ``data_backend: "device"``), the configuration ``chip_smoke.py``'s
pipeline phase runs.  Prints one line per run and, last, one JSON object
with every run's seconds, per checkout, and the card's name and power
limit.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]


def _params(exp: str) -> None:
    os.makedirs(exp)
    cfg = {
        "dir_path": exp, "in_channels": CHANNELS, "chamber": "PA", "segment_size": 1.5,
        "batch_size": 32, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 5, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 2, "min_RHC": -50, "use_global_min_max": False, "seed": 0,
        "eval_batch": 1024, "data_backend": "device",
    }
    with open(os.path.join(exp, "params.json"), "w") as f:
        json.dump(cfg, f)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("a")
    ap.add_argument("b")
    ap.add_argument("--rounds", type=int, default=2)
    args = ap.parse_args()
    checkouts = {"a": os.path.abspath(args.a), "b": os.path.abspath(args.b)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    root = tempfile.mkdtemp(prefix="ab_wall_")
    subprocess.run([sys.executable, "-c",
                    "import sys; from scgrhc_torch.utils.synth import make_synthetic_database; "
                    "make_synthetic_database(sys.argv[1], n_records=4, duration_s=1800.0, seed=0)",
                    os.path.join(root, "db")], cwd=checkouts["b"], check=True)
    env = dict(os.environ, SCGRHC_DATA=os.path.join(root, "db"))
    for side in ("a", "b"):  # build each checkout's kernels outside the timed runs
        subprocess.run([sys.executable, "-c", "from scgrhc_torch.ops.kernels import _build; "
                        "_build.build()"], cwd=checkouts[side], check=True)
    runs: dict[str, list[float]] = {"a": [], "b": []}
    order = [s for _ in range(args.rounds) for s in ("a", "b", "b", "a")]
    for i, side in enumerate(order):
        exp = os.path.join(root, f"run{i}_{side}")
        _params(exp)
        t0 = time.perf_counter()
        proc = subprocess.run([sys.executable, "-m", "scgrhc_torch", exp], cwd=checkouts[side],
                              env=env, capture_output=True, text=True, timeout=900)
        secs = time.perf_counter() - t0
        if proc.returncode != 0:
            print(proc.stderr[-3000:], file=sys.stderr)
            return 1
        runs[side].append(secs)
        print(f"run {i}: {side} ({checkouts[side]}) {secs:.2f} s", flush=True)
    print(json.dumps({"card": card, "checkouts": checkouts, "seconds": runs}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
