"""The readings that the limits of ``correct`` are set from, for many seeds in
one process: the program's numbers against the reference, the control's
(the reference computed with TF32 products, in the program's place) and
the numbers that a broken step gives.

    python3 benchmark/calibrate.py --workload <cell> --seeds 1,2,3 [--kinds program,control,half,frozen]

Prints one JSON line per seed and kind.
"""

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
os.environ.pop("SCGRHC_PROFILE_DIR", None)
sys.path[0] = str(ROOT)

import torch  # noqa: E402

from benchmark.lib import harness  # noqa: E402
from benchmark.lib.readings import train_readings  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--kinds", default="program,control")
    args = ap.parse_args()
    man = harness.manifest()
    cell, config, traffic, limits = harness.cell_files(man, args.workload)
    dev = torch.device("cuda:0" if torch.cuda.is_available() else "cpu")
    mod = harness.load_module(harness.BENCH / "drivers" / f"{traffic['driver']}.py", "driver")
    kinds = args.kinds.split(",")
    for seed in [int(s) for s in args.seeds.split(",")]:
        t0 = time.time()
        run = harness.Run(cell, config, traffic, limits, seed, 0.0, False, dev,
                          dev.type == "cuda", "")
        readings = train_readings(mod, run, kinds)
        for kind, checks in readings.items():
            print(json.dumps({"cell": args.workload, "seed": seed, "kind": kind,
                              "seconds": round(time.time() - t0, 1),
                              **{c["name"]: c["value"] for c in checks}}), flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
