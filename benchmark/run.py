"""Run one cell of ``BENCHMARK.json`` once on this machine's CUDA card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints the card's name and power limit, then (last on standard error) each
number that decides ``correct`` beside its limit, and as the last line of
standard output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer metrics), ``device``, with ``--trace 1`` ``breakdown``, and
``checks``.  Exits non-zero, printing no result, without a CUDA card, or
when JAX or the JAX package was loaded.
"""

import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# every build and kernel cache at a fixed path inside the checkout
os.environ["TORCH_EXTENSIONS_DIR"] = str(ROOT / "build" / "torch_extensions")
os.environ["TRITON_CACHE_DIR"] = str(ROOT / "build" / "triton_cache")
# the program's own tracing and debug switches stay off in a measured run
os.environ.pop("SCGRHC_PROFILE_DIR", None)
os.environ.pop("SCGRHC_DEBUG", None)
sys.path[0] = str(ROOT)  # the checkout's root, not this script's folder

from benchmark.lib.harness import main  # noqa: E402

if __name__ == "__main__":
    sys.exit(main())
