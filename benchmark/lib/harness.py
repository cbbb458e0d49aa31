"""One run of one cell: find its files by name, drive the program, read the
metrics, decide ``correct`` and print the result line.

A run: refuse without the cards the cell asks for; print the card's name
and power limit; let the traffic's driver set up, warm every shape the
traffic uses and measure the window (with ``--trace 1`` also a traced
window after it); read ``memory_peak_bytes``; switch TF32 off; let the
driver free the program's state and compare what the timed path produced
with the plain reference; refuse if JAX or the JAX package was loaded;
print the compared numbers beside their limits on standard error, and the
result line last on standard output.

A driver (``drivers/<name>.py``) defines ``Driver(run)`` with
``measure() -> (end_to_end values, attempted, failed)``, which sets
``run.setup_end`` (wall time of the first timed unit of work), ``run.window``
(the window's counters) and, with ``--trace 1``, ``run.summary`` and
``run.traced``; and ``check() -> [{"name", "value", "limit"}, ...]``.  A
per-layer metric (``metrics/<name>.py``) defines ``read(run)``, which
returns a number or None when it finds nothing to read.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path

from benchmark.lib import gpu

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "benchmark"


def process_start() -> float:
    """Wall time at which this process started (Linux), else now."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.time() - (uptime - ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.time()


@dataclass
class Run:
    cell: dict
    config: dict
    traffic: dict
    limits: dict
    seed: int
    seconds: float
    trace: bool
    device: object
    on_card: bool
    tmpdir: str
    setup_end: float = 0.0
    window: dict = field(default_factory=dict)
    traced: dict = field(default_factory=dict)
    summary: object = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str):
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"no file {path}")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def find(entries: list[dict], name: str, what: str) -> dict:
    for e in entries:
        if e["name"] == name:
            return e
    raise KeyError(f"BENCHMARK.json has no {what} named {name!r}")


def applies(metric: dict, cell: str, man: dict | None = None) -> bool:
    """Whether ``metric`` is reported in ``cell``: the cells its ``workloads``
    lists; without the key, every cell, or for a per-layer metric every cell
    that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    if man is None or "moves" not in metric:
        return True
    return applies(find(man["end_to_end"], metric["moves"], "end-to-end metric"), cell)


def cell_files(man: dict, cell_name: str) -> tuple[dict, dict, dict, dict]:
    """(cell, config, traffic, limits) of a cell, each from its own file."""
    cell = find(man["workloads"], cell_name, "workload")
    conf = find(man["configs"], cell["config"], "config")
    return (cell, load_json(ROOT / conf["file"]),
            load_json(BENCH / "traffic" / f"{cell['traffic']}.json"),
            load_json(BENCH / "limits" / f"{cell_name}.json"))


def driver_class(traffic: dict):
    name = traffic["driver"]
    return load_module(BENCH / "drivers" / f"{name}.py", f"benchmark_driver_{name}").Driver


def read_metric(name: str, run: Run):
    mod = load_module(BENCH / "metrics" / f"{name}.py", f"benchmark_metric_{name}")
    return mod.read(run)


def _number(v):
    return v if isinstance(v, (int, float)) and math.isfinite(v) else str(v)


def main(argv=None, allow_cpu: bool = False, shrink: dict | None = None) -> int:
    """Run one cell once.  ``allow_cpu`` and ``shrink`` ({"config": {...},
    "traffic": {...}} overrides) serve the CPU tests: a run on the CPU
    reports platform ``cpu`` and leaves out every device metric."""
    t_proc = process_start()
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = manifest()
    cell, config, traffic, limits = cell_files(man, args.workload)
    if shrink:
        config = {**config, **shrink.get("config", {})}
        traffic = {**traffic, **shrink.get("traffic", {})}
    chips = int(cell["chips"])

    import torch

    try:
        gpu.require_cards(chips)
        on_card = True
    except gpu.NoCard as e:
        if not allow_cpu:
            print(f"benchmark: {e}", file=sys.stderr)
            return 2
        on_card = False
    if on_card:
        print(f"benchmark: card {gpu.power_line()}", file=sys.stderr, flush=True)
        torch.cuda.reset_peak_memory_stats()
    tmpdir = tempfile.mkdtemp(prefix="benchmark-run-")
    try:
        run = Run(cell, config, traffic, limits, args.seed, args.seconds, bool(args.trace),
                  torch.device("cuda:0" if on_card else "cpu"), on_card, tmpdir)
        driver = driver_class(traffic)(run)
        values, attempted, failed = driver.measure()
        device = gpu.device_record(chips, on_card)
        values["setup_s"] = run.setup_end - t_proc
        if run.trace:
            metrics = {}
            for m in man["per_layer"]:
                if applies(m, cell["name"], man):
                    v = read_metric(m["name"], run)
                    if v is not None:
                        metrics[m["name"]] = {"value": v, "unit": m["unit"]}
            if run.summary is not None and on_card:
                device["busy_s"] = run.summary.busy_s
                device["window_s"] = run.summary.window_s
        else:
            metrics = {m["name"]: {"value": values[m["name"]], "unit": m["unit"]}
                       for m in man["end_to_end"] if applies(m, cell["name"])}
        # the reference runs in the float32 the configuration states, whatever
        # precision the program left set
        gpu.tf32(False)
        checks = driver.check()
    finally:
        shutil.rmtree(tmpdir, ignore_errors=True)

    found = gpu.forbidden_modules()
    if found:
        print(f"benchmark: modules of JAX or the JAX package were loaded: {found}",
              file=sys.stderr)
        return 3
    correct = failed == 0 and all(c["value"] <= c["limit"] for c in checks)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    sys.stderr.flush()
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device}
    if run.trace and run.summary is not None and on_card:
        result["breakdown"] = {"device_ops": run.summary.device_ops,
                               "idle_gaps": run.summary.idle_gaps}
    result["checks"] = {c["name"]: {"value": _number(c["value"]), "limit": c["limit"]}
                        for c in checks}
    print(json.dumps(result), flush=True)
    return 0
