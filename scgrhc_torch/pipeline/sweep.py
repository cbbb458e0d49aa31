"""Experiment-parallel sweep runner, the port's copy of
``scgrhc.pipeline.sweep``.

The reference runs its sweep serially in one process
(waveform_pipeline.py:33-37).  Configs never communicate, so each one runs
as its own process (``python -m scgrhc_torch <dir>``), ``jobs`` at a time;
on a host with several cards, ``device_ids`` pins config i to card
``device_ids[i % len(device_ids)]`` through ``CUDA_VISIBLE_DEVICES``.  Or
they run one after another in this process (``inproc``), where a failing
config is contained.  ``scgrhc`` also sets up JAX's persistent compilation
cache for the in-process runner; the port compiles no programs and has no
such step.
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from time import time

from scgrhc_torch.core.timelog import timelog


def run_experiment_process(dir_path: str, env_extra: dict | None = None,
                           device: str | None = None) -> int:
    """Run one experiment's full pipeline in a subprocess; ``--device`` is
    passed on when given."""
    env = dict(os.environ)
    if env_extra:
        env.update(env_extra)
    cmd = [sys.executable, "-m", "scgrhc_torch", dir_path]
    if device is not None:
        cmd += ["--device", device]
    return subprocess.run(cmd, env=env, check=False).returncode


def run_experiment_inproc(dir_path: str, device: str | None = None) -> int:
    """Run one experiment's full pipeline in THIS process.  A config's
    failure is printed and contained, as the reference pipeline contains a
    stage's (waveform_pipeline.py:12-22): every stage resumes, so a rerun
    finishes what is left."""
    from scgrhc_torch.core.params import Params
    from scgrhc_torch.pipeline import run as pipeline_run

    try:
        pipeline_run.run(Params(os.path.join(dir_path, "params.json")), device=device)
        return 0
    except Exception as e:
        print(f"sweep | {dir_path} failed in-process: {e!r}")
        return 1


def prune_checkpoints(dir_path: str) -> int:
    """Keep the first, best and last checkpoints, delete the rest; returns
    how many went.

    A finished config's comparison CSVs, ``checkpoint_scores.csv`` and
    ``checkpoint_best.txt`` record every epoch's scores; the checkpoint
    files are needed again only to resume (last), for the final test
    (best) or to audit a restart (first).  At 250 epochs a config holds
    about 10 GB of them, so ``sweep --prune`` reclaims them as each config
    exits 0.  The best (from checkpoint_best.txt) is never removed;
    ``NNN.checkpoint.orbax`` directories count like files."""
    cdir = os.path.join(dir_path, "checkpoints")
    if not os.path.isdir(cdir):
        return 0
    names = sorted(n for n in os.listdir(cdir)
                   if n.endswith(".checkpoint") or n.endswith(".checkpoint.orbax"))
    if not names:
        return 0
    keep = {names[0], names[-1]}
    best_txt = os.path.join(dir_path, "checkpoint_best.txt")
    if os.path.exists(best_txt):
        with open(best_txt) as f:
            for tok in f.read().split():
                if tok.endswith(".checkpoint"):
                    keep.update((tok, tok + ".orbax"))
    removed = 0
    for n in names:
        if n not in keep:
            p = os.path.join(cdir, n)
            if os.path.isdir(p):
                shutil.rmtree(p)
            else:
                os.remove(p)
            removed += 1
    return removed


def run_sweep(dir_paths: list[str], jobs: int = 1, device_ids: list[int] | None = None,
              inproc: bool = False, prune: bool = False,
              device: str | None = None) -> dict[str, int]:
    """Run the experiments, ``jobs`` processes at a time, or serially in
    this process with ``inproc`` (jobs ≤ 1).  ``device_ids`` pins
    experiment i's process to card ``device_ids[i % len(device_ids)]``;
    ``device`` goes to every experiment (``cuda`` by default, ``cpu``);
    ``prune`` reclaims each successful config's checkpoints as it finishes
    (:func:`prune_checkpoints`).  Returns dir_path → exit code."""
    if inproc and jobs > 1:
        raise ValueError("inproc sweep requires jobs=1 (one process, one card)")
    start = time()

    def launch(i_dir):
        i, dir_path = i_dir
        env_extra = {}
        if device_ids:
            env_extra["CUDA_VISIBLE_DEVICES"] = str(device_ids[i % len(device_ids)])
        print(timelog(f"sweep | start {dir_path}", start))
        if inproc:
            code = run_experiment_inproc(dir_path, device)
        else:
            code = run_experiment_process(dir_path, env_extra, device)
        if prune and code == 0:
            n = prune_checkpoints(dir_path)
            if n:
                print(timelog(f"sweep | pruned {n} checkpoints in {dir_path}", start))
        print(timelog(f"sweep | done {dir_path} (exit {code})", start))
        return dir_path, code

    if jobs <= 1:
        results = dict(map(launch, enumerate(dir_paths)))
    else:
        with ThreadPoolExecutor(max_workers=jobs) as pool:
            results = dict(pool.map(launch, enumerate(dir_paths)))
    failed = [d for d, c in results.items() if c != 0]
    if failed:
        print(timelog(f"sweep | {len(failed)} failed: {failed}", start))
    return results
