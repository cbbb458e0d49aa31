"""The port's pipeline over a 2-rank gloo world on the CPU, against one
process and against ``scgrhc``.

``python -m scgrhc_torch <dir> --device cpu`` (data with the device
backend → train 2 epochs → test valid all → select → test test best) runs
at world size 1 and, at the same time, at world size 2 (two processes
joined through a ``file://`` store in ``tmp_path``, one thread each):

  * the loader files are byte-identical, and so is ``record_log.txt`` but
    for its first line, which holds the time it was written;
  * the two experiments hold the same files, and rank 1 wrote none of them
    (an audit hook records every file it opens for writing, renames or
    removes under the experiment);
  * the trained weights agree within the envelope measured for this
    configuration (below), and ``scgrhc`` reads the world-2 checkpoint
    back to the same weights.

Then a failure on rank 0 ends every rank with an error, well within the
process-group timeout: in the data stage and at a checkpoint write (the
writes that rank 0 alone makes), and in a training step (rank 0 leaves
while rank 1 waits in a gradient all-reduce).
"""

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import numpy as np
import pytest

from scgrhc.train import checkpoint as jckpt
from scgrhc.train import wgan as jwgan
from scgrhc_torch.data.loaders import SegmentLoader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.models import convert
from scgrhc_torch.train import checkpoint as ckpt_io

ROOT = Path(__file__).resolve().parents[1]
T = 32
PG_TIMEOUT_S = 60
# The cross-process gradient sum adds each rank's half in another order
# than one process sums the whole batch, so the trajectories part at f32
# rounding from the first update on, and the WGAN dynamics amplify it
# (tests/test_multihost.py measures the same in scgrhc).  Measured here:
# weights max-abs 4.0e-4 after epoch 0 and 7.1e-4 after epoch 1; the
# bound is about 3x.
WEIGHT_ENVELOPE = 2e-3
LOSS0_RTOL = 1e-6  # the first critic loss: one forward, summed in two halves

WORKER = r"""
import json, os, sys
rank, io_dir, world, cmd, exp, data, fail = sys.argv[1:8]
rank, world = int(rank), int(world)
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm
if world > 1:
    comm.init_distributed("file://" + os.path.join(io_dir, "store"), world, rank, device="cpu",
                          timeout_s=int(os.environ["PG_TIMEOUT_S"]))
writes = []
def audit(event, args):
    path = str(args[0]) if args else ""
    if not path.startswith(exp + os.sep):
        return
    if event == "open" and (args[1] is None or any(c in args[1] for c in "wax+")):
        writes.append(os.path.relpath(path, exp))
    elif event in ("os.rename", "os.replace", "os.remove"):
        writes.append(os.path.relpath(path, exp))
sys.addaudithook(audit)
from scgrhc_torch.core import paths
paths.set_data_path(data)
if rank == 0 and fail != "none":
    def disk_full(*a, **k):
        raise OSError("disk full")
    if fail == "data":
        from scgrhc_torch.data import run as data_run
        data_run.save_dataloaders = disk_full
    elif fail == "checkpoint":
        from scgrhc_torch.train import checkpoint as ckpt_io
        ckpt_io.save = disk_full
    else:
        from scgrhc_torch.parallel import dp
        from scgrhc_torch.train import wgan
        steps = [0]
        def failing_step(*a, **k):
            steps[0] += 1
            if steps[0] == 2:
                raise FloatingPointError("step 2 failed on rank 0")
            return wgan.train_step(*a, **k)
        dp.train_step = failing_step
from scgrhc_torch.__main__ import main
rc = main(([cmd] if cmd != "pipeline" else []) + [exp, "--device", "cpu"])
print("RESULT " + json.dumps({"rc": rc, "writes": writes}), flush=True)
"""


def _params(d, **extra) -> str:
    cfg = {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"], "chamber": "PA",
        "segment_size": T / 500, "batch_size": 16, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 2, "min_RHC": -50, "use_global_min_max": False, "seed": 2,
        "eval_batch": 4, "data_backend": "device", **extra,
    }
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "params.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _launch(io_dir, world: int, rank: int, cmd: str, exp, data: str, fail: str = "none"):
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1",
               PG_TIMEOUT_S=str(PG_TIMEOUT_S))
    return subprocess.Popen(
        [sys.executable, "-c", WORKER, str(rank), str(io_dir), str(world), cmd, str(exp),
         data, fail], cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True)


def _finish(procs, timeout: float) -> list[tuple[int, str]]:
    """(returncode, output) of each process; all are killed when they run
    over ``timeout`` together."""
    out, deadline = [], time.monotonic() + timeout
    try:
        for p in procs:
            text, _ = p.communicate(timeout=max(1.0, deadline - time.monotonic()))
            out.append((p.returncode, text))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return out


def _result(text: str) -> dict:
    return json.loads(next(line for line in text.splitlines()
                           if line.startswith("RESULT "))[len("RESULT "):])


def _files(root) -> set:
    return {os.path.relpath(os.path.join(b, f), root) for b, _, fs in os.walk(root) for f in fs}


def _max_weight_diff(a: dict, b: dict) -> float:
    return max(float(np.abs(np.asarray(a[k][p]) - np.asarray(b[k][p])).max())
               for k in ("g_state_dict", "d_state_dict") for p in a[k])


def test_pipeline_world_two_matches_world_one(tmp_path):
    from scgrhc_torch.utils.synth import make_synthetic_database

    db = make_synthetic_database(str(tmp_path / "db"), n_records=1, duration_s=16.0, seed=3)
    data = os.path.dirname(db)
    one, two = tmp_path / "one", tmp_path / "two"
    _params(one)
    _params(two)
    procs = [_launch(tmp_path, 1, 0, "pipeline", one, data)]
    procs += [_launch(tmp_path, 2, r, "pipeline", two, data) for r in range(2)]
    done = _finish(procs, 300)
    for rc, text in done:
        assert rc == 0, text[-4000:]
    (_, log1), (_, log0), (_, log_r1) = done
    assert "2 rank(s) over gloo (ranks on the CPU)" in log0
    assert "Run waveform_train" in log_r1 and "waveform_train |" not in log_r1  # rank 0 logs

    # (a) the loader files and the record log
    for name in ("loader_train.pickle", "loader_valid.pickle", "loader_test.pickle"):
        assert (one / name).read_bytes() == (two / name).read_bytes(), name
    log = (one / "record_log.txt").read_text().splitlines()
    assert log[1:] == (two / "record_log.txt").read_text().splitlines()[1:]
    assert log[0].startswith("Dataset created: ") and int(log[1].split()[-1]) > 20
    # (b) the same artifacts, all written by rank 0
    assert _files(one) == _files(two)
    assert {"checkpoints/000.checkpoint", "checkpoints/001.checkpoint", "checkpoint_best.txt",
            "checkpoint_scores.csv", "comparisons/valid/000.csv"} <= _files(two)
    assert _result(log_r1)["writes"] == []
    assert "checkpoint_best.txt" in _result(log0)["writes"]
    # (c) the trained weights, within the envelope
    for epoch in (0, 1):
        a = ckpt_io.load(str(one / "checkpoints" / f"{epoch:03d}.checkpoint"))
        b = ckpt_io.load(str(two / "checkpoints" / f"{epoch:03d}.checkpoint"))
        assert len(a["g_losses"]) == len(b["g_losses"]) == 2 * (epoch + 1)
        np.testing.assert_allclose(b["d_losses"][0], a["d_losses"][0], rtol=LOSS0_RTOL)
        assert np.isfinite(b["g_losses"] + b["d_losses"]).all()
        assert _max_weight_diff(a, b) <= WEIGHT_ENVELOPE, (epoch, _max_weight_diff(a, b))
    # (d) scgrhc reads the world-2 checkpoint back
    path = str(two / "checkpoints" / "001.checkpoint")
    st = jckpt.restore_state(jckpt.load(path), jwgan.TrainConfig(n_critic=1), 2)
    theirs = convert.state_dict_from_jax_params(jax.tree.map(np.asarray, st.g_params))
    for k, v in ckpt_io.load(path)["g_state_dict"].items():
        np.testing.assert_array_equal(theirs[k], v, err_msg=k)
    best = (two / "checkpoint_best.txt").read_text().split()[1]
    assert (two / "comparisons" / "test" / (best.split(".")[0] + ".csv")).exists()


def _train_experiment(d):
    _params(d, total_epochs=1, batch_size=4)
    rng = np.random.default_rng(2)
    store = SegmentStore.from_windows(rng.random((10, T, 2)) * 5 - 2,
                                      rng.random((10, T, 1)) * 40 + 5, "SYN000",
                                      np.arange(10) * T)
    SegmentLoader(store, 4, seed=3).save(os.path.join(d, "loader_train.pickle"))


@pytest.mark.parametrize("fail", ["data", "checkpoint", "step"])
def test_rank_zero_failure_ends_every_rank(tmp_path, fail):
    """Rank 0 fails (its data-stage write, its checkpoint write, or its
    second training step); both ranks exit with an error well within the
    process-group timeout, and rank 1 names rank 0's error where rank 0
    alone wrote."""
    exp = tmp_path / "exp"
    data = str(tmp_path)  # the data stage fails before it reads a record
    if fail == "data":
        _params(exp)
    else:
        _train_experiment(exp)
    cmd = "data" if fail == "data" else "train"
    t0 = time.monotonic()
    (rc0, out0), (rc1, out1) = _finish(
        [_launch(tmp_path, 2, r, cmd, exp, data, fail) for r in range(2)], PG_TIMEOUT_S + 60)
    took = time.monotonic() - t0
    assert rc0 != 0 and rc1 != 0, (out0[-2000:], out1[-2000:])
    assert took < PG_TIMEOUT_S, took
    if fail == "data":
        assert "RuntimeError: data_end: rank 0 failed: OSError: disk full" in out1
        assert not (exp / "loader_train.pickle").exists()
    elif fail == "checkpoint":
        assert "RuntimeError: train_checkpoint: rank 0 failed: OSError: disk full" in out1
    else:
        assert "step 2 failed on rank 0" in out0


SLOW_WORKER = r"""
import sys, time
rank, io_dir, wait = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm
comm.init_distributed("file://" + io_dir + "/store", 2, rank, device="cpu", timeout_s=2)
def work():
    time.sleep(6)
    return "done"
if wait == "on_primary":
    out = comm.on_primary("slow", work)
else:  # the group's own collective
    out = work() if rank == 0 else None
    comm.barrier("slow")
comm.barrier("after")
print("DONE", rank, out, flush=True)
comm.destroy()
"""


@pytest.mark.parametrize("wait", ["on_primary", "barrier"])
def test_rank_zero_works_alone_past_the_group_timeout(tmp_path, wait):
    """Rank 0 works alone for 6 s (as over a whole cohort's data stage, or a
    first build of the kernels) in a group whose collectives time out at
    2 s.  In ``on_primary`` the other rank waits on the stage group
    (``STAGE_TIMEOUT_S``) and both ranks finish; waiting in one of the
    group's own collectives instead, rank 1 times out."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", SLOW_WORKER, str(r), str(tmp_path), wait],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    (rc0, out0), (rc1, out1) = _finish(procs, 90)
    if wait == "on_primary":
        assert rc0 == rc1 == 0, (out0[-2000:], out1[-2000:])
        assert "DONE 0 done" in out0 and "DONE 1 None" in out1
    else:
        assert rc1 != 0 and "DONE" not in out1, out1[-2000:]


BUILD_WORKER = r"""
import sys, time
rank, io_dir = sys.argv[1], sys.argv[2]
from pathlib import Path
from scgrhc_torch.ops.kernels import _build
_build.BUILD_DIR = Path(io_dir) / "build"
_build._nvcc = lambda: str(Path(io_dir) / "nvcc")
_build.ctypes.CDLL = lambda path: type("Lib", (), {n: type("Fn", (), {})()
                                                   for n in _build._SIGNATURES})()
while not (Path(io_dir) / "go").exists():  # both ranks start their builds at once
    time.sleep(0.01)
b = _build.build()
print("BUILT", b.path.name, b.seconds > 0, flush=True)
"""

FAKE_NVCC = """#!{python}
import sys, time
time.sleep(0.3)
out = sys.argv[sys.argv.index("-o") + 1]
with open(out, "w") as f:
    f.write("object" if "-c" in sys.argv else "library")
"""


def test_concurrent_first_builds_share_one_library(tmp_path):
    """Two ranks that find no built library compile at once into the same
    build directory (``_build``: per-process temporary names, then one
    ``os.replace``): both load the one library, and no temporary file is
    left.  ``nvcc`` and the loader are stand-ins: the CPU has neither."""
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable))
    nvcc.chmod(0o755)
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    procs = [subprocess.Popen([sys.executable, "-c", BUILD_WORKER, str(r), str(tmp_path)],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(2)]
    time.sleep(1.0)
    (tmp_path / "go").touch()
    done = _finish(procs, 60)
    names = set()
    for rc, text in done:
        assert rc == 0, text[-3000:]
        names.add(next(line for line in text.splitlines() if line.startswith("BUILT")).split()[1])
    assert len(names) == 1
    assert [p.name for p in (tmp_path / "build").iterdir()] == [names.pop()]
