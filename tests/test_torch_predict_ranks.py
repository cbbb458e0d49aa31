"""Continuous prediction over ranks (``predict <dir> <record> last
--continuous`` in a 2-rank gloo world on the CPU, through the CLI) against
world size 1 and ``scgrhc``.

Every rank reads the whole record and normalizes it with its whole-record
(lo, hi); the rule is ``scgrhc``'s: ``apply_cp`` over the ``time`` axis
when the length divides the ranks, else ``apply_continuous``.

  * An 8-s record (4,000 samples: it divides by 2 and by the conftest's 8
    devices, so both packages run their time-sharded ``apply_cp``): the
    port's world 2 ran ``apply_cp``, and it is within CONT_ATOL of world
    size 1 and of ``scgrhc``'s ``predict --continuous``
    (tests/test_torch_predict.py's cross-package f32 envelope).  On the
    CPU the two port paths are different f32 arithmetic (the one-launch
    layer's plain version normalizes with ``mean``, the phases with sums
    over halo'd blocks, and the convs run at other lengths), and 14
    instance norms amplify the rounding: measured 1.8e-4 on outputs up to
    about 4.
  * An 8.002-s record (4,001 samples, odd): world 2 ran
    ``apply_continuous`` on each rank, equal to world size 1 bit for bit.
  * Only rank 0 wrote (an audit hook on rank 1 saw no write under the
    experiment).
"""

import json
import os
import pickle

import jax
import numpy as np
import pytest

from scgrhc.core import paths as jpaths
from scgrhc.core.params import Params as JParams
from scgrhc.pipeline import predict as jpredict
from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.pipeline import predict as tpredict
from test_torch_parallel import run_world

RECORDS = {"even": 8.0, "odd": 8.002}  # 4,000 and 4,001 samples at 500 Hz
CONT_ATOL = 1e-3  # tests/test_torch_predict.py

WORKER = r"""
import os, pickle, shutil, sys
rank, io_dir = int(sys.argv[1]), sys.argv[2]
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm
comm.init_distributed("file://" + os.path.join(io_dir, "store"), 2, rank, device="cpu",
                      timeout_s=60)
with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
writes = []
if rank:
    def audit(event, args):
        path = str(args[0]) if args else ""
        if path.startswith(inp["exp"] + os.sep) and (
                event in ("os.rename", "os.replace", "os.remove")
                or (event == "open" and (args[1] is None or any(c in args[1] for c in "wax+")))):
            writes.append(path)
    sys.addaudithook(audit)
from scgrhc_torch.__main__ import main
from scgrhc_torch.core import paths
from scgrhc_torch.models import cp
calls = []
for name in ("apply_cp", "apply_continuous"):
    def wrapped(*a, _fn=getattr(cp, name), _name=name, **k):
        calls.append(_name)
        return _fn(*a, **k)
    setattr(cp, name, wrapped)
out = {}
for key, data in inp["data"].items():
    paths.set_data_path(data)
    calls.clear()
    rc = main(["predict", inp["exp"], "SYN000", "last", "--continuous", "--device", "cpu"])
    out[key] = {"rc": rc, "calls": list(calls)}
    if rank == 0:
        shutil.copy(os.path.join(inp["exp"], "predictions", "SYN000.npy"),
                    os.path.join(io_dir, f"{key}.npy"))
    comm.barrier("copied")
out["writes"] = writes
with open(os.path.join(io_dir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
comm.destroy()
"""


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    from scgrhc_torch.utils.synth import make_synthetic_database

    tmp = tmp_path_factory.mktemp("predict2")
    data = {}
    for key, seconds in RECORDS.items():
        make_synthetic_database(str(tmp / key), n_records=1, duration_s=seconds, seed=3)
        data[key] = str(tmp / key)
    exp = tmp / "exp"
    os.makedirs(exp / "checkpoints")
    cfg = {
        "dir_path": str(exp), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"],
        "chamber": "PA", "segment_size": 1.5, "batch_size": 8,
        "train_path": "loader_train.pickle", "valid_path": "loader_valid.pickle",
        "test_path": "loader_test.pickle", "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "comparisons", "pred_top_dir_path": "pred_top",
        "pred_rand_dir_path": "pred_rand", "alpha": 1e-4, "beta1": 0.5, "beta2": 0.999,
        "n_critic": 2, "lambda_gp": 10, "lambda_aux": 100, "total_epochs": 1,
        "min_RHC": -50, "use_global_min_max": False,
    }
    (exp / "params.json").write_text(json.dumps(cfg))
    jckpt.save(str(exp / "checkpoints" / "003.checkpoint"), start_time=0.0, epoch=3,
               g_losses=[], d_losses=[], state=init_state(jax.random.key(0), 2, TrainConfig()))
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"data": data, "exp": str(exp)}, f)
    procs = run_world(tmp, WORKER)
    for p in procs:
        assert p.returncode == 0, p.stdout[-4000:]
    ranks = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    return tmp, data, str(exp), ranks


def _world_one(data: str, exp: str, out_dir: str, monkeypatch):
    for mod in (tpaths, jpaths):
        monkeypatch.setattr(mod, "DATA_PATH", data)
        monkeypatch.setattr(mod, "PROCESSED_DATA_PATH", os.path.join(data, "processed_data"))
    return np.load(tpredict.run(Params(os.path.join(exp, "params.json")), "SYN000", "last",
                                continuous=True, device="cpu", out_dir=out_dir))


def test_even_record_runs_apply_cp_and_matches_world_one_and_scgrhc(world, tmp_path,
                                                                      monkeypatch):
    tmp, data, exp, ranks = world
    for rec in ranks:
        assert rec["even"] == {"rc": 0, "calls": ["apply_cp"]}
    got = np.load(tmp / "even.npy")
    assert got.shape == (4000,) and np.isfinite(got).all()
    want = _world_one(data["even"], exp, str(tmp_path / "one"), monkeypatch)
    np.testing.assert_allclose(got, want, rtol=0, atol=CONT_ATOL)
    theirs = np.load(jpredict.run(JParams(os.path.join(exp, "params.json")), "SYN000", "last",
                                  out_dir=str(tmp_path / "jax"), continuous=True))
    np.testing.assert_allclose(got, theirs, rtol=0, atol=CONT_ATOL)


def test_odd_record_runs_apply_continuous_on_each_rank(world, tmp_path, monkeypatch):
    tmp, data, exp, ranks = world
    for rec in ranks:
        assert rec["odd"] == {"rc": 0, "calls": ["apply_continuous"]}
    got = np.load(tmp / "odd.npy")
    assert got.shape == (4001,)
    np.testing.assert_array_equal(got, _world_one(data["odd"], exp, str(tmp_path / "one"),
                                                  monkeypatch))


def test_only_rank_zero_writes(world):
    _, _, exp, ranks = world
    assert ranks[1]["writes"] == []
    assert os.path.exists(os.path.join(exp, "predictions", "SYN000.json"))
