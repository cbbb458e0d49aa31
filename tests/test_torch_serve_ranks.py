"""The serve daemon with ``--mesh``, at world size 1 and over 2 ranks (gloo
worlds on the CPU through a ``file://`` store, the CLI in each rank), and
its rules over ranks (``scgrhc_torch/pipeline/serve.py``'s module doc).

  * World size 1: ``serve --mesh`` (a mesh of one) answers as the daemon
    without it, through ``serve.run`` and through the CLI.
  * Two ranks: a windowed request past one chunk (625 windows at T = 32,
    split over the ranks), a continuous request (20,000 samples: time-
    sharded), ``ping``, a bad record name and a missing record (one error
    line each, the same as world size 1's, and the daemon carries on),
    an idle stdin for longer than the stage group's timeout (set to 1.5 s:
    rank 0's keep-alive every 0.25 s holds the followers), ``ping``,
    ``quit``.  The answers equal world size 1's: the windowed waveform
    within RTOL of its scale (the batched convs' summation order), the
    continuous one within CONT_ATOL (tests/test_torch_predict_ranks.py).
    Rank 0 alone writes stdout and the .npy.
  * ``--timeout`` over ranks: a request past its deadline writes its error
    line and ends the daemon on both ranks.
  * A failure once the ranks compute together (rank 1's windowed compute
    raises): rank 0 writes the error line and both ranks end, well before
    the group's 60-s collective timeout.
"""

import io
import json
import os
import pickle
import time

import jax
import numpy as np
import pytest

from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.pipeline import serve
from test_torch_parallel import run_world

T = 32
RTOL = 1e-5  # tests/test_torch_parallel.py's predict --mesh against world size 1
CONT_ATOL = 1e-3
GROUP_TIMEOUT_S = 60
REQUESTS = [
    {"record": "SYN000"},
    {"record": "SYN000", "continuous": True, "save": False},
    {"cmd": "ping"},
    {"record": "../etc/passwd"},
    {"record": "NOPE"},
]
AFTER_IDLE = [{"cmd": "ping"}, {"cmd": "quit"}]

WORKER = r"""
import json, os, pickle, sys, time
rank, io_dir, case = int(sys.argv[1]), sys.argv[2], sys.argv[3]
import torch
torch.set_num_threads(1)
with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
from scgrhc_torch.parallel import comm
comm.STAGE_TIMEOUT_S = inp["stage_timeout"]
comm.init_distributed("file://" + os.path.join(io_dir, "store"), 2, rank, device="cpu",
                      timeout_s=inp["group_timeout"])
from scgrhc_torch.__main__ import main
from scgrhc_torch.core import paths
from scgrhc_torch.pipeline import serve
paths.set_data_path(inp["data"])
serve.KEEPALIVE_S = inp["keepalive"]
writes = []
if rank:
    def audit(event, args):
        path = str(args[0]) if args else ""
        if path.startswith(inp["exp"] + os.sep) and event == "open" and (
                args[1] is None or any(c in args[1] for c in "wax+")):
            writes.append(path)
    sys.addaudithook(audit)
    if case == "fail":
        def broken(*a, **k):
            raise RuntimeError("rank 1's compute failed")
        serve.predict_windows = broken

class Stdin:
    def __iter__(self):
        for item in inp["lines"]:
            if isinstance(item, float):
                time.sleep(item)
            else:
                yield item + "\n"

sys.stdin = Stdin()
sys.stdout = open(os.path.join(io_dir, f"stdout{rank}.txt"), "w")
t0 = time.time()
try:
    rc = main(["serve", inp["exp"], "last", "--mesh", "--device", "cpu", *inp["flags"]])
    err = None
except BaseException as e:
    rc, err = None, f"{type(e).__name__}: {e}"
finally:
    comm.destroy()
with open(os.path.join(io_dir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump({"rc": rc, "err": err, "writes": writes, "seconds": time.time() - t0}, f)
sys.stdout.flush()
sys.exit(0 if err is None else 1)
"""


def _exp(root, data):
    exp = root / "exp"
    os.makedirs(exp / "checkpoints")
    cfg = {
        "dir_path": str(exp), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"],
        "chamber": "PA", "segment_size": T / 500, "batch_size": 8,
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
    return str(exp)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    from scgrhc_torch.utils.synth import make_synthetic_database

    root = tmp_path_factory.mktemp("serve2")
    make_synthetic_database(str(root / "db"), n_records=1, duration_s=40.0, seed=4)
    return root, str(root / "db"), _exp(root, str(root / "db"))


def _world(setup, tmp_path_factory, case, lines, flags=(), stage_timeout=3600.0,
           keepalive=600.0):
    root, data, exp = setup
    tmp = tmp_path_factory.mktemp(case)
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump({"data": data, "exp": exp, "lines": lines, "flags": list(flags),
                     "stage_timeout": stage_timeout, "keepalive": keepalive,
                     "group_timeout": GROUP_TIMEOUT_S}, f)
    t0 = time.time()
    procs = run_world(tmp, WORKER, args=(case,))
    wall = time.time() - t0
    outs = []
    for r in range(2):
        path = tmp / f"out{r}.pkl"
        outs.append(pickle.load(open(path, "rb")) if path.exists() else None)
    answers = [json.loads(x) for x in (tmp / "stdout0.txt").read_text().splitlines()
               if x.startswith("{")]
    return procs, outs, answers, (tmp / "stdout1.txt").read_text(), wall


def _world_one(setup, monkeypatch, requests, mesh):
    _, data, exp = setup
    monkeypatch.setattr(tpaths, "DATA_PATH", data)
    monkeypatch.setattr(tpaths, "PROCESSED_DATA_PATH", os.path.join(data, "processed_data"))
    out = io.StringIO()
    serve.run(Params(os.path.join(exp, "params.json")), checkpoint="last", mesh=mesh,
              stdin=io.StringIO("\n".join(json.dumps(r) for r in requests) + "\n"),
              stdout=out, device="cpu")
    return [json.loads(x) for x in out.getvalue().splitlines()]


@pytest.fixture(scope="module")
def daemon(setup, tmp_path_factory):
    lines = [json.dumps(r) for r in REQUESTS] + [4.0] + [json.dumps(r) for r in AFTER_IDLE]
    return _world(setup, tmp_path_factory, "serve", lines, stage_timeout=1.5, keepalive=0.25)


def test_serve_mesh_at_world_one_equals_the_daemon_without_it(setup, monkeypatch, capsys):
    requests = [{"record": "SYN000", "save": False}, {"cmd": "ping"}]
    a = _world_one(setup, monkeypatch, requests, mesh=True)
    b = _world_one(setup, monkeypatch, requests, mesh=False)
    assert a[0]["waveform"] == b[0]["waveform"] and a[1] == b[1] == {
        "ok": True, "checkpoint": "003.checkpoint"}
    from scgrhc_torch.__main__ import main

    monkeypatch.setattr("sys.stdin", io.StringIO('{"cmd": "ping"}\n'))
    assert main(["serve", setup[2], "last", "--mesh", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out.splitlines()[-1])["ok"] is True


def test_two_ranks_answer_as_world_one(daemon, setup, monkeypatch):
    procs, outs, answers, stdout1, _ = daemon
    for p in procs:
        assert p.returncode == 0, p.stdout[-4000:]
    assert [o["rc"] for o in outs] == [0, 0] and outs[1]["writes"] == [] and stdout1 == ""
    _, _, exp = setup
    windowed = np.load(os.path.join(exp, "predictions", "SYN000.npy"))
    want = _world_one(setup, monkeypatch, REQUESTS + AFTER_IDLE, mesh=True)
    assert len(answers) == len(want) == 6  # quit has no answer
    strip = ("ms", "path", "waveform")
    for got, ref in zip(answers, want):
        assert {k: v for k, v in got.items() if k not in strip} == {
            k: v for k, v in ref.items() if k not in strip}
    one = np.load(os.path.join(exp, "predictions", "SYN000.npy"))
    assert windowed.shape == one.shape == (625 * T,)
    np.testing.assert_allclose(windowed, one, rtol=0, atol=RTOL * np.abs(one).max())
    cont, ref = np.asarray(answers[1]["waveform"]), np.asarray(want[1]["waveform"])
    assert cont.shape == ref.shape == (20_000,)
    np.testing.assert_allclose(cont, ref, rtol=0, atol=CONT_ATOL)
    assert answers[3]["error"].startswith("ValueError: invalid record name")
    assert answers[4]["error"].startswith("FileNotFoundError")


def test_two_ranks_outlive_the_stage_timeout_on_keep_alives(daemon):
    """The 4-s idle stdin is past the followers' 1.5-s wait in the line
    broadcast; the ping after it is answered and both ranks end at quit."""
    procs, outs, answers, _, _ = daemon
    assert [p.returncode for p in procs] == [0, 0]
    assert answers[-1] == {"ok": True, "checkpoint": "003.checkpoint"}
    assert min(o["seconds"] for o in outs) > 4.0


def test_an_expired_timeout_ends_every_rank(setup, tmp_path_factory):
    procs, outs, answers, _, wall = _world(
        setup, tmp_path_factory, "timeout", [json.dumps({"record": "SYN000"}),
                                             json.dumps({"cmd": "ping"})],
        flags=("--timeout", "0.001"))
    assert [p.returncode for p in procs] == [1, 1]
    assert len(answers) == 1 and "exceeded --timeout" in answers[0]["error"]
    assert wall < GROUP_TIMEOUT_S


def test_a_failure_among_the_ranks_ends_every_rank(setup, tmp_path_factory):
    procs, outs, answers, _, wall = _world(
        setup, tmp_path_factory, "fail", [json.dumps({"record": "SYN000"}),
                                          json.dumps({"cmd": "ping"})])
    assert [p.returncode for p in procs] == [1, 1]
    assert "rank 1's compute failed" in outs[1]["err"]
    assert len(answers) == 1 and "error" in answers[0]
    assert wall < GROUP_TIMEOUT_S
