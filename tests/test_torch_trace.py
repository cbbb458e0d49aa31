"""The port's tracing and debug modes (``scgrhc_torch.core.trace``,
``scgrhc_torch.core.debug``), on the CPU.

  * Unset, ``SCGRHC_PROFILE_DIR`` creates no profiler: a training run and
    an eval run go through with ``torch.profiler.profile`` made to fail.
  * Set, a tiny training run (the verify recipe's drive: a 16-s synthetic
    record at T = 32) writes one Chrome trace under ``train/`` holding the
    ``train_epoch`` spans (epoch mode) or ``train_step`` spans (step mode),
    one per epoch or step, as ``scgrhc``'s spans sit
    (``scgrhc/train/run.py:159,313,375,412``); ``test <split> all`` writes
    one trace per checkpoint under ``eval_valid/``, none overwritten
    (``scgrhc/eval/run.py:310``).
  * ``SCGRHC_DEBUG=nan`` (and ``all``) turns anomaly detection on at
    package import, and a NaN cotangent through K1f's autograd Function
    (its plain backward on the CPU) raises naming the node; ``nojit`` and
    an empty value leave it off, and the same backward returns NaN
    silently.
"""

import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from scgrhc_torch.core import debug, trace
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.data import run as data_run
from scgrhc_torch.eval import run as eval_run
from scgrhc_torch.train import run as train_run
from scgrhc_torch.utils.synth import make_synthetic_database

ROOT = Path(__file__).resolve().parents[1]


def _tiny_exp(tmp_path, monkeypatch, **extra) -> Params:
    """The verify recipe's CPU drive: one 16-s synthetic record, windows of
    32 samples (segment_size 0.064), batch 16, n_critic 1, 2 epochs, its
    loader files written by the port's data stage."""
    db = make_synthetic_database(str(tmp_path / "db"), n_records=1, duration_s=16.0, seed=3)
    monkeypatch.setattr(tpaths, "DATA_PATH", os.path.dirname(db))
    monkeypatch.setattr(tpaths, "PROCESSED_DATA_PATH", db)
    d = tmp_path / "exp"
    d.mkdir()
    cfg = {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ECG"], "chamber": "PA",
        "segment_size": 0.064, "batch_size": 16, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 2, "min_RHC": -50, "use_global_min_max": False, "seed": 0, **extra,
    }
    (d / "params.json").write_text(json.dumps(cfg))
    params = Params(str(d / "params.json"))
    data_run.run(params, device="cpu")
    return params


def _events(path) -> list[dict]:
    with open(path) as f:
        return [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]


def test_unset_creates_no_profiler(tmp_path, monkeypatch):
    monkeypatch.delenv(trace.ENV_VAR, raising=False)

    def refuse(*args, **kwargs):
        raise AssertionError("a profiler was created with SCGRHC_PROFILE_DIR unset")

    monkeypatch.setattr(torch.profiler, "profile", refuse)
    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    assert trace.profile_dir() is None
    with trace.trace("x"), trace.annotate("y"):
        pass
    params = _tiny_exp(tmp_path, monkeypatch, total_epochs=1)
    assert train_run.run(params, device="cpu", plot=False)["epochs"]
    eval_run.run(params, "valid", "all", device="cpu")
    assert not (tmp_path / "exp" / "train").exists()
    assert os.listdir(params.comparison_dir_path) == ["valid"]


@pytest.mark.parametrize("mode,span", [("epoch", "train_epoch"), ("step", "train_step")])
def test_training_writes_a_trace_with_its_spans(tmp_path, monkeypatch, mode, span):
    out = tmp_path / "profile"
    monkeypatch.setenv(trace.ENV_VAR, str(out))
    params = _tiny_exp(tmp_path, monkeypatch, train_mode=mode)
    stats = train_run.run(params, device="cpu", plot=False)
    files = os.listdir(out / "train")
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    events = _events(out / "train" / files[0])
    spans = [e for e in events if e["name"] == span and e.get("cat") == "user_annotation"]
    steps = sum(e["steps"] for e in stats["epochs"])
    assert len(spans) == (len(stats["epochs"]) if mode == "epoch" else steps) > 0
    # the spans hold the step's operators: the K1f and K2f wrappers' plain
    # convolutions on the CPU
    s = spans[0]
    inside = {e["name"] for e in events
              if s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]}
    assert "aten::convolution" in inside and "Optimizer.step#Adam.step" in inside


def test_eval_writes_one_trace_per_checkpoint(tmp_path, monkeypatch):
    params = _tiny_exp(tmp_path, monkeypatch)
    train_run.run(params, device="cpu", plot=False)
    out = tmp_path / "profile"
    monkeypatch.setenv(trace.ENV_VAR, str(out))
    eval_run.run(params, "valid", "all", device="cpu")
    files = sorted(os.listdir(out / "eval_valid"))
    assert len(files) == 2 and all(f.endswith(".pt.trace.json") for f in files)
    assert sorted(os.listdir(os.path.join(params.comparison_dir_path, "valid"))) == [
        "000.csv", "001.csv"]
    for f in files:
        names = {e["name"] for e in _events(out / "eval_valid" / f)}
        assert "aten::convolution" in names
    assert sorted(os.listdir(out)) == ["eval_valid"]


_NAN_PROBE = r"""
import json, torch
import scgrhc_torch
from scgrhc_torch.ops.kernels.conv_block import ConvInReLU
g = torch.Generator().manual_seed(0)
x = torch.randn(2, 3, 16, generator=g, requires_grad=True)
w = torch.randn(4, 3, 3, generator=g, requires_grad=True)
b = torch.zeros(4, requires_grad=True)
y = ConvInReLU.apply(x, w, b)
try:
    y.backward(torch.full_like(y, float("nan")))
    res = {"raised": None, "dx_nan": bool(torch.isnan(x.grad).any())}
except RuntimeError as e:
    res = {"raised": str(e)}
print(json.dumps({"anomaly": torch.is_anomaly_enabled(), **res}))
"""


@pytest.mark.parametrize("mode,on", [("nan", True), ("all", True), ("nojit", False), ("", False)])
def test_debug_env_at_import(mode, on):
    env = dict(os.environ, PYTHONPATH=str(ROOT), SCGRHC_DEBUG=mode)
    out = subprocess.run([sys.executable, "-c", _NAN_PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["anomaly"] is on
    if on:
        assert "ConvInReLUBackward" in res["raised"] and "nan" in res["raised"]
    else:
        assert res["raised"] is None and res["dx_nan"]


def test_debug_refuses_an_unknown_mode():
    with pytest.raises(ValueError, match="SCGRHC_DEBUG"):
        debug.enable("everything")
