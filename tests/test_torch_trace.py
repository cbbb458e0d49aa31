"""The port's tracing and debug modes (``scgrhc_torch.core.trace``,
``scgrhc_torch.core.debug``), on the CPU.

  * Unset, ``SCGRHC_PROFILE_DIR`` creates no profiler: a training run and
    an eval run go through with ``torch.profiler.profile``,
    ``record_function`` and ``torch.cuda.Event`` made to fail, and no phase
    is counted.
  * Set, a tiny training run (the verify recipe's drive: a 16-s synthetic
    record at T = 32) writes one Chrome trace under ``train/`` holding the
    ``train_epoch`` spans (epoch mode) or ``train_step`` spans (step mode),
    one per epoch or step, as ``scgrhc``'s spans sit
    (``scgrhc/train/run.py:159,313,375,412``), and its phase totals beside
    it as ``phases.json``; ``test <split> all`` writes one trace per
    checkpoint under ``eval_valid/``, none overwritten
    (``scgrhc/eval/run.py:310``).
  * The spans follow any recording profiler, not the variable: under a
    caller's own ``torch.profiler.profile``, one ``DataParallelTrainer.step``
    records each phase nested in ``train_step``, ``n_critic`` times for the
    critic's phases, once for the generator's, and ``gp_second_order`` once
    per ``BwdDx`` node of the critic losses' graphs.
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
from scgrhc_torch.ops.kernels import critic_fused as k2
from scgrhc_torch.parallel.dp import DataParallelTrainer
from scgrhc_torch.parallel.mesh import make_mesh
from scgrhc_torch.train import run as train_run
from scgrhc_torch.train import wgan
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
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    assert trace.profile_dir() is None
    trace.reset_phases()
    with trace.trace("x"), trace.annotate("y"):
        pass
    params = _tiny_exp(tmp_path, monkeypatch, total_epochs=1)
    assert train_run.run(params, device="cpu", plot=False)["epochs"]
    eval_run.run(params, "valid", "all", device="cpu")
    assert not (tmp_path / "exp" / "train").exists()
    assert os.listdir(params.comparison_dir_path) == ["valid"]
    assert trace.phase_totals() == {}


def test_annotate_follows_the_profiler_not_the_env_var(tmp_path, monkeypatch):
    """Set, the variable alone opens no span; unset, a caller's profiler does."""
    monkeypatch.setenv(trace.ENV_VAR, str(tmp_path))
    assert not trace.recording()
    assert trace.annotate("a") is trace.annotate("b")  # the one shared nullcontext
    monkeypatch.delenv(trace.ENV_VAR)
    trace.reset_phases()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        assert trace.recording()
        with trace.annotate("a"), trace.annotate("b"), trace.annotate("b"):
            pass
    assert not trace.recording()
    with trace.annotate("a"):
        pass
    assert trace.phase_totals() == {"a": {"calls": 1}, "b": {"calls": 2}}
    trace.reset_phases()
    assert trace.phase_totals() == {}


@pytest.mark.parametrize("mode,span", [("epoch", "train_epoch"), ("step", "train_step")])
def test_training_writes_a_trace_with_its_spans(tmp_path, monkeypatch, mode, span):
    out = tmp_path / "profile"
    monkeypatch.setenv(trace.ENV_VAR, str(out))
    params = _tiny_exp(tmp_path, monkeypatch, train_mode=mode)
    stats = train_run.run(params, device="cpu", plot=False)
    files = [f for f in os.listdir(out / "train") if f != trace.PHASES_FILE]
    assert len(files) == 1 and files[0].endswith(".pt.trace.json")
    assert (out / "train" / trace.PHASES_FILE).is_file()
    events = _events(out / "train" / files[0])
    spans = [e for e in events if e["name"] == span and e.get("cat") == "user_annotation"]
    steps = sum(e["steps"] for e in stats["epochs"])
    assert len(spans) == (len(stats["epochs"]) if mode == "epoch" else steps) > 0
    phases = json.loads((out / "train" / trace.PHASES_FILE).read_text())
    assert phases[span]["calls"] == len(spans)
    assert phases["train_step"]["calls"] == phases["generator_grad"]["calls"] == steps
    assert phases["checkpoint_save"]["calls"] == len(stats["epochs"])
    assert all("device_ms" not in v for v in phases.values())
    assert trace.phase_totals() == {}  # written and cleared
    # the spans hold the step's operators: the K1f and K2f wrappers' plain
    # convolutions on the CPU
    s = spans[0]
    inside = {e["name"] for e in events
              if s["ts"] <= e["ts"] and e["ts"] + e["dur"] <= s["ts"] + s["dur"]}
    assert "aten::convolution" in inside and "Optimizer.step#Adam.step" in inside


CRITIC_PHASES = ("critic_loss", "critic_grad")
GENERATOR_PHASES = ("generator_loss", "generator_grad")


def _count_nodes(fn, name: str) -> int:
    """The nodes called ``name`` in the autograd graph under ``fn``."""
    seen, stack, n = set(), [fn], 0
    while stack:
        f = stack.pop()
        if f is None or f in seen:
            continue
        seen.add(f)
        n += f.name() == name
        stack.extend(g for g, _ in f.next_functions)
    return n


@pytest.mark.parametrize("fuse", ["off", "3b"])
def test_step_phases_under_a_callers_profiler(tmp_path, monkeypatch, fuse):
    monkeypatch.delenv(trace.ENV_VAR, raising=False)
    cfg = wgan.TrainConfig(n_critic=2, critic_fuse=fuse)
    state = wgan.init_state(0, 2, cfg, "cpu")
    g = torch.Generator().manual_seed(1)
    scg, rhc = torch.rand(4, 2, 32, generator=g), torch.rand(4, 1, 32, generator=g)
    # every BwdDx node of a critic loss is on a path to the critic's weights,
    # so the parameter gradient reruns each once
    loss = wgan.critic_loss(state.critic, state.generator, scg, rhc,
                            torch.Generator().manual_seed(2), cfg)
    per_loss = _count_nodes(loss.grad_fn, k2.BwdDx.__name__ + "Backward")
    assert per_loss == len(state.critic.model)
    trace.reset_phases()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        DataParallelTrainer(make_mesh()).step(state, scg, rhc, torch.arange(4),
                                              torch.Generator().manual_seed(3), cfg)
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))

    n = cfg.n_critic
    want = {"train_step": 1, "adam": n + 1, "gp_second_order": n * per_loss,
            **{p: n for p in CRITIC_PHASES}, **{p: 1 for p in GENERATOR_PHASES}}
    assert trace.phase_totals() == {k: {"calls": v} for k, v in want.items()}
    spans = [e for e in _events(path) if e.get("cat") == "user_annotation"]
    (step,) = [e for e in spans if e["name"] == "train_step"]
    for name, count in want.items():
        inside = [e for e in spans if e["name"] == name]
        assert len(inside) == count, name
        assert all(step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"]
                   for e in inside), name
    trace.reset_phases()


class _Event:
    """A CUDA event's timing interface: a time stamp, whether the device has
    passed it, and whether a caller waited on it."""

    def __init__(self, t: float, done: bool = True):
        self.t, self.done, self.waited = t, done, False

    def query(self) -> bool:
        return self.done

    def synchronize(self) -> None:
        self.waited = True

    def elapsed_time(self, end) -> float:
        return end.t - self.t


def test_phase_counters_resolve_events_lazily(monkeypatch):
    """Past ``_RESOLVE_AT`` pending pairs a span folds in those the device
    has passed and waits on none; ``phase_totals`` waits on the rest; the
    events go back to the pool."""
    monkeypatch.setattr(trace, "_RESOLVE_AT", 2)
    phases = trace._Phases()
    late = _Event(9.0, done=False)
    phases.add("a", (_Event(0.0), late))
    phases.add("b", None)
    assert len(phases.pending) == 1 and phases.ms == {}
    phases.add("a", (_Event(1.0), _Event(4.0)))
    assert phases.ms == {"a": 3.0} and [p[2] for p in phases.pending] == [late]
    assert not late.waited and len(phases.pool) == 2
    assert phases.totals() == {"a": {"calls": 2, "device_ms": 12.0}, "b": {"calls": 1}}
    assert late.waited and phases.pending == [] and len(phases.pool) == 4
    assert phases.event() is late
    phases.reset()
    assert phases.totals() == {}


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
