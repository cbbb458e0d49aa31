"""The port's sweep runner and its CLI against ``scgrhc``
(``tests/test_sweep_trace.py`` and ``tests/test_cli.py``'s sweep cases,
mirrored): exit codes, failures contained in process, checkpoint pruning,
``CUDA_VISIBLE_DEVICES`` pinning and ``--device`` passthrough, and the
sweep's flags parsed to ``scgrhc``'s overrides and runner choice; then one
config of the matrix run for real in a child process on the CPU.
"""

import os
import subprocess
import sys

import pytest

from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core.params import Params
from scgrhc_torch.pipeline import sweep
from scgrhc_torch.utils import experiments


def test_write_experiments_loadable(tmp_path):
    dirs = experiments.write_experiments(str(tmp_path), total_epochs=2, seed=0)
    assert len(dirs) == 32
    p = Params(os.path.join(dirs[0], "params.json"))
    assert p.total_epochs == 2 and p.seed == 0 and p.chamber == "PA"


def test_run_sweep_exit_codes_and_card_pinning(monkeypatch):
    calls = []

    def fake_proc(dir_path, env_extra=None, device=None):
        calls.append((dir_path, (env_extra or {}).get("CUDA_VISIBLE_DEVICES"), device))
        return 0 if "bad" not in dir_path else 7

    monkeypatch.setattr(sweep, "run_experiment_process", fake_proc)
    res = sweep.run_sweep(["a", "bad", "c"], jobs=2, device_ids=[0, 1])
    assert res == {"a": 0, "bad": 7, "c": 0}
    assert sorted(calls) == [("a", "0", None), ("bad", "1", None), ("c", "0", None)]
    calls.clear()
    assert sweep.run_sweep(["a"], device="cpu") == {"a": 0}
    assert calls == [("a", None, "cpu")]


def test_run_sweep_inproc_contains_failures(monkeypatch):
    import scgrhc_torch.core.params as params_mod
    import scgrhc_torch.pipeline.run as pipeline_run

    ran = []

    def fake_run(params, device=None):
        ran.append((params.dir_path, device))
        if "bad" in params.dir_path:
            raise RuntimeError("boom")

    class FakeParams:
        def __init__(self, path):
            self.dir_path = os.path.dirname(path)

    monkeypatch.setattr(pipeline_run, "run", fake_run)
    monkeypatch.setattr(sweep, "run_experiment_process", None)  # must not be used
    monkeypatch.setattr(params_mod, "Params", FakeParams)
    res = sweep.run_sweep(["a", "bad", "c"], jobs=1, inproc=True, device="cpu")
    assert res == {"a": 0, "bad": 1, "c": 0}
    assert ran == [("a", "cpu"), ("bad", "cpu"), ("c", "cpu")]
    with pytest.raises(ValueError):
        sweep.run_sweep(["a"], jobs=2, inproc=True)


@pytest.mark.parametrize("device,tail", [(None, []), ("cpu", ["--device", "cpu"])])
def test_child_command_passes_the_device(monkeypatch, device, tail):
    seen = {}

    def fake_run(cmd, env, check):
        seen.update(cmd=cmd, env=env)
        return subprocess.CompletedProcess(cmd, 3)

    monkeypatch.setattr(sweep.subprocess, "run", fake_run)
    assert sweep.run_experiment_process("exp", {"CUDA_VISIBLE_DEVICES": "2"}, device) == 3
    assert seen["cmd"] == [sys.executable, "-m", "scgrhc_torch", "exp"] + tail
    assert seen["env"]["CUDA_VISIBLE_DEVICES"] == "2"


def test_prune_checkpoints_keeps_first_best_last(tmp_path):
    d = tmp_path / "waveform_06"
    cdir = d / "checkpoints"
    os.makedirs(cdir)
    for ep in range(6):
        (cdir / f"{ep:03d}.checkpoint").write_bytes(b"x")
    (d / "checkpoint_best.txt").write_text("checkpoint         003.checkpoint\npcc_r  0.5\n")
    assert sweep.prune_checkpoints(str(d)) == 3
    assert sorted(os.listdir(cdir)) == ["000.checkpoint", "003.checkpoint", "005.checkpoint"]
    assert sweep.prune_checkpoints(str(d)) == 0
    assert sweep.prune_checkpoints(str(tmp_path / "missing")) == 0


def test_run_sweep_prune_only_on_success(tmp_path, monkeypatch):
    dirs = []
    for name in ("ok", "bad"):
        d = tmp_path / name
        os.makedirs(d / "checkpoints")
        for ep in range(3):
            (d / "checkpoints" / f"{ep:03d}.checkpoint").write_bytes(b"x")
        dirs.append(str(d))
    monkeypatch.setattr(sweep, "run_experiment_process",
                        lambda d, env_extra=None, device=None: 1 if d.endswith("bad") else 0)
    results = sweep.run_sweep(dirs, jobs=1, prune=True)
    assert results[dirs[0]] == 0 and results[dirs[1]] == 1
    assert len(os.listdir(tmp_path / "ok" / "checkpoints")) == 2
    assert len(os.listdir(tmp_path / "bad" / "checkpoints")) == 3


def test_prune_checkpoints_handles_orbax_dirs(tmp_path):
    d = tmp_path / "waveform_06"
    cdir = d / "checkpoints"
    os.makedirs(cdir)
    for ep in range(5):
        os.makedirs(cdir / f"{ep:03d}.checkpoint.orbax")
        (cdir / f"{ep:03d}.checkpoint.orbax" / "meta.json").write_text("{}")
    (d / "checkpoint_best.txt").write_text("checkpoint         002.checkpoint\n")
    assert sweep.prune_checkpoints(str(d)) == 2
    assert sorted(os.listdir(cdir)) == ["000.checkpoint.orbax", "002.checkpoint.orbax",
                                        "004.checkpoint.orbax"]


# ---- the sweep's flags against scgrhc's ------------------------------------------

def _parsed(monkeypatch, argv, port: bool):
    """(root, overrides, jobs, inproc, prune[, device]) as the CLI hands
    them to write_experiments and run_sweep."""
    got = {}

    def write(root, **overrides):
        got.update(root=root, overrides=overrides)
        return ["d1"]

    def run(dirs, jobs=1, inproc=False, prune=False, **kw):
        got.update(jobs=jobs, inproc=inproc, prune=prune, **kw)
        return {d: 0 for d in dirs}

    if port:
        import scgrhc_torch.pipeline.sweep as mod
        import scgrhc_torch.utils.experiments as exp_mod
    else:
        import scgrhc
        import scgrhc.pipeline.run as pr
        import scgrhc.pipeline.sweep as mod
        import scgrhc.utils.experiments as exp_mod

        monkeypatch.setattr(scgrhc, "configure_compilation_cache", lambda: None)
    monkeypatch.setattr(exp_mod, "write_experiments", write)
    monkeypatch.setattr(mod, "run_sweep", run)
    assert (cli(argv) if port else pr.dispatch(argv)) == 0
    return got


@pytest.mark.parametrize("argv", [
    ["sweep"],
    ["sweep", "root"],
    ["sweep", "."],
    ["sweep", "--fast"],
    ["sweep", "root", "--fast", "--jobs", "2"],
    ["sweep", "root", "--fast", "--subproc"],
    ["sweep", "root", "--inproc", "--epochs", "3", "--seed", "5"],
    ["sweep", "root", "--train-mode", "epoch", "--prune", "--jobs", "4"],
])
def test_sweep_flags_parse_as_scgrhcs(monkeypatch, argv):
    want = _parsed(monkeypatch, argv, port=False)
    got = _parsed(monkeypatch, argv + ["--device", "cpu"], port=True)
    assert got.pop("device") == "cpu"
    assert got == want
    assert want["overrides"].get("train_mode") in ("step", "epoch")
    if argv[-1] == "--fast":
        assert want["overrides"]["train_profile"] == "fast" and want["inproc"] is True


def test_unknown_sweep_and_demo_flags_fail():
    with pytest.raises(SystemExit, match="unknown sweep flag --bogus"):
        cli(["sweep", ".", "--bogus"])
    with pytest.raises(SystemExit, match="unknown demo flag --bogus"):
        cli(["demo", "w", "--bogus"])
    with pytest.raises(SystemExit, match="mesh"):
        cli(["sweep", ".", "--mesh"])


# ---- one config of the matrix, for real ---------------------------------------------

def test_sweep_runs_a_config_in_a_child_on_cpu(tmp_path, monkeypatch):
    """waveform_23 (PA, one channel) of the matrix, 1 epoch, through
    ``python -m scgrhc_torch <dir> --device cpu`` on 2 synthetic 60-s
    records; --prune then keeps its one checkpoint."""
    from scgrhc_torch.utils.synth import make_synthetic_database

    db = make_synthetic_database(str(tmp_path / "db"), n_records=2, duration_s=60.0)
    monkeypatch.setenv("SCGRHC_DATA", os.path.dirname(db))
    monkeypatch.setenv("PYTHONPATH", os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    root = str(tmp_path / "sweep")
    dirs = [d for d in experiments.write_experiments(root, total_epochs=1, train_mode="step")
            if d.endswith("waveform_23")]
    assert sweep.run_sweep(dirs, device="cpu", prune=True) == {dirs[0]: 0}
    assert os.listdir(os.path.join(dirs[0], "checkpoints")) == ["000.checkpoint"]
    best = open(os.path.join(dirs[0], "checkpoint_best.txt")).read().split()
    assert best[1] == "000.checkpoint"
