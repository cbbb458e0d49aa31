"""The port's host-side CLI stages against ``scgrhc``: the sweep's config
matrix, ``export``, ``report``, ``plots`` and ``demo``.

  * ``utils.experiments``: the 32 ``params.json`` files byte-equal to
    ``scgrhc``'s, with and without overrides.
  * ``export``: ``train.checkpoint.export_torch`` against ``scgrhc``'s on the
    same checkpoint: ``torch.load`` dicts with equal keys, dtypes and values;
    from an Orbax directory, the same dict as from the pickle of its state.
  * ``report``: ``sweep_report.csv`` and the printed table byte-equal to
    ``scgrhc.pipeline.report.run`` (the table's first line, a timestamped
    banner, aside); ``utils.pandas_text`` against pandas on random input.
  * ``plots``: the figure files ``scgrhc.pipeline.plots.run`` names, each a
    PNG; without matplotlib, an ImportError that names it.
  * ``demo``: ``python -m scgrhc_torch demo <dir> --device cpu`` on 2
    synthetic 60-s records: its config byte-equal to ``scgrhc``'s demo
    config and every artifact in place.
"""

import io
import json
import math
import os
import random
import sys

import numpy as np
import pandas as pd
import pytest
import torch

from scgrhc.core import paths as jpaths
from scgrhc.core.params import Params as JParams
from scgrhc.pipeline import demo as jdemo
from scgrhc.pipeline import plots as jplots
from scgrhc.pipeline import report as jreport
from scgrhc.train import checkpoint as jckpt
from scgrhc.utils import experiments as jexp
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.eval.run import CSV_COLUMNS, write_csv
from scgrhc_torch.pipeline import demo, plots, report
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import orbax_io, wgan
from scgrhc_torch.utils import experiments
from scgrhc_torch.utils.pandas_text import frame_text, read_float

SCORE_COLUMNS = ["checkpoint", "pcc_r", "pcc_ci95_lower", "pcc_ci95_upper", "rmse",
                 "rmse_ci95_lower", "rmse_ci95_upper"]


# ---- utils.experiments ---------------------------------------------------------

@pytest.mark.parametrize("root,overrides", [
    ("abs", {}),
    ("abs", {"total_epochs": 2, "seed": 0}),
    ("abs", {"train_profile": "fast", "train_mode": "step", "total_epochs": 1}),
    (".", {"seed": 3}),
])
def test_write_experiments_is_scgrhc_bytes(tmp_path, monkeypatch, root, overrides):
    monkeypatch.chdir(tmp_path)
    root = str(tmp_path / "sweep") if root == "abs" else root
    want_dirs = jexp.write_experiments(root, **overrides)
    want = [open(os.path.join(d, "params.json"), "rb").read() for d in want_dirs]
    dirs = experiments.write_experiments(root, **overrides)
    assert dirs == want_dirs and len(dirs) == 32
    assert [open(os.path.join(d, "params.json"), "rb").read() for d in dirs] == want
    assert experiments.SWEEP == jexp.SWEEP and experiments.BATCH_SIZE == jexp.BATCH_SIZE


# ---- export ----------------------------------------------------------------------

def _port_state(cfg=None):
    """A port training state with Adam moments (one step taken)."""
    cfg = cfg or wgan.TrainConfig(n_critic=1)
    st = wgan.init_state(3, 2, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    wgan.train_step(st, torch.rand(2, 2, 16, generator=g), torch.rand(2, 1, 16, generator=g),
                    torch.Generator().manual_seed(1), cfg)
    return st, cfg


def _port_checkpoint(path: str, epoch: int = 4) -> None:
    """A native checkpoint with Adam moments, written by the port."""
    st, cfg = _port_state()
    ckpt_io.save(path, start_time=1.5, epoch=epoch, g_losses=[1.0], d_losses=[2.0], state=st,
                 cfg=cfg)


def _assert_same(a, b, where="ckpt"):
    assert type(a) is type(b), where
    if isinstance(a, dict):
        assert list(a) == list(b), where
        for k in a:
            _assert_same(a[k], b[k], f"{where}[{k!r}]")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), where
        for i, (x, y) in enumerate(zip(a, b)):
            _assert_same(x, y, f"{where}[{i}]")
    elif isinstance(a, torch.Tensor):
        assert a.dtype == b.dtype and a.shape == b.shape and a.device.type == "cpu", where
        assert torch.equal(a, b), where
    else:
        assert a == b, where


@pytest.mark.parametrize("source", ["native", "reference_zip"])
def test_export_torch_matches_scgrhc(tmp_path, source):
    path = str(tmp_path / "004.checkpoint")
    _port_checkpoint(path)
    if source == "reference_zip":  # a torch.save file as the reference writes it
        jckpt.export_torch(path, str(tmp_path / "ref.torch"))
        path = str(tmp_path / "ref.torch")
    ckpt_io.export_torch(path, str(tmp_path / "port.torch"))
    jckpt.export_torch(path, str(tmp_path / "jax.torch"))
    got = torch.load(str(tmp_path / "port.torch"), weights_only=False)
    want = torch.load(str(tmp_path / "jax.torch"), weights_only=False)
    assert "format" not in got and got["epoch"] == 4
    assert all(isinstance(v, torch.Tensor) for v in got["g_state_dict"].values())
    _assert_same(got, want)
    back = ckpt_io.load(str(tmp_path / "port.torch"))
    for k, v in ckpt_io.load(str(tmp_path / "004.checkpoint"))["g_state_dict"].items():
        np.testing.assert_array_equal(back["g_state_dict"][k], v)


def _experiment(d: str, **extra) -> str:
    os.makedirs(os.path.join(d, "checkpoints"), exist_ok=True)
    cfg = experiments.make_params_dict(7, "PA", ["patch_ACC_lat", "patch_ACC_hf"],
                                       total_epochs=2, **extra)
    cfg["dir_path"] = d
    with open(os.path.join(d, "params.json"), "w") as f:
        json.dump(cfg, f)
    return d


def test_export_cli_paths_and_orbax_source(tmp_path, capsys):
    d = _experiment(str(tmp_path / "exp"))
    for e in (3, 4):
        _port_checkpoint(os.path.join(d, "checkpoints", f"{e:03d}.checkpoint"))
    with open(os.path.join(d, "checkpoint_best.txt"), "w") as f:
        f.write("checkpoint   003.checkpoint\npcc_r   0.5")
    assert cli(["export", d, "best"]) == 0
    out = os.path.join(d, "003.checkpoint.torch")  # beside, not in, checkpoints/
    assert f"-> {out}" in capsys.readouterr().out
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == ["003.checkpoint",
                                                                 "004.checkpoint"]
    assert cli(["export", d, "last", str(tmp_path / "x.torch")]) == 0
    assert torch.load(str(tmp_path / "x.torch"), weights_only=False)["epoch"] == 4
    assert ckpt_io.get_last_checkpoint_path(os.path.join(d, "checkpoints")) == "004.checkpoint"
    # an Orbax source exports the dict its state's pickle exports, beside checkpoints/
    st, cfg = _port_state(wgan.TrainConfig.from_params(Params(os.path.join(d, "params.json"))))
    orbax_io.save(os.path.join(d, "checkpoints", "005.checkpoint"), start_time=1.5, epoch=5,
                  g_losses=[1.0], d_losses=[2.0], state=st)
    ckpt_io.save(str(tmp_path / "005.checkpoint"), start_time=1.5, epoch=5, g_losses=[1.0],
                 d_losses=[2.0], state=st, cfg=cfg)
    ckpt_io.export_torch(str(tmp_path / "005.checkpoint"), str(tmp_path / "want.torch"))
    capsys.readouterr()
    assert cli(["export", d, "005.checkpoint"]) == 0
    out = os.path.join(d, "005.checkpoint.torch")
    assert f"-> {out}" in capsys.readouterr().out
    _assert_same(torch.load(out, weights_only=False),
                 torch.load(str(tmp_path / "want.torch"), weights_only=False))
    assert sorted(os.listdir(os.path.join(d, "checkpoints"))) == [
        "003.checkpoint", "004.checkpoint", "005.checkpoint.orbax"]


# ---- report ----------------------------------------------------------------------

def _scores(root: str, name: str, pccs, chamber="PA", channels=("patch_ACC_lat",), seed=0):
    d = os.path.join(root, name)
    os.makedirs(d)
    with open(os.path.join(d, "params.json"), "w") as f:
        json.dump({"chamber": chamber, "in_channels": list(channels)}, f)
    rng = np.random.default_rng(seed)
    rows = [{"checkpoint": f"{i:03d}.checkpoint", "pcc_r": p,
             **{k: float(rng.standard_normal() * 10.0 ** rng.integers(-3, 3))
                for k in SCORE_COLUMNS[2:]}} for i, p in enumerate(pccs)]
    write_csv(os.path.join(d, "checkpoint_scores.csv"), SCORE_COLUMNS, rows)


def _report_cases(root: str, case: str) -> None:
    rng = np.random.default_rng(1)
    if case == "ranked":
        _scores(root, "waveform_06", rng.random(5).tolist(), channels=("patch_ACC_lat", "patch_ACC_hf"))
        _scores(root, "w7", rng.random(3).tolist(), "RV", ("patch_ECG",), seed=1)
        _scores(root, "waveform_1000_long_name", rng.random(12).tolist(), "PCW",
                ("patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"), seed=2)
        os.makedirs(os.path.join(root, "not_an_experiment"))
    elif case == "tie":
        _scores(root, "waveform_06", [0.3, 0.7, 0.7, 0.1])
        _scores(root, "waveform_07", [0.7, 0.7], seed=3)
    elif case == "tiny":
        _scores(root, "waveform_06", [0.81234567, 0.5])
        _scores(root, "waveform_08", [1e-7, -0.2], seed=4)
        _scores(root, "waveform_09", [float("nan"), 0.25], seed=5)
    elif case == "empty_scores":
        _scores(root, "waveform_06", [])


@pytest.mark.parametrize("case", ["ranked", "tie", "tiny", "empty_root", "empty_scores"])
def test_report_is_scgrhc_bytes(tmp_path, capsys, case):
    root = str(tmp_path)
    _report_cases(root, case)
    want = jreport.run(root)
    want_out = capsys.readouterr().out.splitlines()[1:]
    want_csv = open(want, "rb").read() if want else None
    if want:
        os.remove(want)
    got = report.run(root)
    assert capsys.readouterr().out.splitlines()[1:] == want_out
    assert got == want
    if want:
        assert open(got, "rb").read() == want_csv
    if case == "tiny":
        assert "8.123457e-01" in "\n".join(want_out)
    if case == "tie":
        assert pd.read_csv(got)["checkpoint"].tolist() == ["001.checkpoint", "000.checkpoint"]


@pytest.mark.parametrize("seed", range(3))
def test_read_float_is_pandas_read_csv(seed):
    rng = np.random.default_rng(seed)
    vals = np.concatenate([rng.standard_normal(3000), rng.random(3000) * 1e-6,
                           10.0 ** rng.uniform(-320, 308, 3000), [0.0, -0.0, 5e-324]])
    texts = [repr(float(v)) for v in vals] + ["inf", "-inf", "1e5", "7"]
    want = pd.read_csv(io.StringIO("x\n" + "\n".join(texts) + "\n"))["x"].to_numpy()
    got = np.array([read_float(s) for s in texts])
    np.testing.assert_array_equal(got, want)
    assert math.isnan(read_float(""))
    assert (got != np.array([float(s) for s in texts])).any()  # not Python's float


@pytest.mark.parametrize("seed", range(4))
def test_frame_text_is_pandas_to_string(seed):
    r = random.Random(seed)

    def value():
        k = r.random()
        if k < 0.05:
            return float("nan")
        if k < 0.15:
            return r.choice([1e-7, -1e-9, 2e7, 1e6, 1234567.5, float("inf"), -0.0, 0.0, 1e-6])
        if k < 0.3:
            return round(r.uniform(-100, 100), r.randint(0, 3))
        return r.uniform(-1, 1) * 10 ** r.randint(-3, 7)

    cols = ["experiment", "chamber", "pcc_r", "rmse", "n_checkpoints_scored"]
    for _ in range(200):
        rows = [{"experiment": "w" * r.randint(1, 14), "chamber": r.choice(["PA", "RV", "PCW"]),
                 "pcc_r": value(), "rmse": value(),
                 "n_checkpoints_scored": r.randint(0, 10 ** r.randint(0, 6))}
                for _ in range(r.randint(1, 5))]
        assert frame_text(cols, rows) == pd.DataFrame(rows, columns=cols).to_string(index=False)


# ---- plots -----------------------------------------------------------------------

def _comparison(d: str, n: int) -> None:
    rng = np.random.default_rng(0)
    rows = []
    for i in range(n):
        real = rng.standard_normal(40).astype(np.float32)
        rows.append({"filename": f"SYN{i % 3:03d}", "start_idx": 750 * i,
                     "stop_idx": 750 * i + 750, "real_rhc": str(real.tolist()),
                     "pred_rhc": str((real * 0.8).tolist()),
                     **{k: float(rng.random()) for k in CSV_COLUMNS[5:]}})
    rows.sort(key=lambda r: r["pcc_r"], reverse=True)
    os.makedirs(os.path.join(d, "comparisons", "valid"))
    write_csv(os.path.join(d, "comparisons", "valid", "001.csv"), CSV_COLUMNS, rows)


@pytest.mark.parametrize("n_rows,n", [(9, 3), (2, 5)])
def test_plots_names_scgrhcs_figures(tmp_path, n_rows, n):
    jd, td = _experiment(str(tmp_path / "jax")), _experiment(str(tmp_path / "port"))
    for d in (jd, td):
        _comparison(d, n_rows)
    want = jplots.run(JParams(os.path.join(jd, "params.json")), "valid", "001.checkpoint", n=n)
    got = plots.run(Params(os.path.join(td, "params.json")), "valid", "001.checkpoint", n=n)
    assert [os.path.relpath(p, td) for p in got] == [os.path.relpath(p, jd) for p in want]
    assert len(got) == 2 * min(n, n_rows)
    for p in got:
        with open(p, "rb") as f:
            assert f.read(8) == b"\x89PNG\r\n\x1a\n"


def test_plots_without_matplotlib_names_it(tmp_path, monkeypatch):
    d = _experiment(str(tmp_path / "exp"))
    _comparison(d, 3)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    with pytest.raises(ImportError, match="matplotlib"):
        plots.run(Params(os.path.join(d, "params.json")), "valid", "001.checkpoint")
    assert not os.path.exists(os.path.join(d, "pred_top"))


def test_plots_cli(tmp_path, capsys):
    d = _experiment(str(tmp_path / "exp"))
    _comparison(d, 4)
    with open(os.path.join(d, "checkpoint_best.txt"), "w") as f:
        f.write("checkpoint   001.checkpoint\n")
    assert cli(["plots", d, "valid", "best", "2"]) == 0
    assert "wrote 4 figures" in capsys.readouterr().out
    assert len(os.listdir(os.path.join(d, "pred_top"))) == 2


# ---- demo --------------------------------------------------------------------------

@pytest.fixture()
def restore_paths(monkeypatch):
    """Both packages' data paths come back after a demo points them at its
    database."""
    for mod in (jpaths, tpaths):
        monkeypatch.setattr(mod, "DATA_PATH", mod.DATA_PATH)
        monkeypatch.setattr(mod, "PROCESSED_DATA_PATH", mod.PROCESSED_DATA_PATH)


def test_demo_on_cpu(tmp_path, capsys, monkeypatch, restore_paths):
    """The whole demo on the CPU (2 synthetic 60-s records, 1 epoch); then
    ``scgrhc``'s demo, its pipeline and plots stubbed, rewrites the config
    with the same bytes."""
    w = str(tmp_path / "demo")
    assert cli(["demo", w, "--epochs", "1", "--records", "2", "--seconds", "60",
                "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    exp = os.path.join(w, "waveform_06")
    assert "figures skipped" not in out and "demo | done" in out
    assert sorted(os.listdir(os.path.join(exp, "checkpoints"))) == ["000.checkpoint"]
    assert os.listdir(os.path.join(exp, "comparisons", "valid")) == ["000.csv"]
    assert os.listdir(os.path.join(exp, "comparisons", "test")) == ["000.csv"]
    best = open(os.path.join(exp, "checkpoint_best.txt")).read().split()
    assert best[:2] == ["checkpoint", "000.checkpoint"]
    for sub in ("pred_top", "pred_rand"):
        assert [f.endswith(".png") for f in os.listdir(os.path.join(exp, sub))] == [True]
    ours = open(os.path.join(exp, "params.json"), "rb").read()

    import scgrhc.pipeline.run as jrun

    monkeypatch.setattr(jrun, "run", lambda params: None)
    monkeypatch.setattr(jplots, "run", lambda *a, **k: [])
    assert jdemo.run(w, epochs=1, n_records=2, duration_s=60.0) == exp
    assert open(os.path.join(exp, "params.json"), "rb").read() == ours


def test_demo_without_matplotlib_skips_the_figures(tmp_path, capsys, monkeypatch,
                                                   restore_paths):
    """Without matplotlib the demo finishes the pipeline and says that the
    figures were skipped (the pipeline stubbed: it writes the selection)."""
    import scgrhc_torch.pipeline.run as trun

    def pipeline(params, device=None):
        _comparison(params.dir_path, 3)
        with open(os.path.join(params.dir_path, "checkpoint_best.txt"), "w") as f:
            f.write("checkpoint   001.checkpoint\n")
        os.rename(os.path.join(params.comparison_dir_path, "valid"),
                  os.path.join(params.comparison_dir_path, "test"))

    monkeypatch.setattr(trun, "run", pipeline)
    monkeypatch.setitem(sys.modules, "matplotlib", None)
    monkeypatch.setitem(sys.modules, "matplotlib.pyplot", None)
    exp = demo.run(str(tmp_path / "demo"), n_records=1, duration_s=8.0, device="cpu")
    out = capsys.readouterr().out
    assert "demo | figures skipped: plots needs matplotlib" in out and "demo | done" in out
    assert not os.path.exists(os.path.join(exp, "pred_top"))
