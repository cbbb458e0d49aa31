"""The port's evaluation, selection and pipeline stages against ``scgrhc``.

  * ``segment_scores`` (float32 torch) against ``scgrhc.eval.metrics`` (float32
    JAX) within 1e-5 absolute (r and its CI are in [-1, 1], RMSE O(1) here;
    the two sum in other orders), NaN in the same places; ``global_scores``
    (host float64, the same NumPy arithmetic in both) exactly.
  * ``eval.run`` on checkpoints written by ``scgrhc.train.checkpoint.save``
    against ``scgrhc.eval.run``: rows matched by (filename, start_idx), the
    real waveforms equal, predictions and scores within the cross-package f32
    envelope of 1e-3 (relative to the largest value; ROADMAP "Known parity
    traps").
  * The CSV and ``checkpoint_best.txt`` writers byte for byte against pandas,
    and ``select.run`` of both packages on one comparison directory.
  * A tiny ``python -m scgrhc_torch <dir> --device cpu`` pipeline whose
    artifacts ``scgrhc``'s select and eval read back.
"""

import csv
import json
import os
import shutil

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from scgrhc.core.params import Params as JParams
from scgrhc.eval import metrics as jmetrics
from scgrhc.eval import run as jeval
from scgrhc.select import run as jselect
from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.data.loaders import SegmentLoader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.eval import infer
from scgrhc_torch.eval import metrics
from scgrhc_torch.eval import run as eval_run
from scgrhc_torch.ops.kernels import conv_block
from scgrhc_torch.select import run as select_run

T = 32
SCORE_ATOL = 1e-5
ENVELOPE = 1e-3
METRICS = eval_run.CSV_COLUMNS[5:]


# ---- metrics ------------------------------------------------------------------

@pytest.mark.parametrize("case", ["random", "constant_pred", "near_perfect", "anti"])
def test_segment_scores_match_jax(case):
    rng = np.random.default_rng(0)
    x = (rng.standard_normal((6, 750)) * 8 + 20).astype(np.float32)
    y = (x + rng.standard_normal((6, 750)) * 3).astype(np.float32)
    if case == "constant_pred":
        y[2] = 17.0
    elif case == "near_perfect":
        y = (x * 1.5 + 2 + rng.standard_normal((6, 750)) * 1e-3).astype(np.float32)
    elif case == "anti":
        y = -y
    got = metrics.segment_scores(torch.from_numpy(x), torch.from_numpy(y))
    want = jmetrics.segment_scores(x, y)
    assert list(got) == METRICS
    for k in METRICS:
        g, w = got[k].numpy(), np.asarray(want[k])
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_allclose(g, w, atol=SCORE_ATOL, rtol=0, err_msg=k)
    if case == "constant_pred":
        assert np.isnan(got["pcc_r"].numpy()[2]) and not np.isnan(got["pcc_r"].numpy()[1])


@pytest.mark.parametrize("n", [750, 40_000])
def test_global_scores_match_jax(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n) * 5 + 20
    y = x * 0.7 + rng.standard_normal(n) * 4
    assert metrics.global_scores(x, y) == jmetrics.global_scores(x, y)
    assert metrics.t_crit_975(n - 1) == jmetrics.t_crit_975(n - 1)


# ---- the CSV and checkpoint_best.txt writers against pandas ---------------------

def _rows(n, seed=0, nan=True):
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        v = rng.standard_normal(4).astype(np.float32)
        row = {"filename": f"SYN{i:03d}", "start_idx": 750 * i, "stop_idx": 750 * i + 750,
               "real_rhc": str(v.tolist()), "pred_rhc": str((v * 2).tolist())}
        row.update({k: float(rng.standard_normal()) for k in METRICS})
        out.append(row)
    if n and nan:
        out[0]["pcc_r"] = float("nan")
        out[-1].update(pcc_ci95_lower=-1e-5, pcc_ci95_upper=1e5, rmse=1e-5, rmse_ci95_upper=1e16,
                       rmse_ci95_lower=-0.0)
    return out


@pytest.mark.parametrize("n,nan", [(0, False), (1, True), (5, True), (5, False)])
def test_comparison_csv_is_pandas_bytes(tmp_path, n, nan):
    rows = _rows(n, nan=nan)
    eval_run.write_csv(str(tmp_path / "port.csv"), eval_run.CSV_COLUMNS, rows)
    pd.DataFrame(rows, columns=eval_run.CSV_COLUMNS).to_csv(tmp_path / "pandas.csv", index=False)
    assert (tmp_path / "port.csv").read_bytes() == (tmp_path / "pandas.csv").read_bytes()


@pytest.mark.parametrize("values", [
    (0.5, -0.123456789, 1e-5, 123456.7, float("nan"), 1e16),
    (0.9123456, -0.5, 1e-7, 1.0, 2.25, 3.0),
    (float("nan"), float("nan"), float("nan"), float("nan"), float("nan"), float("nan")),
    (-0.0, float("inf"), -1e-7, 12.0, 0.000123, -98765.4321),
])
def test_best_text_is_pandas_to_string(values):
    row = {"checkpoint": "017.checkpoint", **dict(zip(METRICS, values))}
    want = pd.DataFrame.from_dict([row]).loc[0].to_string()
    assert select_run.series_text(row) == want


def test_best_row_is_pandas_idxmax():
    nan = float("nan")
    for pcc in ([0.1, 0.5, 0.3], [0.5, nan, 0.5], [nan, 0.2, 0.2], [-1.0]):
        scores = [{"checkpoint": f"{i:03d}.checkpoint", "pcc_r": p} for i, p in enumerate(pcc)]
        df = pd.DataFrame.from_dict(scores)
        assert select_run.best_row(scores) == scores[df["pcc_r"].idxmax()]
    with pytest.raises(ValueError):
        select_run.best_row([{"checkpoint": "000.checkpoint", "pcc_r": nan}])
    with pytest.raises(KeyError):
        select_run.best_row([])


# ---- select on one comparison directory -----------------------------------------

def _params_dict(d, **extra):
    return {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"], "chamber": "PA",
        "segment_size": T / 500, "batch_size": 4, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 3, "min_RHC": -50, "use_global_min_max": False, "seed": 2,
        "eval_batch": 4, "eval_stack": 2, **extra,
    }


def _write_params(d, **extra) -> str:
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "params.json")
    with open(path, "w") as f:
        json.dump(_params_dict(d, **extra), f)
    return path


def _comparison_dir(d, pccs, seed=0):
    """comparisons/valid/NNN.csv whose global pcc_r are about ``pccs``."""
    rng = np.random.default_rng(seed)
    valid = os.path.join(d, "comparisons", "valid")
    os.makedirs(valid, exist_ok=True)
    base = rng.standard_normal((4, 40)).astype(np.float32) * 5 + 20
    noise = rng.standard_normal((4, 40)).astype(np.float32)
    for i, p in enumerate(pccs):
        rows = []
        if p is not None:
            pred = base + noise * np.float32(np.sqrt(1 / p ** 2 - 1) * 5)
            rows = _rows(4, seed=i, nan=False)
            for j, row in enumerate(rows):
                row.update(real_rhc=str(base[j].tolist()), pred_rhc=str(pred[j].tolist()))
        eval_run.write_csv(os.path.join(valid, f"{i:03d}.csv"), eval_run.CSV_COLUMNS, rows)


@pytest.mark.parametrize("pccs,extra", [
    ([0.5, 0.9, 0.7], {}),
    ([0.8, 0.8, 0.3], {}),                 # a near tie, checkpoints not on disk: no re-verify
    ([0.8, 0.8, 0.3], {"eval_stack": 1}),  # a near tie with the guard off
    ([0.6, None, 0.4], {}),                # an empty comparison CSV is skipped
])
def test_select_matches_jax_bytes(tmp_path, capsys, pccs, extra):
    d = str(tmp_path / "exp")
    path = _write_params(d, **extra)
    _comparison_dir(d, pccs)
    out = {}
    for name, run, params in (("jax", jselect.run, JParams(path)),
                              ("port", select_run.run, Params(path))):
        run(params)
        out[name] = [open(os.path.join(d, f), "rb").read()
                     for f in ("checkpoint_scores.csv", "checkpoint_best.txt")]
        out[name + "_log"] = [line.split(" | ", 2)[2] for line in
                              capsys.readouterr().out.splitlines()]
    assert out["port"] == out["jax"]
    assert out["port_log"] == out["jax_log"]
    assert out["port"][1].startswith(b"checkpoint         00")


# ---- evaluation on checkpoints both packages read -------------------------------

def _store(n, c, seed):
    rng = np.random.default_rng(seed)
    tt = np.arange(T) / 500.0
    scg = rng.standard_normal((n, T, c)) * 0.05
    rhc = (20 + 10 * np.sin(2 * np.pi * 3 * tt)[None, :, None] + rng.standard_normal((n, T, 1)))
    return SegmentStore.from_windows(scg, rhc, "SYN000", np.arange(n) * T)


@pytest.fixture(scope="module")
def jax_experiment(tmp_path_factory):
    """Loader files (7 valid, 3 test windows) and three checkpoints written
    by ``scgrhc.train.checkpoint.save``."""
    d = str(tmp_path_factory.mktemp("evalexp") / "exp")
    _write_params(d)
    p = Params(os.path.join(d, "params.json"))
    SegmentLoader(_store(9, 2, 0), 4, seed=1).save(p.train_path)
    SegmentLoader(_store(7, 2, 1), 1, seed=1).save(p.valid_path)
    SegmentLoader(_store(3, 2, 2), 1, seed=1).save(p.test_path)
    os.makedirs(p.checkpoint_dir_path)
    for e in range(3):
        state = init_state(jax.random.key(e), 2, TrainConfig())
        jckpt.save(os.path.join(p.checkpoint_dir_path, f"{e:03d}.checkpoint"), start_time=0.0,
                   epoch=e, g_losses=[], d_losses=[], state=state)
    return d


def _copy(src, dst, **extra):
    shutil.copytree(src, dst)
    return _write_params(dst, **extra)


def _read_csv(path) -> dict:
    with open(path, newline="") as f:
        return {(r["filename"], int(r["start_idx"])): r for r in csv.DictReader(f)}


def _assert_rows_close(got: dict, want: dict):
    assert got.keys() == want.keys() and got
    pred_w = np.stack([select_run.get_float_array(r["pred_rhc"]) for r in want.values()])
    pred_g = np.stack([select_run.get_float_array(got[k]["pred_rhc"]) for k in want])
    scale = np.abs(pred_w).max()
    np.testing.assert_allclose(pred_g, pred_w, rtol=ENVELOPE, atol=ENVELOPE * scale)
    for k, w in want.items():
        g = got[k]
        assert (g["stop_idx"], g["real_rhc"]) == (w["stop_idx"], w["real_rhc"])
        for m in METRICS:
            np.testing.assert_allclose(float(g[m]), float(w[m]), rtol=ENVELOPE,
                                       atol=ENVELOPE, err_msg=m)


def test_eval_all_matches_jax(jax_experiment, tmp_path, capsys):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jeval.run(JParams(_copy(jax_experiment, jd)), "valid", "all")
    jax_log = capsys.readouterr().out
    before = conv_block.conv_in_relu.launches
    eval_run.run(Params(_copy(jax_experiment, td)), "valid", "all", device="cpu")
    port_log = capsys.readouterr().out
    assert conv_block.conv_in_relu.launches == before  # CPU: the plain version
    names = sorted(os.listdir(os.path.join(jd, "comparisons", "valid")))
    assert names == sorted(os.listdir(os.path.join(td, "comparisons", "valid"))) == \
        ["000.csv", "001.csv", "002.csv"]
    for name in names:
        _assert_rows_close(_read_csv(os.path.join(td, "comparisons", "valid", name)),
                           _read_csv(os.path.join(jd, "comparisons", "valid", name)))
    strip = lambda log: [line.split(" | ", 2)[2] for line in log.splitlines()]  # noqa: E731
    assert strip(port_log) == [s.replace(jd, td) for s in strip(jax_log)]


def test_eval_explicit_and_last_match_jax(jax_experiment, tmp_path):
    jd, td = str(tmp_path / "jax"), str(tmp_path / "port")
    jp, tp = JParams(_copy(jax_experiment, jd)), Params(_copy(jax_experiment, td))
    for split, which in (("test", "001.checkpoint"), ("train", "last")):
        jeval.run(jp, split, which)
        eval_run.run(tp, split, which, device="cpu")
        name = "001.csv" if which != "last" else "002.csv"
        _assert_rows_close(_read_csv(os.path.join(td, "comparisons", split, name)),
                           _read_csv(os.path.join(jd, "comparisons", split, name)))


def test_eval_stack_is_ignored_and_eval_skips_processed(jax_experiment, tmp_path, capsys):
    dirs = {}
    for stack in (1, 2, 8):
        d = str(tmp_path / f"s{stack}")
        eval_run.run(Params(_copy(jax_experiment, d, eval_stack=stack)), "valid", "all",
                     device="cpu")
        dirs[stack] = d
    for name in ("000.csv", "001.csv", "002.csv"):
        files = {s: open(os.path.join(d, "comparisons", "valid", name), "rb").read()
                 for s, d in dirs.items()}
        assert files[1] == files[2] == files[8]
    capsys.readouterr()
    # a rerun finds every checkpoint processed: it prints the i/len lines only
    csv_path = os.path.join(dirs[2], "comparisons", "valid", "001.csv")
    mtime = os.stat(csv_path).st_mtime_ns
    eval_run.run(Params(os.path.join(dirs[2], "params.json")), "valid", "all", device="cpu")
    assert os.stat(csv_path).st_mtime_ns == mtime
    assert [line.rsplit(" | ", 1)[1] for line in capsys.readouterr().out.splitlines()[1:]] == \
        ["0/3", "1/3", "2/3"]


@pytest.mark.parametrize("batch", [1, 3, 7, 100])
def test_predict_split_chunking_keeps_each_window(jax_experiment, batch):
    """Each window's prediction and scores do not depend on the chunk it
    falls in (instance norm is per window), within f32 rounding of the
    conv's blocking."""
    from scgrhc_torch.models.convert import generator_from_state_dict
    from scgrhc_torch.train import checkpoint as ckpt_io

    p = Params(os.path.join(jax_experiment, "params.json"))
    store = SegmentLoader(_store(7, 2, 1), 1).dataset
    gen = generator_from_state_dict(ckpt_io.load(os.path.join(
        p.checkpoint_dir_path, "001.checkpoint"))["g_state_dict"]).eval()
    real, pred, scores = infer.predict_split(gen, store, batch=batch)
    r7, p7, s7 = infer.predict_split(gen, store, batch=7)
    assert real.shape == pred.shape == (7, T) and pred.dtype == np.float32
    np.testing.assert_array_equal(real, r7)
    np.testing.assert_allclose(pred, p7, rtol=1e-5, atol=1e-5 * np.abs(p7).max())
    for k in METRICS:
        assert scores[k].shape == (7,)
        np.testing.assert_allclose(scores[k], s7[k], rtol=1e-4, atol=1e-5, err_msg=k)


def test_predict_split_on_an_empty_store():
    from scgrhc_torch.models.generator import Generator

    empty = SegmentLoader(_store(0, 2, 0), 1).dataset
    real, pred, scores = infer.predict_split(Generator(2).eval(), empty, batch=4)
    assert real.shape == pred.shape == (0, T) and scores == {}


# ---- the pipeline ------------------------------------------------------------------

def test_pipeline_on_cpu_and_jax_reads_it_back(synth_db, tmp_path, monkeypatch, capsys):
    """``python -m scgrhc_torch <dir> --device cpu`` on 8-s records at T=32
    (data with the device backend, 2 epochs, valid all, select, test best);
    then ``scgrhc``'s select rescores its comparison CSVs to the same bytes
    and ``scgrhc``'s eval scores the best checkpoint on its test split."""
    from scgrhc.core import paths as jpaths
    from scgrhc_torch.utils.synth import make_synthetic_database

    db = make_synthetic_database(str(tmp_path / "db"), n_records=1, duration_s=16.0, seed=3)
    for mod in (tpaths, jpaths):
        monkeypatch.setattr(mod, "DATA_PATH", os.path.dirname(db))
        monkeypatch.setattr(mod, "PROCESSED_DATA_PATH", db)
    d = str(tmp_path / "exp")
    _write_params(d, total_epochs=2, batch_size=16, data_backend="device")
    assert cli([d, "--device", "cpu"]) == 0
    p = Params(os.path.join(d, "params.json"))
    log = capsys.readouterr().out
    for stage in ("Run recordutil", "Run waveform_train", "Run waveform_test",
                  "Run waveform_checkpoint"):
        assert stage in log
    assert sorted(os.listdir(p.checkpoint_dir_path)) == ["000.checkpoint", "001.checkpoint"]
    assert sorted(os.listdir(os.path.join(d, "comparisons", "valid"))) == ["000.csv", "001.csv"]
    best = open(os.path.join(d, "checkpoint_best.txt")).read().split()[1]
    assert os.listdir(os.path.join(d, "comparisons", "test")) == [best.split(".")[0] + ".csv"]
    lines = open(os.path.join(d, "record_log.txt")).read().splitlines()
    assert lines[1].startswith("All segments: ") and int(lines[1].split()[-1]) > 20

    ours = [open(os.path.join(d, f), "rb").read()
            for f in ("checkpoint_scores.csv", "checkpoint_best.txt")]
    jp = JParams(_write_params(d, total_epochs=2, batch_size=16, data_backend="device",
                               eval_stack=1))
    jselect.run(jp)
    assert [open(os.path.join(d, f), "rb").read()
            for f in ("checkpoint_scores.csv", "checkpoint_best.txt")] == ours
    jd = str(tmp_path / "jax_test")
    shutil.copytree(d, jd, ignore=shutil.ignore_patterns("comparisons"))
    jeval.run(JParams(_write_params(jd, total_epochs=2, batch_size=16)), "test", best)
    name = best.split(".")[0] + ".csv"
    _assert_rows_close(_read_csv(os.path.join(d, "comparisons", "test", name)),
                       _read_csv(os.path.join(jd, "comparisons", "test", name)))


def test_cli_refuses_unported_and_defaults_to_cuda(tmp_path, monkeypatch, capsys):
    """``--help`` lists every subcommand of ``python -m scgrhc``; the six
    host-side ones dispatch (their stages stubbed here; their own tests are
    tests/test_torch_{cli_stages,sweep,summary}.py); ``serve --mesh`` is
    refused and ``sweep --mesh`` is an unknown flag, as in ``scgrhc``
    (``predict --mesh`` runs: tests/test_torch_parallel.py); the device
    stages default to CUDA."""
    from scgrhc_torch import summary
    from scgrhc_torch.pipeline import demo, plots, report, sweep
    from scgrhc_torch.train import checkpoint as ckpt_io
    from scgrhc_torch.utils import experiments

    assert cli(["--help"]) == 0
    usage = capsys.readouterr().out
    assert "export-loaders <dir> [out_dir]" in usage and "Not yet ported" not in usage
    calls = []
    monkeypatch.setattr(summary, "main", lambda: calls.append("summary"))
    monkeypatch.setattr(report, "run", lambda root: calls.append(("report", root)))
    monkeypatch.setattr(demo, "run", lambda w, **kw: calls.append(("demo", w, kw)))
    monkeypatch.setattr(experiments, "write_experiments", lambda root, **kw: [root])
    monkeypatch.setattr(sweep, "run_sweep", lambda dirs, **kw: calls.append(("sweep", kw)) or {})
    monkeypatch.setattr(plots, "run", lambda p, split, ckpt, n: calls.append(("plots", ckpt, n)))
    monkeypatch.setattr(ckpt_io, "export_torch", lambda src, out: calls.append(("export", out)))
    d = str(tmp_path / "exp")
    _write_params(d)
    os.makedirs(os.path.join(d, "checkpoints"))
    open(os.path.join(d, "checkpoints", "003.checkpoint"), "wb").close()
    for argv in (["summary"], ["report", d], ["demo", d, "--epochs", "1", "--device", "cpu"],
                 ["sweep", d, "--fast", "--device", "cpu"], ["plots", d, "valid", "last", "2"],
                 ["export", d, "last", str(tmp_path / "x.torch")]):
        assert argv[0] in usage
        assert cli(argv) == 0
    assert calls == ["summary", ("report", d), ("demo", d, {"epochs": 1, "device": "cpu"}),
                     ("sweep", {"jobs": 1, "inproc": True, "prune": False, "device": "cpu"}),
                     ("plots", "003.checkpoint", 2), ("export", str(tmp_path / "x.torch"))]
    with pytest.raises(SystemExit, match="unknown sweep flag --mesh"):
        cli(["sweep", d, "--mesh"])
    with pytest.raises(SystemExit):
        cli(["test", str(tmp_path), "valid"])
    d = str(tmp_path / "exp")
    _write_params(d)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for argv in ([d], ["test", d, "valid", "all"]):
        with pytest.raises(RuntimeError, match="CUDA"):
            cli(argv)
    assert not os.path.exists(os.path.join(d, "loader_train.pickle"))
