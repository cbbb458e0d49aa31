"""The port's continuous and calibrated prediction and serving
(scgrhc_torch.pipeline.predict, .serve, the CLI) against scgrhc's, on two
synthetic records of 24 s (12,001 samples, 16 windows) made by the
conftest's ``make_synthetic_database``, with a checkpoint written by
``scgrhc.train.checkpoint.save`` and the splits written as loader files.
The length is odd on purpose: on more than one device scgrhc runs a
record whose length divides the device count through its time-sharded
``apply_cp`` (the tests have 8 virtual devices; tests/
test_torch_time_axis.py holds the port's ``apply_cp`` to it); at 12,001
samples it takes ``apply_continuous``, the port's one-rank path, and the
short records keep the CPU's whole-record passes to about a second.

  * ``predict.run(continuous=True)``: the same sidecar keys and values, the
    ``.npy`` within CONT_ATOL of scgrhc's: each instance norm runs over the
    whole record in f32 in both packages, summed in other orders (measured
    1.6e-4 on outputs within about ±6.8); held to 1e-3, the windowed path's
    cross-package f32 envelope (test_torch_serve.py).
  * ``calibrate=True``: (lo, hi) equal ``scgrhc``'s ``cohort_rhc_minmax`` on
    the same loader files, native and pickled torch DataLoaders alike, and
    the denormalized waveform within CAL_ATOL of scgrhc's: the windowed
    envelope times the span hi − lo (measured 9.1e-3 continuous, on
    outputs up to 390 mmHg at random weights).
  * The daemon's ``continuous`` and ``calibrate`` request modes, its
    ``--calibrate``, and lazy calibration (tests/test_serve.py:168): the
    same response fields as scgrhc's, ``mode`` and ``calibrated`` included.
  * The CLI passes ``--continuous`` and ``--calibrate`` through.
"""

import io
import json
import os

import jax
import numpy as np
import pytest

from scgrhc.core.params import Params as JParams
from scgrhc.pipeline import predict as jpredict
from scgrhc.pipeline import serve as jserve
from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params as TParams
from scgrhc_torch.data.loaders import SegmentLoader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.pipeline import predict
from scgrhc_torch.pipeline import serve

ATOL = 1e-3  # the windowed path's cross-package f32 envelope
CONT_ATOL = 1e-3
LO, HI = 4.5, 61.25  # the train split's RHC range, from its stored (min, max)
CAL_ATOL = ATOL * (HI - LO)


def _train_store(n=6, t=750):
    rng = np.random.default_rng(0)
    lo = rng.uniform(LO, 20.0, n)
    lo[2] = LO
    hi = rng.uniform(30.0, HI, n)
    hi[4] = HI
    mm = np.stack([lo, hi], axis=1)
    return SegmentStore(rng.random((n, 2, t)).astype(np.float32),
                        rng.random((n, 1, t)).astype(np.float32),
                        [f"SYN{i:03d}" for i in range(n)], np.arange(n, dtype=np.int64) * t,
                        np.arange(1, n + 1, dtype=np.int64) * t, mm.copy(), mm.copy(),
                        segment_samples=t)


RECORD_S = 24.003  # 12,001 samples at 500 Hz


@pytest.fixture(scope="module")
def short_db(tmp_path_factory):
    from scgrhc.utils.synth import make_synthetic_database

    root = tmp_path_factory.mktemp("shortdb")
    return make_synthetic_database(str(root), n_records=2, duration_s=RECORD_S)


@pytest.fixture()
def exp_dir(short_db, monkeypatch, tmp_path):
    from scgrhc.core import paths as jpaths

    for mod in (tpaths, jpaths):
        monkeypatch.setattr(mod, "DATA_PATH", os.path.dirname(short_db))
        monkeypatch.setattr(mod, "PROCESSED_DATA_PATH", short_db)
    d = tmp_path / "exp"
    os.makedirs(d / "checkpoints")
    cfg = {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"],
        "chamber": "PA", "segment_size": 1.5, "batch_size": 8,
        "train_path": "loader_train.pickle", "valid_path": "loader_valid.pickle",
        "test_path": "loader_test.pickle", "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "comparisons", "pred_top_dir_path": "pred_top",
        "pred_rand_dir_path": "pred_rand", "alpha": 1e-4, "beta1": 0.5, "beta2": 0.999,
        "n_critic": 2, "lambda_gp": 10, "lambda_aux": 100, "total_epochs": 1,
        "min_RHC": -50, "use_global_min_max": False,
    }
    (d / "params.json").write_text(json.dumps(cfg))
    jckpt.save(str(d / "checkpoints" / "003.checkpoint"), start_time=0.0, epoch=3,
               g_losses=[], d_losses=[], state=init_state(jax.random.key(0), 2, TrainConfig()))
    for split in ("train", "valid", "test"):
        SegmentLoader(_train_store(), 8).save(str(d / f"loader_{split}.pickle"))
    return d


def _params(d):
    p = str(d / "params.json")
    return JParams(p), TParams(p)


def _serve(module, params, requests, **kw):
    out = io.StringIO()
    served = module.run(params, checkpoint="last", stdout=out,
                        stdin=io.StringIO("".join(json.dumps(r) + "\n" for r in requests)), **kw)
    return served, [json.loads(line) for line in out.getvalue().splitlines()]


def test_cohort_rhc_minmax_matches_jax_native_and_pickled(exp_dir):
    from scgrhc_torch.data.torch_export import export_torch_loaders

    jp, tp = _params(exp_dir)
    assert predict.cohort_rhc_minmax(tp) == jpredict.cohort_rhc_minmax(jp) == (LO, HI)
    # the same train split as a pickled torch DataLoader
    out = exp_dir / "torch_loaders"
    export_torch_loaders(tp, str(out))
    tp.train_path = jp.train_path = str(out / "loader_train.pickle")
    assert predict.cohort_rhc_minmax(tp) == jpredict.cohort_rhc_minmax(jp) == (LO, HI)


@pytest.mark.parametrize("calibrate", [False, True])
def test_predict_continuous_matches_jax(exp_dir, tmp_path, calibrate):
    jp, tp = _params(exp_dir)
    want = jpredict.run(jp, "SYN000", "last", continuous=True, calibrate=calibrate,
                        out_dir=str(tmp_path / "j"))
    got = predict.run(tp, "SYN000", "last", continuous=True, calibrate=calibrate,
                      out_dir=str(tmp_path / "t"), device="cpu")
    g, w = np.load(got), np.load(want)
    assert g.shape == w.shape == (12_001,) and g.dtype == np.float32
    np.testing.assert_allclose(g, w, atol=CAL_ATOL if calibrate else CONT_ATOL, rtol=0)
    side = [json.loads(open(p.replace(".npy", ".json")).read()) for p in (got, want)]
    assert side[0] == side[1]
    assert side[0]["mode"] == "continuous" and side[0]["denormalized"] is calibrate


def test_predict_calibrated_windowed_matches_jax(exp_dir, tmp_path):
    jp, tp = _params(exp_dir)
    want = np.load(jpredict.run(jp, "SYN001", "last", calibrate=True,
                                out_dir=str(tmp_path / "j")))
    raw = np.load(predict.run(tp, "SYN001", "last", out_dir=str(tmp_path / "r"),
                              device="cpu"))
    got = np.load(predict.run(tp, "SYN001", "last", calibrate=True,
                              out_dir=str(tmp_path / "t"), device="cpu"))
    np.testing.assert_allclose(got, want, atol=CAL_ATOL, rtol=0)
    np.testing.assert_allclose(got, raw * np.float32(HI - LO) + np.float32(LO), rtol=1e-6,
                               atol=1e-4)


def test_serve_request_modes_match_jax(exp_dir):
    """``continuous`` and ``calibrate`` per request, and both at once."""
    reqs = [{"record": "SYN000", "save": False, "continuous": True},
            {"record": "SYN000", "save": False, "calibrate": True},
            {"record": "SYN000", "save": False, "continuous": True, "calibrate": True}]
    jp, tp = _params(exp_dir)
    j_served, want = _serve(jserve, jp, reqs)
    t_served, got = _serve(serve, tp, reqs, device="cpu")
    assert t_served == j_served == 3
    for g, w, (mode, cal) in zip(got, want, [("continuous", False), ("windowed", True),
                                             ("continuous", True)]):
        assert set(g) == set(w)
        for k in ("record", "mode", "n_samples", "seconds", "checkpoint", "calibrated"):
            assert g[k] == w[k], k
        assert (g["mode"], g["calibrated"]) == (mode, cal)
        np.testing.assert_allclose(np.asarray(g["waveform"], np.float32),
                                   np.asarray(w["waveform"], np.float32),
                                   atol=CAL_ATOL if cal else CONT_ATOL, rtol=0)


def test_serve_lazy_calibrate(exp_dir, monkeypatch):
    """A daemon started without --calibrate reads the range at the first
    request that asks, once, and flags the response (tests/test_serve.py:168)."""
    _, tp = _params(exp_dir)
    calls = []
    real = serve.cohort_rhc_minmax

    def counted(params):
        calls.append(params)
        return real(params)

    monkeypatch.setattr(serve, "cohort_rhc_minmax", counted)
    _, resp = _serve(serve, tp, [{"record": "SYN000", "save": False},
                                 {"record": "SYN000", "save": False, "calibrate": True},
                                 {"record": "SYN000", "save": False, "calibrate": True}],
                     device="cpu")
    assert [r["calibrated"] for r in resp] == [False, True, True] and len(calls) == 1
    raw, cal = (np.asarray(resp[i]["waveform"]) for i in (0, 1))
    assert np.ptp(cal) > np.ptp(raw)
    np.testing.assert_allclose(cal, raw * (HI - LO) + LO, rtol=1e-6, atol=1e-4)


def test_serve_daemon_calibrate_matches_jax(exp_dir):
    """``--calibrate``: every request calibrated unless it says otherwise."""
    reqs = [{"record": "SYN001", "save": False},
            {"record": "SYN001", "save": False, "calibrate": False}]
    jp, tp = _params(exp_dir)
    _, want = _serve(jserve, jp, reqs, calibrate=True)
    _, got = _serve(serve, tp, reqs, calibrate=True, device="cpu")
    assert [r["calibrated"] for r in got] == [r["calibrated"] for r in want] == [True, False]
    for g, w, tol in zip(got, want, (CAL_ATOL, ATOL)):
        np.testing.assert_allclose(np.asarray(g["waveform"], np.float32),
                                   np.asarray(w["waveform"], np.float32), atol=tol, rtol=0)


@pytest.mark.parametrize("cmd", ["predict", "serve"])
def test_cli_passes_continuous_and_calibrate_through(exp_dir, monkeypatch, capsys, cmd):
    from scgrhc_torch.__main__ import main

    if cmd == "predict":
        assert main(["predict", str(exp_dir), "SYN000", "last", "--continuous", "--calibrate",
                     "--device", "cpu"]) == 0
        side = json.loads((exp_dir / "predictions" / "SYN000.json").read_text())
        assert side["mode"] == "continuous" and side["denormalized"] is True
        assert np.load(exp_dir / "predictions" / "SYN000.npy").shape == (12_001,)
        return
    monkeypatch.setattr("sys.stdin", io.StringIO('{"record": "SYN001", "save": false}\n'))
    assert main(["serve", str(exp_dir), "last", "--calibrate", "--device", "cpu"]) == 0
    resp = json.loads(capsys.readouterr().out)
    assert resp["calibrated"] is True and resp["mode"] == "windowed"
