"""The port's serve daemon and predict stage (scgrhc_torch.pipeline) against
scgrhc.pipeline.serve: the same checkpoint, written by
scgrhc.train.checkpoint.save, and the same requests give the same response
fields, the same per-request errors, and waveforms within an f32 envelope.

The envelope: on the synthetic records at T=750, each package's f32
forward sits up to 4.4e-4 from the float64 forward of the same weights
(instance norm amplifies the f32 rounding of low-variance windows), and
the two f32 results differ from each other by as much, so waveforms are
held to 1e-3."""

import io
import json
import os

import jax
import numpy as np
import pytest
import torch

from scgrhc.core.params import Params as JParams
from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params as TParams

ATOL = 1e-3


@pytest.fixture()
def exp_dir(use_synth_db, monkeypatch, tmp_path):
    monkeypatch.setattr(tpaths, "DATA_PATH", os.path.dirname(use_synth_db))
    monkeypatch.setattr(tpaths, "PROCESSED_DATA_PATH", use_synth_db)
    d = tmp_path / "exp"
    os.makedirs(d / "checkpoints")
    cfg = {
        "dir_path": str(d),
        "in_channels": ["patch_ACC_lat", "patch_ACC_hf"],
        "chamber": "PA", "segment_size": 1.5, "batch_size": 8,
        "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle",
        "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand",
        "alpha": 1e-4, "beta1": 0.5, "beta2": 0.999, "n_critic": 2,
        "lambda_gp": 10, "lambda_aux": 100, "total_epochs": 1,
        "min_RHC": -50, "use_global_min_max": False,
    }
    (d / "params.json").write_text(json.dumps(cfg))
    state = init_state(jax.random.key(0), 2, TrainConfig())
    jckpt.save(str(d / "checkpoints" / "003.checkpoint"), start_time=0.0,
               epoch=3, g_losses=[], d_losses=[], state=state)
    return d


def _serve(module, params, requests, **kw):
    out = io.StringIO()
    lines = [r if isinstance(r, str) else json.dumps(r) for r in requests]
    served = module.run(params, checkpoint="last",
                        stdin=io.StringIO("\n".join(lines) + "\n"), stdout=out, **kw)
    return served, [json.loads(line) for line in out.getvalue().splitlines()]


def test_serve_matches_jax(exp_dir, tmp_path):
    from scgrhc.pipeline import serve as jserve
    from scgrhc_torch.pipeline import serve as tserve

    requests = [
        {"cmd": "ping"},
        {"record": "SYN000", "save": False},
        {"record": "NO_SUCH_RECORD"},
        "not json at all",
        {"record": "../SYN000"},
        {"record": "SYN000", "save": False, "overlap_s": 1.5},
        {"record": "SYN001"},
        {"cmd": "quit"},
        {"record": "ignored-after-quit"},
    ]
    p = str(exp_dir / "params.json")
    j_served, want = _serve(jserve, JParams(p), requests, out_dir=str(tmp_path / "j"))
    t_served, got = _serve(tserve, TParams(p), requests, out_dir=str(tmp_path / "t"),
                           device="cpu")
    assert t_served == j_served == 2
    assert len(got) == len(want) == 7
    assert got[0] == want[0] == {"ok": True, "checkpoint": "003.checkpoint"}
    for g, w in zip(got[2:6], want[2:6]):  # per-request errors, same kind
        assert set(g) == set(w) == {"error"}
        assert g["error"].split(":")[0] == w["error"].split(":")[0]
    assert "overlap" in got[5]["error"]
    for g, w in ((got[1], want[1]), (got[6], want[6])):
        assert set(g) == set(w)
        for k in ("record", "mode", "n_samples", "seconds", "checkpoint", "calibrated"):
            assert g[k] == w[k], k
        assert g["n_samples"] == 80 * 750
    np.testing.assert_allclose(np.asarray(got[1]["waveform"], np.float32),
                               np.asarray(want[1]["waveform"], np.float32), atol=ATOL)
    assert got[6]["path"] == str(tmp_path / "t" / "SYN001.npy")
    np.testing.assert_allclose(np.load(got[6]["path"]), np.load(want[6]["path"]),
                               atol=ATOL)


def test_predict_writes_waveform_and_sidecar(exp_dir):
    from scgrhc_torch.pipeline import predict

    params = TParams(str(exp_dir / "params.json"))
    path = predict.run(params, "SYN000", checkpoint="last", overlap_s=0.5,
                       device="cpu")
    pred = np.load(path)
    hop = 750 - 250
    assert pred.shape == (hop * ((120 * 500 - 750) // hop) + 750,)
    assert np.isfinite(pred).all()
    meta = json.loads((exp_dir / "predictions" / "SYN000.json").read_text())
    assert meta["overlap_samples"] == 250 and meta["n_samples"] == pred.shape[0]
    assert meta["checkpoint"] == "003.checkpoint" and meta["mode"] == "windowed"


def test_serve_defaults_to_cuda_and_refuses_without_it(exp_dir, monkeypatch):
    from scgrhc_torch.pipeline import serve as tserve

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        _serve(tserve, TParams(str(exp_dir / "params.json")), [{"cmd": "ping"}])


def test_cli_serve_on_cpu(exp_dir, monkeypatch, capsys):
    from scgrhc_torch.__main__ import main

    monkeypatch.setattr("sys.stdin", io.StringIO('{"cmd": "ping"}\n{"cmd": "quit"}\n'))
    assert main(["serve", str(exp_dir), "last", "--timeout", "30", "--device", "cpu"]) == 0
    assert json.loads(capsys.readouterr().out) == {"ok": True, "checkpoint": "003.checkpoint"}


def test_serve_timeout_bounds_wedged_request(exp_dir, monkeypatch):
    import threading

    from scgrhc_torch.pipeline import serve as tserve

    release = threading.Event()

    def wedge_once(req, ctx):
        if req["record"] == "SYN000":
            release.wait(30)
            return {"never": "delivered"}
        return {"record": req["record"], "mode": "stub"}

    monkeypatch.setattr(tserve, "_handle", wedge_once)
    try:
        served, resp = _serve(
            tserve, TParams(str(exp_dir / "params.json")),
            [{"record": "SYN000"}, {"cmd": "ping"}, {"record": "SYN001"}],
            timeout=0.3, device="cpu",
        )
    finally:
        release.set()
    assert "TimeoutError" in resp[0]["error"] and "abandoned" in resp[0]["error"]
    assert resp[1]["ok"] is True and resp[2]["record"] == "SYN001"
    assert served == 1
