"""The port's data stage against ``scgrhc``.

  * K3's plain version (``scgrhc_torch.ops.kernels.dsp.gate_and_normalize``
    on CPU tensors) against ``scgrhc.ops.pallas.dsp.gate_and_normalize`` in
    interpret mode: ``keep`` and the (lo, hi) pairs equal, the normalized
    windows within 1e-6 absolute (both compute ``(x - lo) / (hi - lo +
    1e-4)`` in float32 on values in [0, 1]; XLA may fuse the subtraction
    and division differently), NaN in the same places.  And its keep mask
    against the host float64 gate, away from the thresholds.
  * The host modules ``dsp.noise``, ``io.sidecar``, ``data.split`` and
    ``data.store`` against their ``scgrhc`` counterparts, exactly.
  * The data stage (``scgrhc_torch.data.run``), both backends, against
    ``scgrhc.data.run.save_dataloaders`` on the synthetic database: the
    loader files array for array, ``record_log.txt`` but its date line.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

from scgrhc.core.params import Params as JParams
from scgrhc.data import run as jdata
from scgrhc.data import split as jsplit
from scgrhc.data import store as jstore
from scgrhc.dsp import noise as jnoise
from scgrhc.dsp import segment as jsegment
from scgrhc.io import catalog as jcatalog
from scgrhc.io import sidecar as jsidecar
from scgrhc.ops.pallas import dsp as jdsp
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.data import run as data_run
from scgrhc_torch.data import split, store
from scgrhc_torch.dsp import noise, segment
from scgrhc_torch.io import catalog, sidecar
from scgrhc_torch.ops.kernels import dsp as k3

NORM_ATOL = 1e-6


def _windows(n, c, t, nan_window=None, seed=0):
    """Sine pressures plus noise, away from the thresholds; with n > 7,
    window 3 flat, 5 a ramp, 7 dipping below min_RHC."""
    rng = np.random.default_rng(seed)
    tt = np.arange(t) / 500.0
    rhc = np.stack([20 + 10 * np.sin(2 * np.pi * (1.0 + 0.2 * i) * tt) + rng.standard_normal(t)
                    for i in range(n)])
    scg = rng.standard_normal((n, c, t)) * rng.uniform(0.1, 5, (n, 1, 1))
    if n > 7:
        rhc[3] = 7.25
        rhc[5] = np.linspace(0, 30, t) + 0.01 * rng.standard_normal(t)
        rhc[7, t // 7] = -80.0
    if nan_window is not None:
        rhc[nan_window, t // 3] = np.nan
        scg[nan_window, c - 1, t // 2] = np.nan
    return scg.astype(np.float32), rhc.astype(np.float32)


@pytest.mark.parametrize("n,c,t,nan_window", [
    (13, 3, 750, None),   # the windows of tests/test_pallas_dsp.py
    (13, 3, 750, 10),     # plus one holding a NaN
    (9, 4, 750, 2),       # ragged N (the JAX kernel pads to 16)
    (9, 1, 32, None),     # T < the flat window: the flat test never fires
    (300, 4, 750, 11),    # a chamber interval's worth
    (9, 2, 12_289, 2),    # past the 12,288 samples the card refused until K3's redesign
])
def test_gate_and_normalize_plain_matches_pallas(n, c, t, nan_window):
    scg, rhc = _windows(n, c, t, nan_window)
    want = [np.asarray(a) for a in jdsp.gate_and_normalize(scg, rhc, -50.0, interpret=True)]
    before = k3.gate_and_normalize.launches
    got = [a.numpy() for a in k3.gate_and_normalize(torch.from_numpy(scg),
                                                    torch.from_numpy(rhc), -50.0)]
    assert k3.gate_and_normalize.launches == before  # CPU tensors take the plain version
    np.testing.assert_array_equal(got[0], want[0])
    for g, w in zip(got[1:], want[1:]):
        assert g.shape == w.shape and g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(np.isnan(g), np.isnan(w))
    np.testing.assert_array_equal(got[3], want[3])
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[1], want[1], atol=NORM_ATOL, rtol=0)
    np.testing.assert_allclose(got[2], want[2], atol=NORM_ATOL, rtol=0)
    if nan_window is not None:
        assert not got[0][nan_window] and np.isnan(got[2][nan_window]).all()
    if n > 7 and t >= 50:
        assert not got[0][[3, 5, 7]].any() and got[0].sum() == n - 3 - (nan_window is not None)


def test_gate_flat_runs_plain_matches_pallas():
    """Flat runs of exactly win samples (one flat position: kept) and win + 1
    (two: dropped) at the window's edges and inside it, and a NaN at sample
    0 and T - 1: the plain version's decisions and pairs are the JAX
    kernel's."""
    t, win = 750, k3.FLAT_WIN
    offsets = [0, win - 1, win, t // 2, t - win - 1]
    scg, rhc = _windows(2 * len(offsets) + 2, 2, t)
    for i, o in enumerate(offsets):
        for j, length in enumerate((win, win + 1)):
            rhc[2 * i + j, o:o + length] = rhc[2 * i + j, o]
    rhc[-2, 0] = rhc[-1, -1] = np.nan
    want = [np.asarray(a) for a in jdsp.gate_and_normalize(scg, rhc, -50.0, interpret=True)]
    got = [a.numpy() for a in k3.gate_and_normalize(torch.from_numpy(scg),
                                                    torch.from_numpy(rhc), -50.0)]
    assert got[0].tolist() == want[0].tolist() == [True, False] * len(offsets) + [False] * 2
    np.testing.assert_array_equal(got[4], want[4])
    np.testing.assert_allclose(got[2], want[2], atol=NORM_ATOL, rtol=0)


@pytest.mark.parametrize("t", [750, 32])
def test_gate_and_normalize_plain_keep_matches_host_float64_gate(t):
    scg, rhc = _windows(13, 2, t)
    keep = k3.gate_and_normalize_plain(torch.from_numpy(scg), torch.from_numpy(rhc), -50.0)[0]
    want = jsegment.gate_windows(rhc.astype(np.float64), -50.0)
    np.testing.assert_array_equal(keep.numpy(), want)
    np.testing.assert_array_equal(segment.gate_windows(rhc.astype(np.float64), -50.0), want)


def test_segment_record_on_device_matches_jax():
    rng = np.random.default_rng(1)
    length = 750 * 5 + 123  # tail truncated
    tt = np.arange(length) / 500.0
    rhc = 20 + 10 * np.sin(2 * np.pi * tt) + rng.standard_normal(length)
    scg = rng.standard_normal((length, 2))
    got = k3.segment_record_on_device(scg, rhc, 750, -50.0, "cpu")
    want = jdsp.segment_record_on_device(scg, rhc, 750, min_rhc=-50.0)
    np.testing.assert_array_equal(got[-1], want[-1])
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    for g, w in zip(got[1:5], want[1:5]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=NORM_ATOL, rtol=0)
    empty = k3.segment_record_on_device(scg[:700], rhc[:700], 750, -50.0, "cpu")
    assert empty[0].shape == (0,) and empty[-1].dtype == np.int64


@pytest.mark.parametrize("kind", ["flat", "ramp", "dip", "clean", "one_flat_window"])
def test_noise_gate_matches_jax(kind):
    rng = np.random.default_rng(4)
    w = 20 + 10 * np.sin(np.arange(750) / 40.0) + rng.standard_normal(750)
    if kind == "flat":
        w[100:200] = 3.0
    elif kind == "ramp":
        w = np.linspace(0, 30, 750) + 0.01 * rng.standard_normal(750)
    elif kind == "dip":
        w[30] = -80.0
    elif kind == "one_flat_window":
        w[100:150] = 3.0  # exactly one flat 50-sample window: the quirk keeps it

    class P:
        min_RHC = -50

    for name in ("has_flat_lines", "is_straight_line", "_r_squared_np"):
        assert getattr(noise, name)(w) == getattr(jnoise, name)(w), name
    assert noise.get_flat_lines(w) == jnoise.get_flat_lines(w)
    assert noise.in_rhc_range(-50, w) == jnoise.in_rhc_range(-50, w)
    assert noise.has_noise(P, w) == jnoise.has_noise(P, w)
    assert noise.has_noise(P, w) == (kind not in ("clean", "one_flat_window"))


@pytest.mark.parametrize("chamber", ["PA", "RV", "RA", "PCW", "LV"])
def test_chamber_intervals_match_jax(synth_db, chamber):
    for name in jcatalog.get_record_names(synth_db):
        assert (sidecar.get_chamber_intervals(name, chamber, synth_db)
                == jsidecar.get_chamber_intervals(name, chamber, synth_db))
    assert catalog.get_record_names(synth_db) == jcatalog.get_record_names(synth_db)
    odd = {"MacStTime": "d 08:00:00", "MacEndTime": "d 08:10:00", "ChamEvents_in_s": None}
    assert sidecar.chamber_intervals_from_sidecar(odd, chamber, 500) == []


@pytest.mark.parametrize("n,seed", [(0, 0), (1, 3), (37, 0), (1200, 7)])
def test_split_matches_jax(n, seed):
    for a, b in zip(split.split_indices(n, seed), jsplit.split_indices(n, seed)):
        np.testing.assert_array_equal(a, b)


def _segments(seed=0, n=5, c=2, t=40):
    rng = np.random.default_rng(seed)
    return [jsegment.Segment(rng.standard_normal((t - 3 * (i % 2), c)) * 4 + i,
                             rng.random((t - 3 * (i % 2), 1)) * 30, f"R{i}", i * t, i * t + t)
            for i in range(n)]


@pytest.mark.parametrize("global_mm", [False, True])
def test_store_from_segments_matches_jax(global_mm):
    segs = _segments()  # odd windows are short: zero-padded to t
    mm = jstore.get_global_minmax_vals(segs) if global_mm else (None, None)
    assert store.get_global_minmax_vals(segs) == jstore.get_global_minmax_vals(segs)
    got = store.SegmentStore.from_segments(segs, 40 / 500, *mm)
    want = jstore.SegmentStore.from_segments(segs, 40 / 500, *mm)
    for name in ("scg", "rhc", "start_idx", "stop_idx", "minmax_scg", "minmax_rhc"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))
    for i in range(len(segs)):
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(a, b)
    x = np.linspace(-3, 7, 11)
    assert np.array_equal(store.reverse_minmax(x, -2.0, 5.0), jstore.reverse_minmax(x, -2.0, 5.0))
    np.testing.assert_array_equal(store._pad_or_truncate(np.ones((2, 50)), 40),
                                  jstore._pad_or_truncate(np.ones((2, 50)), 40))


# ---- the data stage on the synthetic database --------------------------------

@pytest.fixture()
def port_db(use_synth_db, monkeypatch):
    monkeypatch.setattr(tpaths, "DATA_PATH", os.path.dirname(use_synth_db))
    monkeypatch.setattr(tpaths, "PROCESSED_DATA_PATH", use_synth_db)
    return use_synth_db


def _exp(tmp_path, name, **extra):
    d = tmp_path / name
    os.makedirs(d, exist_ok=True)
    cfg = {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ECG"], "chamber": "PA",
        "segment_size": 1.5, "batch_size": 8, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 1, "min_RHC": -50, "use_global_min_max": False, "seed": 5, **extra,
    }
    (d / "params.json").write_text(json.dumps(cfg))
    return str(d / "params.json")


def _loader_files(params):
    out = {}
    for path in (params.train_path, params.valid_path, params.test_path):
        with open(path, "rb") as f:
            out[os.path.basename(path)] = pickle.load(f)
    return out


def _assert_same_loaders(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name, g in got.items():
        w = want[name]
        assert {k: g[k] for k in ("format", "batch_size", "shuffle", "seed")} == \
            {k: w[k] for k in ("format", "batch_size", "shuffle", "seed")}, name
        assert g["store"].keys() == w["store"].keys()
        for k, v in g["store"].items():
            if isinstance(v, np.ndarray):
                assert v.dtype == w["store"][k].dtype, (name, k)
                np.testing.assert_array_equal(v, w["store"][k], err_msg=f"{name} {k}")
            else:
                assert v == w["store"][k], (name, k)


@pytest.mark.parametrize("backend", ["host", "device"])
@pytest.mark.parametrize("global_mm", [False, True])
def test_data_stage_matches_jax(port_db, tmp_path, backend, global_mm):
    kw = {"data_backend": backend, "use_global_min_max": global_mm}
    jp = JParams(_exp(tmp_path, "jax", **kw))
    tp = Params(_exp(tmp_path, "port", **kw))
    jdata.save_dataloaders(jp)
    before = k3.gate_and_normalize.launches
    data_run.run(tp, device="cpu")
    assert k3.gate_and_normalize.launches == before
    got, want = _loader_files(tp), _loader_files(jp)
    _assert_same_loaders(got, want)
    assert len(got["loader_train.pickle"]["store"]["record_names"]) > 20
    logs = [open(os.path.join(p.dir_path, "record_log.txt")).read().splitlines()
            for p in (tp, jp)]
    assert logs[0][0].startswith("Dataset created: ") and logs[0][1:] == logs[1][1:]


def test_data_stage_device_backend_defaults_to_cuda(port_db, tmp_path, monkeypatch):
    """The device backend resolves the device (CUDA by default, raising
    without it); the host backend touches none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        data_run.run(Params(_exp(tmp_path, "dev", data_backend="device")))
    host = Params(_exp(tmp_path, "host"))
    data_run.run(host)
    assert os.path.exists(host.test_path)


@pytest.mark.parametrize("existing", ["train_path", "valid_path", "test_path"])
def test_data_stage_overwrite_guards(port_db, tmp_path, existing):
    tp = Params(_exp(tmp_path, "port"))
    open(getattr(tp, existing), "w").close()
    with pytest.raises(Exception, match=f"{existing.split('_')[0].title()} file already exists!"):
        data_run.save_dataloaders(tp, device="cpu")


def test_data_stage_refuses_unported(port_db, tmp_path, monkeypatch):
    """A launch into a world (``WORLD_SIZE`` > 1) with no process group up
    refuses to build alone (tests/test_torch_multiprocess.py builds in
    one, on rank 0)."""
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        data_run.run(Params(_exp(tmp_path, "multi")), device="cpu")
