"""The port's copies of the host-side modules (params, WFDB I/O, catalog,
synthetic database, checkpoint reading) against the scgrhc originals."""

import filecmp
import json
import os

import jax
import numpy as np
import pytest

from scgrhc.core.params import Params as JParams
from scgrhc.io import catalog as jcat
from scgrhc.io import wfdb as jwfdb
from scgrhc.train import checkpoint as jckpt
from scgrhc.train.wgan import TrainConfig, init_state
from scgrhc.utils.synth import make_synthetic_database as jsynth
from scgrhc_torch.core.params import Params as TParams
from scgrhc_torch.io import catalog as tcat
from scgrhc_torch.io import wfdb as twfdb
from scgrhc_torch.train import checkpoint as tckpt
from scgrhc_torch.utils.synth import make_synthetic_database as tsynth

CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv", "patch_ECG"]


@pytest.mark.parametrize("extra", [{}, {"train_profile": "fast", "seed": 3}])
def test_params_match(tmp_path, extra):
    cfg = {
        "dir_path": str(tmp_path), "in_channels": CHANNELS[:2], "chamber": "PA",
        "segment_size": 1.5, "batch_size": 8, "train_path": "a", "valid_path": "b",
        "test_path": "c", "checkpoint_dir_path": "ck", "comparison_dir_path": "cmp",
        "pred_top_dir_path": "t", "pred_rand_dir_path": "r", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 2, "lambda_gp": 10,
        "lambda_aux": 100, "total_epochs": 1, "min_RHC": -50,
        "use_global_min_max": False, **extra,
    }
    path = tmp_path / "params.json"
    path.write_text(json.dumps(cfg))
    j, t = JParams(str(path)), TParams(str(path))
    assert vars(t) == vars(j)
    assert t.segment_samples == j.segment_samples == 750


def test_synthetic_database_is_byte_identical(tmp_path):
    a = jsynth(str(tmp_path / "j"), n_records=1, duration_s=12.0, seed=4)
    b = tsynth(str(tmp_path / "t"), n_records=1, duration_s=12.0, seed=4)
    names = sorted(os.listdir(a))
    assert names == sorted(os.listdir(b))
    _, mismatch, errors = filecmp.cmpfiles(a, b, names, shallow=False)
    assert mismatch == [] and errors == []


@pytest.mark.parametrize("fmt", ["16", "212", "80", "24", "311"])
def test_wfdb_read_and_digital_match(tmp_path, fmt):
    rng = np.random.default_rng(int(fmt))
    sig = rng.standard_normal((500, 3)) * 0.3
    path = str(tmp_path / "REC")
    twfdb.wrrecord(path, 500, ["a", "b", "c"], sig, gain=200.0, fmt=fmt)
    want = jwfdb.rdrecord(path)
    got = twfdb.rdrecord(path)
    np.testing.assert_array_equal(got.p_signal, want.p_signal)
    assert got.sig_name == want.sig_name and got.fs == want.fs
    jd, td = jwfdb.rdrecord_digital(path), twfdb.rdrecord_digital(path)
    assert (jd is None) == (td is None)
    if jd is not None:
        for g, w in zip(td, jd):
            np.testing.assert_array_equal(g, w)


def test_catalog_matches(synth_db):
    want = jcat.read_record_digital("SYN000", CHANNELS[::-1], synth_db)
    got = tcat.read_record_digital("SYN000", CHANNELS[::-1], synth_db)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    rec_j = jcat.read_record("SYN001", synth_db)
    rec_t = tcat.read_record("SYN001", synth_db)
    np.testing.assert_array_equal(
        tcat.get_channels(rec_t, CHANNELS[1:3], 10, 900),
        jcat.get_channels(rec_j, CHANNELS[1:3], 10, 900),
    )


def test_checkpoint_read_side_matches(tmp_path):
    d = tmp_path / "checkpoints"
    d.mkdir()
    state = init_state(jax.random.key(1), 2, TrainConfig())
    for epoch in (1, 2):
        jckpt.save(str(d / f"{epoch:03d}.checkpoint"), start_time=0.0, epoch=epoch,
                   g_losses=[], d_losses=[], state=state)
    jckpt.export_torch(str(d / "002.checkpoint"), str(tmp_path / "002.torch"))
    (d / "003.checkpoint.tmp").write_bytes(b"partial")  # in-flight write
    (d / "003.checkpoint.orbax").mkdir()  # orbax dir without meta.json
    (d / "004.torch").write_bytes(b"export")
    assert tckpt.get_last_checkpoint_path(str(d)) == jckpt.get_last_checkpoint_path(str(d))
    assert tckpt.list_checkpoints(str(d)) == jckpt.list_checkpoints(str(d))
    assert tckpt.get_last_checkpoint_path(str(tmp_path / "missing")) is None
    for path in (d / "001.checkpoint", tmp_path / "002.torch"):
        got, want = tckpt.load(str(path)), jckpt.load(str(path))
        assert got["epoch"] == want["epoch"]
        assert list(got["g_state_dict"]) == list(want["g_state_dict"])
        for k, v in want["g_state_dict"].items():
            np.testing.assert_array_equal(got["g_state_dict"][k], v)
