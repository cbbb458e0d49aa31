"""The reference's loader artifacts (pickled torch ``DataLoader``s) in the
port, ``scgrhc_torch.data.torch_export`` and the torch-pickle read in
``scgrhc_torch.data.loaders``, against ``scgrhc``'s, both ways, compared
exactly (arrays bit for bit, names, (lo, hi), batch sizes):

  * the port's pickle read by ``scgrhc.data.loaders.load_dataloader``;
  * ``scgrhc``'s ``export_torch_loader`` pickle read by the port;
  * ``python -m scgrhc_torch export-loaders <dir> [out_dir]`` on an
    experiment the port's data stage built, read back by ``scgrhc``;
  * ``loader_backend: "torch"`` in the port's data stage against the same
    stage of ``scgrhc`` on the same records: the same pickles' contents.
"""

import json
import os
import pickle

import numpy as np
import pytest
import torch

import jax  # noqa: F401  (the conftest keeps JAX on the CPU)
from scgrhc.core.params import Params as JParams
from scgrhc.data import run as jdata
from scgrhc.data.loaders import load_dataloader as jload
from scgrhc.data.torch_export import export_torch_loader as jexport
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.data import run as data_run
from scgrhc_torch.data.loaders import load_dataloader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.data.torch_export import export_torch_loader, store_to_torch_dataset

T = 750
FIELDS = ("scg", "rhc", "start_idx", "stop_idx", "minmax_scg", "minmax_rhc")
SPLITS = ("loader_train.pickle", "loader_valid.pickle", "loader_test.pickle")


def _store(n=6, c=2, seed=0) -> SegmentStore:
    rng = np.random.default_rng(seed)
    mm = np.stack([rng.uniform(-20, 0, n), rng.uniform(30, 60, n)], axis=1)
    return SegmentStore(
        rng.random((n, c, T)).astype(np.float32), rng.random((n, 1, T)).astype(np.float32),
        [f"rec{i % 3}" for i in range(n)], np.arange(n, dtype=np.int64) * T,
        np.arange(n, dtype=np.int64) * T + T, mm.copy(), mm[::-1].copy(), segment_samples=T,
    )


def _assert_same(got, want) -> None:
    """Two loaders (either package's) hold the same segments exactly."""
    assert got.batch_size == want.batch_size
    a, b = got.dataset, want.dataset
    assert list(a.record_names) == list(b.record_names)
    assert a.segment_samples == b.segment_samples
    for k in FIELDS:
        x, y = np.asarray(getattr(a, k)), np.asarray(getattr(b, k))
        assert x.dtype == y.dtype and x.shape == y.shape and np.array_equal(x, y), k


@pytest.fixture()
def both_db(use_synth_db, monkeypatch):
    monkeypatch.setattr(tpaths, "DATA_PATH", os.path.dirname(use_synth_db))
    monkeypatch.setattr(tpaths, "PROCESSED_DATA_PATH", use_synth_db)
    return use_synth_db


def _exp(tmp_path, name, **extra) -> str:
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


@pytest.mark.parametrize("batch_size", [1, 4])
def test_port_pickle_reads_in_scgrhc(tmp_path, batch_size):
    store = _store()
    out = str(tmp_path / "loader.pickle")
    export_torch_loader(store, batch_size, True, out)
    with open(out, "rb") as f:
        raw = f.read()
    assert b"scgrhc" not in raw and b"torch.utils.data" in raw
    loader = pickle.loads(raw)
    assert isinstance(loader, torch.utils.data.DataLoader) and loader.batch_size == batch_size
    item = loader.dataset[2]
    assert item[0].dtype == torch.float32 and tuple(item[0].shape) == (2, T)
    assert item[2:5] == ("rec2", 2 * T, 3 * T)
    assert item[5] == tuple(store.minmax_scg[2]) and item[6] == tuple(store.minmax_rhc[2])
    _assert_same(jload(out), load_dataloader(out))
    back = load_dataloader(out)
    assert back.batch_size == batch_size and back.shuffle
    for k in FIELDS:
        assert np.array_equal(getattr(back.dataset, k), getattr(store, k)), k


def test_scgrhc_pickle_reads_in_the_port(tmp_path):
    from scgrhc.data.store import SegmentStore as JStore

    s = _store(n=5, c=3, seed=1)
    jstore = JStore(s.scg, s.rhc, s.record_names, s.start_idx, s.stop_idx, s.minmax_scg,
                    s.minmax_rhc, segment_samples=T)
    out = str(tmp_path / "loader.pickle")
    jexport(jstore, 4, True, out)
    got = load_dataloader(out, seed=7)
    _assert_same(got, jload(out))
    assert got.seed == 7 and len(got) == 2
    for k in FIELDS:
        assert np.array_equal(getattr(got.dataset, k), getattr(s, k)), k
    # the port batches it as scgrhc does: the same epoch permutation
    assert np.array_equal(got.epoch_order(3), jload(out, seed=7).epoch_order(3))


def test_items_match_scgrhc(tmp_path):
    from scgrhc.data.store import SegmentStore as JStore
    from scgrhc.data.torch_export import store_to_torch_dataset as jitems

    s = _store(n=3)
    ours = store_to_torch_dataset(s)
    theirs = jitems(JStore(s.scg, s.rhc, s.record_names, s.start_idx, s.stop_idx,
                           s.minmax_scg, s.minmax_rhc, segment_samples=T))
    for a, b in zip(ours, theirs, strict=True):
        assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1]) and a[2:] == b[2:]


def test_export_loaders_cli(both_db, tmp_path, capsys):
    params = Params(_exp(tmp_path, "port"))
    data_run.run(params)
    assert cli(["export-loaders", params.dir_path]) == 0
    out_dir = os.path.join(params.dir_path, "torch_loaders")
    assert capsys.readouterr().out.count("Exported ") == 3
    assert sorted(os.listdir(out_dir)) == sorted(SPLITS)
    for name, batch in zip(SPLITS, (8, 1, 1)):
        native = load_dataloader(os.path.join(params.dir_path, name))
        theirs = jload(os.path.join(out_dir, name))
        assert theirs.batch_size == batch
        assert len(theirs.dataset) > 0
        for k in FIELDS:
            assert np.array_equal(getattr(theirs.dataset, k), getattr(native.dataset, k)), k
        assert list(theirs.dataset.record_names) == native.dataset.record_names
    other = str(tmp_path / "elsewhere")
    assert cli(["export-loaders", params.dir_path, other]) == 0
    assert sorted(os.listdir(other)) == sorted(SPLITS)


@pytest.mark.parametrize("global_mm", [False, True])
def test_loader_backend_torch_matches_scgrhc(both_db, tmp_path, global_mm):
    kw = {"loader_backend": "torch", "use_global_min_max": global_mm}
    jp = JParams(_exp(tmp_path, "jax", **kw))
    tp = Params(_exp(tmp_path, "port", **kw))
    jdata.save_dataloaders(jp)
    data_run.run(tp, device="cpu")
    for name in SPLITS:
        ours, theirs = (os.path.join(p.dir_path, name) for p in (tp, jp))
        with open(ours, "rb") as f:
            a = pickle.load(f)
        with open(theirs, "rb") as f:
            b = pickle.load(f)
        assert isinstance(a, torch.utils.data.DataLoader) and a.batch_size == b.batch_size
        assert len(a.dataset) == len(b.dataset) > 0
        for x, y in zip(a.dataset, b.dataset, strict=True):
            assert torch.equal(x[0], y[0]) and torch.equal(x[1], y[1]) and x[2:] == y[2:]
        _assert_same(load_dataloader(ours), jload(theirs))
        _assert_same(jload(ours), load_dataloader(theirs))
