"""Orbax checkpoints that ``scgrhc`` saves on more than one device, read by
the port (``scgrhc_torch.train.zarr2`` under ``orbax_io.read``).

Orbax's replica-parallel save of a replicated state writes each array as a
grid of zarr v2 chunks, one slice per replica: the first axis that the
replica count divides is cut (``zarr2.replica_chunks``).  Here:

  (a) ``scgrhc.train.orbax_io.save`` of a full-width state replicated over
      8 devices and over ``make_mesh(3)`` (the tap axis split): every leaf
      bit for bit, and the store holds the grids the rule names;
  (b) ``scgrhc``'s data stage and training under DP on the 8 virtual
      devices with ``checkpoint_backend: "orbax"``, then the port's
      ``test`` (within 1e-3 of ``scgrhc``'s own), ``select``, ``predict``,
      ``export`` and a ``train`` resume, each held to the same stage on
      ``scgrhc``'s pickle of the same state;
  (c) tensorstore's zarr arrays on an ocdbt kvstore whose chunks do not
      divide the shape, both ways;
  (d) a missing chunk, a short chunk and the other refusals, each naming
      the array;
  (e) ``chip_smoke.py``'s split copy (``zarr2.encode(..., chunks=...)``)
      of a one-device save, equal to Orbax's own save on 4 devices, and of
      a port checkpoint, restored by Orbax bit for bit;
  and a save by two ``jax.distributed`` processes (``ocdbt.process_1/``).
"""

import json
import os
import pickle
import shutil
import socket
import subprocess
import sys
import textwrap

import jax
import numpy as np
import pytest
import torch

from scgrhc.core import paths as jpaths
from scgrhc.core.params import Params as JParams
from scgrhc.data import run as jdata
from scgrhc.eval import run as jeval
from scgrhc.parallel.mesh import make_mesh, replicate
from scgrhc.select import run as jselect
from scgrhc.train import checkpoint as jckpt
from scgrhc.train import orbax_io as jorbax
from scgrhc.train import run as jtrain
from scgrhc.train import wgan as jwgan
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.native import zstd
from scgrhc_torch.select import run as select_run
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import ocdbt, orbax_io, zarr2
from test_torch_eval import METRICS, _read_csv
from test_torch_orbax import (C, ENVELOPE, _assert_same_leaves, _jax_state_with_moments,
                              _pipeline_params, _port_state, _state_dict, _want_dict)

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")

N_ARRAYS = 194  # the training state's leaves at any width


def _zarrays(path) -> dict:
    """name → ``.zarray`` metadata of every array in an Orbax directory."""
    return {k[:-len(b"/.zarray")].decode(): json.loads(v)
            for k, v in ocdbt.read(path).items() if k.endswith(b"/.zarray")}


def _split(metas: dict) -> dict:
    return {n: m for n, m in metas.items() if m["chunks"] != m["shape"]}


def _chip_smoke():
    """``chip_smoke.py`` as a module: its ``_orbax_split_copy`` writes the
    split copy that its ``orbax`` phase loads on the card."""
    import importlib.util

    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(root, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# ---- (a) a replicated state saved by scgrhc ----------------------------------------------

@pytest.fixture(scope="module")
def jax_state():
    return _jax_state_with_moments(C)[0]


@pytest.mark.parametrize("devices,axis,at_least", [(8, 0, 150), (3, 2, 60)])
def test_replicated_save_loads_bit_for_bit(tmp_path, jax_state, devices, axis, at_least):
    """``scgrhc``'s save of the state replicated over ``devices`` → every
    leaf bit for bit; at least ``at_least`` arrays are grids, split on
    ``axis`` (the taps, [512,256,3] → [512,256,1], at 3 devices), each as
    ``zarr2.replica_chunks`` says."""
    path = str(tmp_path / "003.checkpoint")
    jorbax.save(path, start_time=1.5, epoch=3, g_losses=[1.0], d_losses=[2.0],
                state=replicate(make_mesh(devices), jax_state))
    metas = _zarrays(path + ".orbax")
    assert len(metas) == N_ARRAYS
    split = _split(metas)
    on_axis = [m for m in split.values() if m["chunks"][axis] != m["shape"][axis]]
    assert len(split) >= at_least and len(on_axis) >= at_least, (len(split), len(on_axis))
    for n, m in metas.items():
        assert m["chunks"] == zarr2.replica_chunks(m["shape"], devices), n
    ckpt = ckpt_io.load(path + ".orbax")
    assert (ckpt["epoch"], ckpt["g_losses"], ckpt["d_losses"]) == (3, [1.0], [2.0])
    _assert_same_leaves(ckpt, _want_dict(jax_state))


# ---- (b) scgrhc trained under DP on 8 devices --------------------------------------------

@pytest.fixture(scope="module")
def dp_trained(tmp_path_factory):
    """``scgrhc``'s data stage and 2 epochs of its training on the 8
    virtual devices (DP) with ``checkpoint_backend: "orbax"`` at T = 32, and
    a twin experiment whose checkpoints are ``scgrhc``'s pickles of the
    same states."""
    from scgrhc_torch.utils.synth import make_synthetic_database

    assert jax.device_count() == 8
    root = tmp_path_factory.mktemp("orbaxdp")
    db = make_synthetic_database(str(root / "db"), n_records=1, duration_s=16.0, seed=3)
    mp = pytest.MonkeyPatch()
    for mod in (tpaths, jpaths):
        mp.setattr(mod, "DATA_PATH", os.path.dirname(db))
        mp.setattr(mod, "PROCESSED_DATA_PATH", db)
    d = str(root / "dp")
    jp = JParams(_pipeline_params(d, checkpoint_backend="orbax"))
    jdata.run(jp)
    jtrain.run(jp, plot=False)
    twin = str(root / "twin")
    shutil.copytree(d, twin, ignore=shutil.ignore_patterns("checkpoints"))
    os.makedirs(os.path.join(twin, "checkpoints"))
    _pipeline_params(twin)
    cfg = jwgan.TrainConfig.from_params(jp)
    for e in (0, 1):
        name = f"{e:03d}.checkpoint"
        meta, state = jorbax.load(os.path.join(d, "checkpoints", name + ".orbax"), cfg, 2)
        jckpt.save(os.path.join(twin, "checkpoints", name), state=state, **meta)
    yield d, twin
    mp.undo()


def test_dp_checkpoints_are_grids_and_load_as_their_pickles(dp_trained):
    d, twin = dp_trained
    for e in (0, 1):
        name = f"{e:03d}.checkpoint"
        path = os.path.join(d, "checkpoints", name + ".orbax")
        assert len(_split(_zarrays(path))) >= 150
        got, want = ckpt_io.load(path), ckpt_io.load(os.path.join(twin, "checkpoints", name))
        assert got["g_losses"] == want["g_losses"] and got["d_losses"] == want["d_losses"]
        _assert_same_leaves(got, want)


def _assert_scores_close(got: dict, want: dict):
    """Each window's prediction and scores within the envelope.  A window
    whose real RHC is constant has no Pearson r: the port writes NaN (an
    empty cell, as scipy's ``pearsonr`` in the reference gives NaN), while
    ``scgrhc``'s f32 mean leaves a rounding residue that makes it 1.0; its
    RMSE is still held."""
    assert got.keys() == want.keys() and got
    for k, w in want.items():
        g = got[k]
        assert (g["stop_idx"], g["real_rhc"]) == (w["stop_idx"], w["real_rhc"])
        pw, pg = (select_run.get_float_array(r["pred_rhc"]) for r in (w, g))
        np.testing.assert_allclose(pg, pw, rtol=ENVELOPE, atol=ENVELOPE * np.abs(pw).max())
        flat = np.ptp(select_run.get_float_array(w["real_rhc"])) == 0
        for m in METRICS:
            if flat and m.startswith("pcc"):
                assert g[m] == "", (k, m, g[m])
                continue
            np.testing.assert_allclose(float(g[m]), float(w[m]), rtol=ENVELOPE, atol=ENVELOPE,
                                       err_msg=f"{k} {m}")


def test_port_test_and_select_on_dp_checkpoints(dp_trained, tmp_path, capsys):
    """The port's ``test <dir> valid all`` within 1e-3 of ``scgrhc``'s own
    ``test`` of the same ``.orbax`` dirs, then the port's ``select``, whose
    files ``scgrhc``'s ``select`` rewrites byte for byte."""
    d, _ = dp_trained
    pd_, jd = str(tmp_path / "port"), str(tmp_path / "jax")
    for dst in (pd_, jd):
        shutil.copytree(d, dst, ignore=shutil.ignore_patterns("comparisons", "predictions"))
        _pipeline_params(dst, checkpoint_backend="orbax")
    assert cli(["test", pd_, "valid", "all", "--device", "cpu"]) == 0
    jeval.run(JParams(os.path.join(jd, "params.json")), "valid", "all")
    for name in ("000.csv", "001.csv"):
        _assert_scores_close(_read_csv(os.path.join(pd_, "comparisons", "valid", name)),
                             _read_csv(os.path.join(jd, "comparisons", "valid", name)))
    assert cli(["select", pd_]) == 0
    files = ("checkpoint_scores.csv", "checkpoint_best.txt")
    ours = [open(os.path.join(pd_, f), "rb").read() for f in files]
    assert ours[1].split()[1] in (b"000.checkpoint", b"001.checkpoint")
    jselect.run(JParams(os.path.join(pd_, "params.json")))
    assert [open(os.path.join(pd_, f), "rb").read() for f in files] == ours
    capsys.readouterr()


def test_port_predict_export_and_resume_from_dp_checkpoints(dp_trained, tmp_path, capsys):
    """``predict`` and ``export`` of ``001.checkpoint.orbax``, and one more
    epoch of the port's training from it, equal the same stages on
    ``scgrhc``'s pickle of that state bit for bit."""
    src, src_twin = dp_trained
    d, twin = str(tmp_path / "dp"), str(tmp_path / "twin")
    shutil.copytree(src, d)
    shutil.copytree(src_twin, twin)
    _pipeline_params(d, checkpoint_backend="orbax")
    _pipeline_params(twin)
    for exp in (d, twin):
        assert cli(["predict", exp, "SYN000", "001.checkpoint", "--device", "cpu"]) == 0
        assert cli(["export", exp, "001.checkpoint", os.path.join(exp, "001.torch")]) == 0
    a, b = (np.load(os.path.join(exp, "predictions", "SYN000.npy")) for exp in (d, twin))
    assert a.dtype == np.float32 and a.size and a.shape == b.shape and np.array_equal(a, b)
    got, want = (torch.load(os.path.join(exp, "001.torch"), weights_only=False)
                 for exp in (d, twin))
    assert list(got) == list(want)
    for k in ("g_state_dict", "d_state_dict"):
        assert all(torch.equal(got[k][n], v) for n, v in want[k].items())
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        assert got[k]["param_groups"] == want[k]["param_groups"]
        for i, s in want[k]["state"].items():
            assert got[k]["state"][i]["step"] == s["step"]
            assert torch.equal(got[k]["state"][i]["exp_avg_sq"], s["exp_avg_sq"])
    _pipeline_params(d, total_epochs=3, checkpoint_backend="orbax")
    _pipeline_params(twin, total_epochs=3)
    for exp in (d, twin):
        assert cli(["train", exp, "--device", "cpu"]) == 0
    names = sorted(os.listdir(os.path.join(d, "checkpoints")))
    assert names == [f"{e:03d}.checkpoint.orbax" for e in range(3)]
    got = ckpt_io.load(os.path.join(d, "checkpoints", "002.checkpoint.orbax"))
    want = ckpt_io.load(os.path.join(twin, "checkpoints", "002.checkpoint"))
    assert got["epoch"] == want["epoch"] == 2 and got["g_losses"] == want["g_losses"]
    _assert_same_leaves(got, want)
    capsys.readouterr()


# ---- (c) tensorstore's grids, (d) refusals -----------------------------------------------

def _array(shape, dtype, seed=0):
    rng = np.random.default_rng(seed)
    if np.dtype(dtype).kind == "i":
        return rng.integers(-2**31, 2**31 - 1, shape, dtype=np.int32)
    return rng.standard_normal(shape).astype(np.float32)


def _ts_zarr(root, name, shape, chunks, dtype):
    return ts.open({"driver": "zarr",
                    "kvstore": {"driver": "ocdbt", "base": f"file://{root}", "path": f"{name}/"},
                    "metadata": {"shape": shape, "chunks": chunks, "dtype": dtype,
                                 "compressor": {"id": "zstd", "level": 1}, "fill_value": None}},
                   create=True, open=True).result()


@pytest.mark.parametrize("shape,chunks", [([37, 5, 3], [16, 2, 3]), ([7], [3]), ([], []),
                                          ([1, 512, 3], [1, 128, 3])])
@pytest.mark.parametrize("dtype", ["<f4", "<i4"])
def test_tensorstore_grids_both_ways(tmp_path, shape, chunks, dtype):
    """tensorstore writes a grid whose chunks do not divide the shape and
    the port reads it bit for bit; the port's grid of the same array
    reads back in tensorstore, chunk for chunk the same bytes."""
    a = _array(shape, dtype)
    _ts_zarr(str(tmp_path / "ts"), "g_params.w", shape, chunks, dtype).write(a).result()
    theirs = ocdbt.read(str(tmp_path / "ts"))
    got = zarr2.decode("g_params.w", theirs)
    assert got.dtype == a.dtype and got.shape == a.shape and got.tobytes() == a.tobytes()
    ours = zarr2.encode("g_params.w", a, chunks)
    assert sorted(ours) == sorted(theirs)
    for k in ours:
        if not k.endswith(b"/.zarray"):
            assert zstd.decompress(ours[k]) == zstd.decompress(theirs[k]), k
    ocdbt.write(str(tmp_path / "port"), ours)
    back = _ts_zarr(str(tmp_path / "port"), "g_params.w", shape, chunks, dtype).read().result()
    assert back.tobytes() == a.tobytes()


def test_one_chunk_encoding_is_unchanged():
    """``chunks`` equal to the shape, or left out, is the one-chunk array."""
    a = _array([64, 4, 3], "<f4")
    one = zarr2.encode("g_params.w", a)
    assert sorted(one) == [b"g_params.w/.zarray", b"g_params.w/0.0.0"]
    assert zarr2.encode("g_params.w", a, [64, 4, 3]) == one
    assert zarr2.decode("g_params.w", one).tobytes() == a.tobytes()
    assert sorted(zarr2.encode("count", np.int32(3))) == [b"count/.zarray", b"count/0"]


def _damaged(kind):
    store = zarr2.encode("d_opt.0.mu.conv1.w", _array([37, 5, 3], "<f4"), [16, 2, 3])
    meta_key = b"d_opt.0.mu.conv1.w/.zarray"
    meta = json.loads(store[meta_key])
    if kind == "missing":
        del store[b"d_opt.0.mu.conv1.w/2.1.0"]
    elif kind == "short":
        store[b"d_opt.0.mu.conv1.w/1.0.0"] = zstd.compress(b"\0" * (16 * 2 * 3 * 4 - 4))
    elif kind == "missing_with_fill":
        del store[b"d_opt.0.mu.conv1.w/0.0.0"]
        meta["fill_value"] = 0.0
    elif kind == "separator":
        meta["dimension_separator"] = "/"
    elif kind == "zero_chunk":
        meta["chunks"] = [16, 0, 3]
    elif kind == "rank":
        meta["chunks"] = [16, 2]
    store[meta_key] = json.dumps(meta).encode()
    return store


@pytest.mark.parametrize("kind,error,match", [
    ("missing", KeyError, "chunk d_opt.0.mu.conv1.w/2.1.0 is missing"),
    ("short", ValueError, "chunk d_opt.0.mu.conv1.w/1.0.0 holds 380 bytes"),
    ("missing_with_fill", ValueError, "chunk d_opt.0.mu.conv1.w/0.0.0 is missing; filling"),
    ("separator", ValueError, "dimension_separator '/'"),
    ("zero_chunk", ValueError, r"chunks \[16, 0, 3\] do not fit"),
    ("rank", ValueError, r"chunks \[16, 2\] do not fit"),
])
def test_damaged_grid_raises_naming_the_array(kind, error, match):
    with pytest.raises(error, match="d_opt.0.mu.conv1.w: ") as e:
        zarr2.decode("d_opt.0.mu.conv1.w", _damaged(kind))
    assert e.match(match)


# ---- (e) a grid written by the port, restored by Orbax -----------------------------------

def test_split_copy_is_what_orbax_writes_on_four_devices(tmp_path, jax_state):
    """``chip_smoke.py``'s split copy of ``scgrhc``'s one-device save holds
    the keys, ``.zarray`` files, array metadata and chunk contents of
    ``scgrhc``'s save of the same state replicated over 4 devices."""
    meta = dict(start_time=1.5, epoch=3, g_losses=[1.0], d_losses=[2.0])
    one, four = str(tmp_path / "one" / "003.checkpoint"), str(tmp_path / "four" / "003.checkpoint")
    jorbax.save(one, state=jax_state, **meta)
    jorbax.save(four, state=replicate(make_mesh(4), jax_state), **meta)
    grid = str(tmp_path / "grid" / "003.checkpoint.orbax")
    assert _chip_smoke()._orbax_split_copy(one + ".orbax", grid, 4) == 177
    ours, theirs = ocdbt.read(grid), ocdbt.read(four + ".orbax")
    assert sorted(ours) == sorted(theirs) and len(ours) == N_ARRAYS + 725
    for k, v in theirs.items():
        if k.endswith(b"/.zarray"):
            assert ours[k] == v, k
        else:
            assert zstd.decompress(ours[k]) == zstd.decompress(v), k

    def doc(root):
        with open(os.path.join(root, "array_metadatas", "process_0")) as f:
            return json.load(f)

    assert doc(grid) == doc(four + ".orbax")


def test_port_grid_restores_in_orbax_bit_for_bit(tmp_path):
    """A port checkpoint re-encoded as the 4-replica grids
    (``chip_smoke.py``'s split copy): the port reads it as it read the
    one-chunk original, and Orbax restores it bit for bit."""
    st, cfg = _port_state()
    one = str(tmp_path / "007.checkpoint")
    orbax_io.save(one, start_time=2.5, epoch=7, g_losses=[0.5], d_losses=[0.25], state=st)
    grid = str(tmp_path / "grid" / "007.checkpoint.orbax")
    assert _chip_smoke()._orbax_split_copy(one + ".orbax", grid, 4) == 177
    assert len(_split(_zarrays(grid))) == 177
    want = _state_dict(st)
    _assert_same_leaves(ckpt_io.load(grid), want)
    _, back = orbax_io.load(grid, cfg, C, "cpu")
    _assert_same_leaves(_state_dict(back), want)
    _, theirs = jorbax.load(one, jwgan.TrainConfig(), C)
    meta, restored = jorbax.load(grid, jwgan.TrainConfig(), C)
    assert meta["epoch"] == 7
    for a, b in zip(jax.tree.leaves(theirs), jax.tree.leaves(restored)):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()


# ---- a save by two processes ---------------------------------------------------------------

_TWO_PROCESS_SAVE = textwrap.dedent("""
    import os, pickle, sys, types
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=2"
    import jax
    port, rank, tree, path = sys.argv[1], int(sys.argv[2]), sys.argv[3], sys.argv[4]
    jax.distributed.initialize(f"localhost:{port}", num_processes=2, process_id=rank)
    from scgrhc.parallel.mesh import make_mesh, replicate
    from scgrhc.train import orbax_io
    assert jax.device_count() == 4
    with open(tree, "rb") as f:
        state = types.SimpleNamespace(**replicate(make_mesh(), pickle.load(f)))
    orbax_io.save(path, start_time=0.5, epoch=1, g_losses=[], d_losses=[], state=state)
    jax.distributed.shutdown()
""")


def test_two_process_save_loads_bit_for_bit(tmp_path, jax_state):
    """Two ``jax.distributed`` processes of 2 CPU devices each save the
    state replicated over the 4: the store has ``ocdbt.process_1/``, and
    every leaf loads bit for bit."""
    tree = str(tmp_path / "state.pickle")
    with open(tree, "wb") as f:
        pickle.dump({k: jax.tree.map(np.asarray, getattr(jax_state, k))
                     for k in ("g_params", "d_params", "g_opt", "d_opt")}, f)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    path = str(tmp_path / "001.checkpoint")
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env.pop("XLA_FLAGS", None)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    procs = [subprocess.Popen([sys.executable, "-c", _TWO_PROCESS_SAVE, str(port), str(r), tree,
                               path], cwd=repo, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            p.kill()
    assert [p.returncode for p in procs] == [0, 0], "\n".join(o[-3000:] for o in outs)
    assert os.path.isdir(os.path.join(path + ".orbax", "ocdbt.process_1"))
    assert len(_split(_zarrays(path + ".orbax"))) >= 150
    _assert_same_leaves(ckpt_io.load(path + ".orbax"), _want_dict(jax_state))
