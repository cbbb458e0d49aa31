"""The port's Orbax checkpoints (``scgrhc_torch.train.orbax_io``) against
``scgrhc.train.orbax_io``, which is real Orbax, and its layers against the
libraries they stand in for.

  * zstd (``native/zstd``) against ``zstandard``: frames with and without a
    content size, multi-block frames, an empty frame, concatenated frames;
    corrupt frames raise.
  * OCDBT (``train/ocdbt``) against tensorstore's own ocdbt kvstore, both ways,
    with inline and out-of-line values (tensorstore's stores with interior
    nodes, the port's with one leaf); a flipped byte raises on its CRC-32C.
  * Whole checkpoints at full width (4 SCG channels, ``TrainConfig()``):
    one written by ``scgrhc`` in one process from an unreplicated state
    (Orbax's ``ocdbt.process_0/`` store, one chunk an array) loads into the
    port bit for bit, and one written by the port restores in Orbax bit
    for bit, with the same ``_METADATA`` and ``.zarray`` files.  States
    replicated over several devices, whose arrays Orbax splits into chunk
    grids, are tests/test_torch_orbax_dp.py's.
  * A counterpart of each of tests/test_orbax.py's cases, and
    ``python -m scgrhc_torch <dir> --device cpu`` with
    ``checkpoint_backend: "orbax"`` against the same run with the pickle
    backend: equal checkpoints, CSVs and choices, resume, predict, export.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.core import paths as jpaths
from scgrhc.core.params import Params as JParams
from scgrhc.eval import run as jeval
from scgrhc.train import orbax_io as jorbax
from scgrhc.train import wgan as jwgan
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.models import convert
from scgrhc_torch.native import zstd
from scgrhc_torch.select import run as select_run
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import ocdbt, orbax_io, wgan
from scgrhc_torch.train import run as train_run

ocp = pytest.importorskip("orbax.checkpoint")
ts = pytest.importorskip("tensorstore")
zstandard = pytest.importorskip("zstandard")

C = 4  # full width: 4 SCG channels
ENVELOPE = 1e-3  # the port's f32 forward against scgrhc's (tests/test_torch_eval.py)


# ---- zstd --------------------------------------------------------------------------

def _payload(kind: str) -> bytes:
    rng = np.random.default_rng(0)
    if kind == "empty":
        return b""
    if kind == "small":
        return b"scgrhc" * 7
    # > 128 KiB: more than one zstd block
    return rng.standard_normal(200_000).astype(np.float32).tobytes()


@pytest.mark.parametrize("kind", ["empty", "small", "multiblock"])
@pytest.mark.parametrize("content_size", [True, False])
def test_zstd_decompress_matches_zstandard(kind, content_size):
    data = _payload(kind)
    frame = zstandard.ZstdCompressor(level=1, write_content_size=content_size).compress(data)
    assert zstd.decompress(frame) == data
    assert zstd.decompress(frame, size_hint=3) == data  # a hint too small streams on
    co = zstandard.ZstdCompressor(level=1).compressobj()  # streamed: no content size
    assert zstd.decompress(co.compress(data) + co.flush()) == data


@pytest.mark.parametrize("content_size", [True, False])
def test_zstd_decompress_concatenated_frames(content_size):
    a, b = _payload("multiblock"), _payload("small")
    co = zstandard.ZstdCompressor(level=1, write_content_size=content_size)
    assert zstd.decompress(co.compress(a) + co.compress(b)) == a + b
    assert zstd.decompress(co.compress(b) + zstd.compress(a)) == b + a  # sizes known and not


@pytest.mark.parametrize("level", [1, 3])
def test_zstd_compress_reads_in_zstandard(level):
    data = _payload("multiblock")
    frame = zstd.compress(data, level)
    assert zstandard.ZstdDecompressor().decompress(frame) == data
    assert zstandard.get_frame_parameters(frame).content_size == len(data)
    assert zstd.version().count(".") == 2


@pytest.mark.parametrize("damage", ["magic", "truncated", "checksum"])
def test_zstd_corrupt_frame_raises(damage):
    data = _payload("multiblock")
    frame = bytearray(zstandard.ZstdCompressor(level=1, write_checksum=True,
                                               write_content_size=False).compress(data))
    if damage == "magic":
        frame[0] ^= 0xFF
    elif damage == "truncated":
        frame = frame[:len(frame) // 2]
    else:
        frame[-1] ^= 0xFF
    with pytest.raises(ValueError, match="zstd decompression failed"):
        zstd.decompress(bytes(frame))


def test_zstd_without_the_library_raises_naming_it(monkeypatch, tmp_path):
    """No fallback: without libzstd the first Orbax write or read raises."""
    ocdbt.write(str(tmp_path / "store"), {b"k": b"v" * 2000})
    monkeypatch.setattr(zstd, "_lib", None)
    monkeypatch.setattr(zstd, "LIBRARY", "libzstd-absent.so.9")
    monkeypatch.setattr(zstd.ctypes.util, "find_library", lambda name: None)
    with pytest.raises(RuntimeError, match="libzstd-absent.so.9 not found"):
        ocdbt.write(str(tmp_path / "other"), {b"k": b"v"})
    with pytest.raises(RuntimeError, match="libzstd-absent.so.9 not found"):
        ocdbt.read(str(tmp_path / "store"))


# ---- OCDBT -------------------------------------------------------------------------

def _items(n=2000, seed=0) -> dict:
    """Keys sharing prefixes of several lengths; values of 0..3000 bytes."""
    rng = np.random.default_rng(seed)
    return {b"g_opt.%d/%s%05d" % (i % 5, b"w" * (i % 7), i): rng.bytes(int(rng.integers(0, 3000)))
            for i in range(n)}


def _ts_store(root, config=None):
    spec = {"driver": "ocdbt", "base": f"file://{root}"}
    if config:
        spec["config"] = config
    return ts.KvStore.open(spec).result()


def _ts_read(root) -> dict:
    kv = _ts_store(root)
    return {k: kv.read(k).result().value for k in kv.list().result()}


def _root_height(root) -> int:
    with open(os.path.join(root, "manifest.ocdbt"), "rb") as f:
        r = ocdbt._unframe(f.read(), ocdbt.MANIFEST_MAGIC, "manifest")
    ocdbt._read_config(r)
    ocdbt._read_table(r, "")
    n = r.varint()
    r.varints(n)
    return [r.byte() for _ in range(n)][-1]


@pytest.mark.parametrize("compression", [None, {"id": "zstd", "level": 1}])
def test_ocdbt_reads_what_tensorstore_wrote(tmp_path, compression):
    items = _items()
    kv = _ts_store(str(tmp_path), {"max_decoded_node_bytes": 2000, "max_inline_value_bytes": 100,
                                   "compression": compression})
    txn = ts.Transaction()
    for k, v in items.items():
        kv.with_transaction(txn).write(k, v).result()
    txn.commit_async().result()
    kv.write(b"g_opt.1/late", b"x" * 500).result()  # a second version
    items[b"g_opt.1/late"] = b"x" * 500
    assert _root_height(str(tmp_path)) >= 2
    assert ocdbt.read(str(tmp_path)) == items


def _item_set(kind: str) -> dict:
    items = _items()
    if kind == "inline":
        return {k: v[:ocdbt.MAX_INLINE_VALUE_BYTES] for k, v in items.items()}
    if kind == "indirect":
        return {k: v + b"\0" * (ocdbt.MAX_INLINE_VALUE_BYTES + 1) for k, v in items.items()}
    return items


@pytest.mark.parametrize("kind", ["mixed", "inline", "indirect"])
def test_tensorstore_reads_what_ocdbt_wrote(tmp_path, kind):
    items = _item_set(kind)
    ocdbt.write(str(tmp_path), items)
    assert _root_height(str(tmp_path)) == 0  # one leaf, the root
    assert _ts_read(str(tmp_path)) == items
    assert ocdbt.read(str(tmp_path)) == items
    assert len(os.listdir(tmp_path / "d")) == 1  # one data file


def test_ocdbt_write_past_the_node_limit_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(ocdbt, "MAX_DECODED_NODE_BYTES", 2000)
    with pytest.raises(ValueError, match="past the 2000-byte node limit"):
        ocdbt.write(str(tmp_path), _items(50))


def test_ocdbt_empty_store_both_ways(tmp_path):
    ocdbt.write(str(tmp_path), {})
    assert _ts_read(str(tmp_path)) == {} and ocdbt.read(str(tmp_path)) == {}


@pytest.mark.parametrize("where", ["manifest", "node"])
def test_ocdbt_flipped_byte_raises_on_its_crc(tmp_path, where):
    ocdbt.write(str(tmp_path), _items(50))
    if where == "manifest":
        path = tmp_path / "manifest.ocdbt"
        at = 20
    else:
        (name,) = os.listdir(tmp_path / "d")
        path = tmp_path / "d" / name
        at = -10  # inside the root node, the file's last
    buf = bytearray(path.read_bytes())
    buf[at] ^= 0x01
    path.write_bytes(bytes(buf))
    with pytest.raises(ValueError, match="CRC-32C mismatch"):
        ocdbt.read(str(tmp_path))


# ---- whole checkpoints at full width ----------------------------------------------------

def _jax_state_with_moments(c: int, seed: int = 0):
    """A JAX TrainState whose Adam state has count 3 and random moments
    (device arrays, as in training)."""
    cfg = jwgan.TrainConfig()
    st = jwgan.init_state(jax.random.key(seed), c, cfg)
    rng = np.random.default_rng(seed)

    def moments(opt_state, params):
        mu = jax.tree.map(lambda a: jnp.asarray(rng.standard_normal(a.shape), jnp.float32),
                          params)
        nu = jax.tree.map(lambda a: jnp.asarray(rng.random(a.shape), jnp.float32), params)
        return (opt_state[0]._replace(count=jnp.int32(3), mu=mu, nu=nu),) + tuple(opt_state[1:])

    return st._replace(g_opt=moments(st.g_opt, st.g_params),
                       d_opt=moments(st.d_opt, st.d_params)), cfg


@pytest.fixture(scope="module")
def jax_written(tmp_path_factory):
    """A full-width state with moments, and its checkpoint written by
    ``scgrhc.train.orbax_io.save``."""
    st, cfg = _jax_state_with_moments(C)
    path = str(tmp_path_factory.mktemp("jaxorbax") / "003.checkpoint")
    jorbax.save(path, start_time=1.5, epoch=3, g_losses=[1.0, 2.0], d_losses=[3.0, 4.0, 5.0],
                state=st)
    return st, path + ".orbax"


def _want_dict(st) -> dict:
    """The state's leaves carried across by ``models/convert``."""
    def adam(opt, kind):
        a = opt[0]
        return convert.adam_state_from_jax(int(a.count), *(jax.tree.map(np.asarray, t)
                                                           for t in (a.mu, a.nu)), kind)
    return {
        "g_state_dict": convert.state_dict_from_jax_params(jax.tree.map(np.asarray, st.g_params)),
        "d_state_dict": convert.critic_state_dict_from_jax_params(
            jax.tree.map(np.asarray, st.d_params)),
        "g_optimizer_state_dict": {"state": adam(st.g_opt, "generator")},
        "d_optimizer_state_dict": {"state": adam(st.d_opt, "critic")},
    }


def _assert_same_leaves(got: dict, want: dict):
    for k in ("g_state_dict", "d_state_dict"):
        assert list(got[k]) == list(want[k])
        for p, v in want[k].items():
            g = np.asarray(got[k][p])
            assert g.dtype == v.dtype and g.shape == v.shape, p
            assert g.tobytes() == v.tobytes(), p
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        gs, ws = got[k]["state"], want[k]["state"]
        assert gs.keys() == ws.keys()
        for i, s in ws.items():
            assert gs[i]["step"] == s["step"]
            for m in ("exp_avg", "exp_avg_sq"):
                assert np.asarray(gs[i][m]).tobytes() == s[m].tobytes(), (k, i, m)


def _port_state(seed: int = 5, steps: int = 1):
    cfg = wgan.TrainConfig(n_critic=1)
    st = wgan.init_state(seed, C, cfg, "cpu")
    g = torch.Generator().manual_seed(seed)
    for _ in range(steps):
        wgan.train_step(st, torch.rand(2, C, 32, generator=g), torch.rand(2, 1, 32, generator=g),
                        torch.Generator().manual_seed(1), cfg)
    return st, cfg


def _state_dict(st) -> dict:
    """A port TrainState as the checkpoint dict ``checkpoint.save`` writes."""
    def adam(opt):
        return {i: {"step": int(s["step"]), "exp_avg": s["exp_avg"].numpy(),
                    "exp_avg_sq": s["exp_avg_sq"].numpy()}
                for i, s in opt.state_dict()["state"].items()}
    return {"g_state_dict": {k: v.numpy() for k, v in st.generator.state_dict().items()},
            "d_state_dict": {k: v.numpy() for k, v in st.critic.state_dict().items()},
            "g_optimizer_state_dict": {"state": adam(st.g_opt)},
            "d_optimizer_state_dict": {"state": adam(st.d_opt)}}


def test_jax_written_checkpoint_loads_in_port_bit_for_bit(jax_written):
    """(a) ``scgrhc``'s Orbax checkpoint (one process, one chunk an array) →
    the port: every leaf as ``models/convert`` carries it across, and meta.json."""
    st, path = jax_written
    assert os.path.isdir(os.path.join(path, "ocdbt.process_0"))
    ckpt, port = orbax_io.load(path, wgan.TrainConfig(), C, "cpu")
    assert (ckpt["start_time"], ckpt["epoch"]) == (1.5, 3)
    assert ckpt["g_losses"] == [1.0, 2.0] and ckpt["d_losses"] == [3.0, 4.0, 5.0]
    want = _want_dict(st)
    _assert_same_leaves(ckpt, want)
    _assert_same_leaves(_state_dict(port), want)
    assert ckpt["g_optimizer_state_dict"]["param_groups"][0]["betas"] == (0.5, 0.999)
    # what every stage reads: checkpoint.load of the directory
    _assert_same_leaves(ckpt_io.load(path), want)


def _port_written(tmp_path, st, name="007.checkpoint"):
    path = str(tmp_path / name)
    orbax_io.save(path, start_time=2.5, epoch=7, g_losses=[0.5], d_losses=[0.25, 0.75], state=st)
    return path


def test_port_written_checkpoint_restores_in_orbax_bit_for_bit(tmp_path, jax_written):
    """(b) The port's Orbax directory → ``scgrhc.train.orbax_io.load``:
    every array equal bit for bit, and Orbax's metadata lists the tree it
    lists for ``scgrhc``'s own checkpoint."""
    st, jpath = jax_written
    port, _ = orbax_io.load(jpath, wgan.TrainConfig(), C, "cpu")
    port_state = ckpt_io.restore(port, wgan.TrainConfig(), C, "cpu")
    path = _port_written(tmp_path, port_state)
    meta, back = jorbax.load(path, jwgan.TrainConfig(), C)
    assert meta == {"start_time": 2.5, "epoch": 7, "g_losses": [0.5], "d_losses": [0.25, 0.75]}
    for a, b in zip(jax.tree.leaves((st.g_params, st.d_params, st.g_opt, st.d_opt)),
                    jax.tree.leaves((back.g_params, back.d_params, back.g_opt, back.d_opt))):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape and a.tobytes() == b.tobytes()
    ours = ocp.StandardCheckpointer().metadata(path + ".orbax")
    theirs = ocp.StandardCheckpointer().metadata(jpath)
    tree = lambda m: getattr(m, "item_metadata", m)  # noqa: E731
    assert jax.tree.structure(tree(ours)) == jax.tree.structure(tree(theirs))
    shapes = lambda m: [(x.shape, x.dtype) for x in jax.tree.leaves(tree(m))]  # noqa: E731
    assert shapes(ours) == shapes(theirs)


def test_metadata_and_zarrays_match_jax(tmp_path, jax_written):
    """(c) ``_METADATA``, ``array_metadatas/process_0`` and every
    ``.zarray`` are the same whichever package wrote them;
    ``_CHECKPOINT_METADATA`` has the same keys and item handler."""
    st, jpath = jax_written
    port, _ = orbax_io.load(jpath, wgan.TrainConfig(), C, "cpu")
    path = _port_written(tmp_path, ckpt_io.restore(port, wgan.TrainConfig(), C, "cpu")) + ".orbax"

    def doc(root, rel):
        with open(os.path.join(root, rel)) as f:
            return json.load(f)

    for rel in ("_METADATA", "array_metadatas/process_0"):
        assert json.dumps(doc(path, rel)) == json.dumps(doc(jpath, rel)), rel
    ours, theirs = doc(path, "_CHECKPOINT_METADATA"), doc(jpath, "_CHECKPOINT_METADATA")
    assert list(ours) == list(theirs) and ours["item_handlers"] == theirs["item_handlers"]
    a, b = ocdbt.read(path), ocdbt.read(jpath)
    assert sorted(a) == sorted(b) and len(a) == 2 * 194
    for k in a:
        if k.endswith(b"/.zarray"):
            assert a[k] == b[k], k


# ---- counterparts of tests/test_orbax.py -------------------------------------------------

@pytest.fixture(scope="module")
def port_state():
    return _port_state()


def test_orbax_roundtrip(tmp_path, port_state):
    st, cfg = port_state
    path = str(tmp_path / "007.checkpoint")
    orbax_io.save(path, start_time=9.0, epoch=7, g_losses=[1.0, 2.0], d_losses=[3.0], state=st)
    assert orbax_io.is_orbax_checkpoint(path + ".orbax")
    assert not os.path.exists(path)
    ckpt, back = orbax_io.load(path, cfg, C, "cpu")
    assert ckpt["epoch"] == 7 and ckpt["g_losses"] == [1.0, 2.0]
    want = _state_dict(st)
    _assert_same_leaves(_state_dict(back), want)
    _assert_same_leaves(ckpt, want)


def test_orbax_async_save_then_wait(tmp_path, port_state):
    """block=False returns before the directory lands; wait() makes it
    durable and loadable, and no temp dir is left."""
    st, cfg = port_state
    path = str(tmp_path / "002.checkpoint")
    orbax_io.save(path, start_time=1.0, epoch=2, g_losses=[9.0], d_losses=[], state=st,
                  block=False)
    orbax_io.wait()
    assert os.listdir(tmp_path) == ["002.checkpoint.orbax"]
    ckpt, back = orbax_io.load(path, cfg, C, "cpu")
    assert ckpt["epoch"] == 2 and ckpt["g_losses"] == [9.0] and ckpt["d_losses"] == []
    _assert_same_leaves(_state_dict(back), _state_dict(st))


def test_orbax_async_save_error_surfaces_in_wait(tmp_path, port_state, monkeypatch):
    st, _ = port_state

    def full(*a, **k):
        raise OSError("disk full")

    monkeypatch.setattr(ocdbt, "write", full)
    orbax_io.save(str(tmp_path / "000.checkpoint"), start_time=0.0, epoch=0, g_losses=[],
                  d_losses=[], state=st, block=False)
    with pytest.raises(OSError, match="disk full"):
        orbax_io.wait()
    assert os.listdir(tmp_path) == []  # the temp dir is removed, nothing half-written


def test_orbax_save_overwrites_an_existing_checkpoint(tmp_path, port_state):
    st, cfg = port_state
    path = str(tmp_path / "001.checkpoint")
    orbax_io.save(path, start_time=0.0, epoch=0, g_losses=[], d_losses=[], state=st)
    orbax_io.save(path, start_time=0.0, epoch=1, g_losses=[2.0], d_losses=[], state=st)
    assert orbax_io.load(path, cfg, C, "cpu")[0]["epoch"] == 1
    assert len(os.listdir(os.path.join(path + ".orbax", "d"))) == 1


def test_orbax_to_reference_equals_the_pickle_of_its_state(tmp_path, port_state):
    st, cfg = port_state
    path = str(tmp_path / "001.checkpoint")
    orbax_io.save(path, start_time=0.5, epoch=1, g_losses=[1.0], d_losses=[2.0], state=st)
    orbax_io.to_reference(path, str(tmp_path / "ref.checkpoint"), cfg, C)
    ckpt_io.save(str(tmp_path / "want.checkpoint"), start_time=0.5, epoch=1, g_losses=[1.0],
                 d_losses=[2.0], state=st, cfg=cfg)
    got, want = (ckpt_io.load(str(tmp_path / n)) for n in ("ref.checkpoint", "want.checkpoint"))
    assert list(got) == list(want)
    for k in ("format", "start_time", "epoch", "g_losses", "d_losses"):
        assert got[k] == want[k]
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        assert got[k]["param_groups"] == want[k]["param_groups"]
    _assert_same_leaves(got, want)
    with pytest.raises(ValueError, match="channels"):
        orbax_io.to_reference(path, str(tmp_path / "bad.checkpoint"), cfg, C + 1)


def _train_experiment(tmp_path, name, **extra):
    """A one-channel training experiment at T = 16 (tests/test_torch_train.py's size)."""
    from scgrhc_torch.data.loaders import SegmentLoader
    from scgrhc_torch.data.store import SegmentStore

    exp = str(tmp_path / name)
    os.makedirs(exp, exist_ok=True)
    rng = np.random.default_rng(2)
    scg = rng.standard_normal((5, 16, 1)).astype(np.float32)
    rhc = rng.standard_normal((5, 16, 1)).astype(np.float32)
    SegmentLoader(SegmentStore.from_windows(scg, rhc, "SYN000", np.arange(5) * 16), 2,
                  seed=3).save(os.path.join(exp, "loader_train.pickle"))
    cfg = {
        "dir_path": exp, "in_channels": ["patch_ACC_lat"], "chamber": "PA",
        "segment_size": 16 / 500, "batch_size": 2, "train_path": "loader_train.pickle",
        "valid_path": "v.pickle", "test_path": "t.pickle", "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "c", "pred_top_dir_path": "p", "pred_rand_dir_path": "r",
        "alpha": 1e-4, "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10,
        "lambda_aux": 100, "total_epochs": 2, "min_RHC": -50, "use_global_min_max": False,
        "seed": 7, **extra,
    }
    with open(os.path.join(exp, "params.json"), "w") as f:
        json.dump(cfg, f)
    return Params(os.path.join(exp, "params.json"))


def test_training_saves_orbax_and_resumes_from_the_latest_of_either_backend(tmp_path):
    """Training with the Orbax backend writes ``NNN.checkpoint.orbax``
    dirs equal to the pickle backend's checkpoints; a resume picks the
    latest epoch whichever backend wrote it and continues bit for bit."""
    ref = _train_experiment(tmp_path, "ref", total_epochs=3)
    train_run.run(ref, device="cpu", plot=False)
    orb = _train_experiment(tmp_path, "orb", total_epochs=2, checkpoint_backend="orbax")
    train_run.run(orb, device="cpu", plot=False)
    assert sorted(os.listdir(orb.checkpoint_dir_path)) == ["000.checkpoint.orbax",
                                                           "001.checkpoint.orbax"]
    for e in (0, 1):
        got = ckpt_io.load(os.path.join(orb.checkpoint_dir_path, f"{e:03d}.checkpoint.orbax"))
        want = ckpt_io.load(os.path.join(ref.checkpoint_dir_path, f"{e:03d}.checkpoint"))
        assert got["g_losses"] == want["g_losses"] and got["d_losses"] == want["d_losses"]
        _assert_same_leaves(got, want)
    # the reference backend resumes from epoch 1's Orbax dir
    orb = _train_experiment(tmp_path, "orb", total_epochs=3)
    assert ckpt_io.get_last_checkpoint_path(orb.checkpoint_dir_path) == "001.checkpoint.orbax"
    assert [e["epoch"] for e in train_run.run(orb, device="cpu", plot=False)["epochs"]] == [2]
    got = ckpt_io.load(os.path.join(orb.checkpoint_dir_path, "002.checkpoint"))
    _assert_same_leaves(got, ckpt_io.load(os.path.join(ref.checkpoint_dir_path, "002.checkpoint")))
    # and the Orbax backend resumes from that pickle
    orb = _train_experiment(tmp_path, "orb", total_epochs=4, checkpoint_backend="orbax")
    assert ckpt_io.get_last_checkpoint_path(orb.checkpoint_dir_path) == "002.checkpoint"
    train_run.run(orb, device="cpu", plot=False)
    ref = _train_experiment(tmp_path, "ref", total_epochs=4)
    train_run.run(ref, device="cpu", plot=False)
    _assert_same_leaves(ckpt_io.load(os.path.join(orb.checkpoint_dir_path, "003.checkpoint.orbax")),
                        ckpt_io.load(os.path.join(ref.checkpoint_dir_path, "003.checkpoint")))


def test_resume_prefers_latest_either_backend(tmp_path, port_state):
    st, cfg = port_state
    d = tmp_path / "ckpts"
    d.mkdir()
    for e in (0, 1):
        orbax_io.save(str(d / f"{e:03d}.checkpoint"), start_time=0.0, epoch=e, g_losses=[],
                      d_losses=[], state=st)
    last = ckpt_io.get_last_checkpoint_path(str(d))
    assert last == "001.checkpoint.orbax"
    assert orbax_io.load(str(d / last), cfg, C, "cpu")[0]["epoch"] == 1
    ckpt_io.save(str(d / "002.checkpoint"), start_time=0.0, epoch=2, g_losses=[], d_losses=[],
                 state=st, cfg=cfg)
    assert ckpt_io.get_last_checkpoint_path(str(d)) == "002.checkpoint"


def test_crash_window_falls_back_to_previous_epoch(tmp_path, port_state):
    """A directory without meta.json, an in-flight temp dir and a .torch
    side file are all skipped by resume."""
    st, cfg = port_state
    d = tmp_path / "ckpts"
    d.mkdir()
    for e in (0, 1):
        orbax_io.save(str(d / f"{e:03d}.checkpoint"), start_time=0.0, epoch=e, g_losses=[],
                      d_losses=[], state=st)
    os.remove(str(d / "001.checkpoint.orbax" / "meta.json"))
    os.makedirs(str(d / "002.checkpoint.orbax.orbax-checkpoint-tmp-42"))
    (d / "001.checkpoint.torch").write_bytes(b"not a checkpoint")
    last = ckpt_io.get_last_checkpoint_path(str(d))
    assert last == "000.checkpoint.orbax"
    assert orbax_io.load(str(d / last), cfg, C, "cpu")[0]["epoch"] == 0


def test_list_checkpoints_dedupes_and_filters(tmp_path, port_state):
    st, cfg = port_state
    d = tmp_path / "ckpts"
    d.mkdir()
    ckpt_io.save(str(d / "000.checkpoint"), start_time=0.0, epoch=0, g_losses=[], d_losses=[],
                 state=st, cfg=cfg)
    orbax_io.save(str(d / "000.checkpoint"), start_time=0.0, epoch=0, g_losses=[], d_losses=[],
                  state=st)
    orbax_io.save(str(d / "001.checkpoint"), start_time=0.0, epoch=1, g_losses=[], d_losses=[],
                  state=st)
    (d / "001.checkpoint.torch").write_bytes(b"x")
    orbax_io.save(str(d / "002.checkpoint"), start_time=0.0, epoch=2, g_losses=[], d_losses=[],
                  state=st)
    os.remove(str(d / "002.checkpoint.orbax" / "meta.json"))
    assert ckpt_io.list_checkpoints(str(d)) == ["000.checkpoint", "001.checkpoint.orbax"]


def test_export_cli_from_orbax(tmp_path, port_state, capsys):
    """``export <dir> NNN.checkpoint`` of an Orbax dir: the default name
    drops the suffix, and the file is the export of its state's pickle."""
    st, _ = port_state
    p = _train_experiment(tmp_path, "exp", in_channels=["a", "b", "c", "d"])
    cfg = wgan.TrainConfig.from_params(p)
    os.makedirs(p.checkpoint_dir_path)
    orbax_io.save(os.path.join(p.checkpoint_dir_path, "004.checkpoint"), start_time=0.0,
                  epoch=4, g_losses=[], d_losses=[], state=st)
    ckpt_io.save(str(tmp_path / "004.checkpoint"), start_time=0.0, epoch=4, g_losses=[],
                 d_losses=[], state=st, cfg=cfg)
    ckpt_io.export_torch(str(tmp_path / "004.checkpoint"), str(tmp_path / "want.torch"))
    assert cli(["export", p.dir_path, "004.checkpoint"]) == 0
    out = os.path.join(p.dir_path, "004.checkpoint.torch")
    assert f"-> {out}" in capsys.readouterr().out
    got, want = (torch.load(f, weights_only=False) for f in (out, str(tmp_path / "want.torch")))
    assert list(got) == list(want) and got["epoch"] == 4
    for k in ("g_state_dict", "d_state_dict"):
        for n, v in want[k].items():
            assert torch.equal(got[k][n], v), n
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        assert got[k]["param_groups"] == want[k]["param_groups"]
        for i, s in want[k]["state"].items():
            assert got[k]["state"][i]["step"] == s["step"]
            assert torch.equal(got[k]["state"][i]["exp_avg"], s["exp_avg"])
    assert os.listdir(p.checkpoint_dir_path) == ["004.checkpoint.orbax"]


# ---- the pipeline with the Orbax backend ------------------------------------------------

T = 32


def _pipeline_params(d, **extra) -> str:
    os.makedirs(d, exist_ok=True)
    cfg = {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"], "chamber": "PA",
        "segment_size": T / 500, "batch_size": 16, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 2, "min_RHC": -50, "use_global_min_max": False, "seed": 2,
        "eval_batch": 4, "data_backend": "device", **extra,
    }
    path = os.path.join(d, "params.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


@pytest.fixture(scope="module")
def pipelines(tmp_path_factory):
    """``python -m scgrhc_torch <dir> --device cpu`` on one synthetic 16-s
    record at T = 32 (tests/test_torch_eval.py's pipeline), once per
    backend, with the same seed."""
    from scgrhc_torch.utils.synth import make_synthetic_database

    root = tmp_path_factory.mktemp("orbaxpipe")
    db = make_synthetic_database(str(root / "db"), n_records=1, duration_s=16.0, seed=3)
    mp = pytest.MonkeyPatch()
    for mod in (tpaths, jpaths):
        mp.setattr(mod, "DATA_PATH", os.path.dirname(db))
        mp.setattr(mod, "PROCESSED_DATA_PATH", db)
    dirs = {}
    for backend in ("reference", "orbax"):
        d = str(root / backend)
        _pipeline_params(d, checkpoint_backend=backend)
        assert cli([d, "--device", "cpu"]) == 0
        dirs[backend] = d
    yield dirs
    mp.undo()


ARTIFACTS = ("checkpoint_scores.csv", "checkpoint_best.txt", "comparisons/valid/000.csv",
             "comparisons/valid/001.csv")


def test_pipeline_with_orbax_equals_the_reference_backend(pipelines):
    """(g) Equal checkpoints (every array, bit for bit), score CSVs,
    comparison CSVs and choice of the best checkpoint."""
    ref, orb = pipelines["reference"], pipelines["orbax"]
    assert sorted(os.listdir(os.path.join(orb, "checkpoints"))) == [
        "000.checkpoint.orbax", "001.checkpoint.orbax"]
    for e in (0, 1):
        got = ckpt_io.load(os.path.join(orb, "checkpoints", f"{e:03d}.checkpoint.orbax"))
        want = ckpt_io.load(os.path.join(ref, "checkpoints", f"{e:03d}.checkpoint"))
        assert got["g_losses"] == want["g_losses"] and got["d_losses"] == want["d_losses"]
        _assert_same_leaves(got, want)
    best = open(os.path.join(orb, "checkpoint_best.txt")).read().split()[1]
    for rel in ARTIFACTS + (f"comparisons/test/{best.split('.')[0]}.csv",):
        with open(os.path.join(orb, rel), "rb") as a, open(os.path.join(ref, rel), "rb") as b:
            assert a.read() == b.read(), rel


def test_pipeline_with_orbax_predicts_exports_and_resumes(pipelines, capsys):
    ref, orb = pipelines["reference"], pipelines["orbax"]
    for d in (ref, orb):
        assert cli(["predict", d, "SYN000", "best", "--device", "cpu"]) == 0
        assert cli(["export", d, "best"]) == 0
    a, b = (np.load(os.path.join(d, "predictions", "SYN000.npy")) for d in (orb, ref))
    assert a.dtype == np.float32 and a.shape == b.shape and np.array_equal(a, b)
    best = open(os.path.join(orb, "checkpoint_best.txt")).read().split()[1]
    got, want = (torch.load(os.path.join(d, best + ".torch"), weights_only=False)
                 for d in (orb, ref))
    assert list(got) == list(want)
    for k in ("g_state_dict", "d_state_dict"):
        assert all(torch.equal(got[k][n], v) for n, v in want[k].items())
    # one more epoch from the last .orbax dir, against the pickle backend's
    for d in (ref, orb):
        backend = "orbax" if d == orb else "reference"
        _pipeline_params(d, total_epochs=3, checkpoint_backend=backend)
        assert cli(["train", d, "--device", "cpu"]) == 0
    _assert_same_leaves(ckpt_io.load(os.path.join(orb, "checkpoints", "002.checkpoint.orbax")),
                        ckpt_io.load(os.path.join(ref, "checkpoints", "002.checkpoint")))
    capsys.readouterr()


def test_scgrhc_eval_scores_a_port_orbax_checkpoint(pipelines, tmp_path):
    """``scgrhc``'s eval reads one of the port's ``.orbax`` checkpoints
    through Orbax and scores it to the port's CSV, within the cross-package
    f32 envelope."""
    orb = pipelines["orbax"]
    jd = str(tmp_path / "jax")
    shutil.copytree(orb, jd, ignore=shutil.ignore_patterns("comparisons", "predictions"))
    for n in os.listdir(os.path.join(jd, "checkpoints")):
        if not n.startswith(("000", "001")):
            shutil.rmtree(os.path.join(jd, "checkpoints", n))
    jeval.run(JParams(_pipeline_params(jd, checkpoint_backend="orbax", total_epochs=2)),
              "valid", "001.checkpoint")

    def rows(path):
        import csv

        with open(path, newline="") as f:
            return {(r["filename"], int(r["start_idx"])): r for r in csv.DictReader(f)}

    got = rows(os.path.join(orb, "comparisons", "valid", "001.csv"))
    want = rows(os.path.join(jd, "comparisons", "valid", "001.csv"))
    assert got.keys() == want.keys() and got
    pw = np.stack([select_run.get_float_array(r["pred_rhc"]) for r in want.values()])
    pg = np.stack([select_run.get_float_array(got[k]["pred_rhc"]) for k in want])
    np.testing.assert_allclose(pg, pw, rtol=ENVELOPE, atol=ENVELOPE * np.abs(pw).max())
    for k, w in want.items():
        assert got[k]["real_rhc"] == w["real_rhc"]
