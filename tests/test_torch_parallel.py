"""The port's data axis (``scgrhc_torch.parallel``) against ``scgrhc``, in a
2-rank gloo world on the CPU.

One world of two processes (a ``file://`` store in ``tmp_path``, no TCP
port) runs every case and pickles what each rank saw; the tests below hold
it to ``scgrhc`` on the conftest's 8-device mesh and to the port at world
size 1 in this process:

  * the collectives, ``fetch_global`` and ``fetch_rows`` in rank order,
    ``row_block`` and ``pad_rows``, ``on_primary``'s
    failure on every rank, and ``"seed": null`` broadcast from rank 0 (and
    its loud failure when the environment names a world and no group is
    up);
  * one data-parallel WGAN-GP step at B = 8 and at B = 5 (padded to 6 with
    a masked row), f64, the dropout masks and the GP's eps pinned through
    the seams (``generator.dropout``, ``wgan._draw_eps``) at the global
    batch's shape: against ``scgrhc``'s DP step (B padded to 8) and the
    port's step at world size 1 at tests/test_torch_train.py's one-step
    tolerance, the two replicas equal bit for bit;
  * sharded evaluation of 11 windows in chunks of 8 (the last chunk of 3
    does not divide the world), f32 and int8, against world size 1 and
    ``scgrhc``'s ``predict_split`` with a sharding;
  * ``predict --mesh`` on a 40-s record (625 windows at T = 32, past one
    512-window chunk) against world size 1 and ``scgrhc``'s ``predict
    --mesh``; only rank 0 writes.
"""

import collections
import contextlib
import json
import os
import pickle
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.core import paths as jpaths
from scgrhc.core.params import Params as JParams
from scgrhc.data.store import SegmentStore as JSegmentStore
from scgrhc.eval import infer as jinfer
from scgrhc.models import generator as jgen
from scgrhc.parallel import mesh as jmesh
from scgrhc.parallel.dp import DataParallelTrainer as JDataParallelTrainer
from scgrhc.pipeline import predict as jpredict
from scgrhc.train import checkpoint as jckpt
from scgrhc.train import wgan as jwgan
from scgrhc_torch.core import paths as tpaths
from scgrhc_torch.core.params import Params
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.eval import infer
from scgrhc_torch.models import convert
from scgrhc_torch.models import generator as tgen
from scgrhc_torch.parallel import comm
from scgrhc_torch.parallel import mesh as tmesh
from scgrhc_torch.pipeline import predict as tpredict
from scgrhc_torch.train import wgan

ROOT = Path(__file__).resolve().parents[1]
T = 32
WORLD_TIMEOUT_S = 240
# tests/test_torch_train.py's one-step tolerance: f64, rtol 1e-9, except the
# biases that feed an instance norm (their gradient is rounding noise that
# Adam divides by |g| + 1e-8).
NOISE_ATOL = 1e-8
NORMED_BIASES = (
    {f"{b}.{i}.bias" for b in ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1")
     for i in (0, 3)}
    | {f"{a}.{s}.0.bias" for a in ("att3", "att2", "att1") for s in ("W_x", "W_g", "psi")}
    | {f"model.{i}.bias" for i in (2, 5, 8)}
)
DP_BATCHES = (8, 5)  # 5: padded to 6 at world size 2, to 8 on scgrhc's mesh
# sharded eval and predict at world size 2 against world size 1: f32
# summation order of the batched convs (tests/test_torch_eval.py's chunking
# tolerance); against scgrhc, f32 across the two frameworks
# (tests/test_torch_eval.py's ENVELOPE)
RTOL = 1e-5
JAX_RTOL = 1e-3
FWD_MIN_PCC = 0.95  # int8 against scgrhc's int8, tests/test_torch_quant.py
EVAL_BATCH = 8


def _mask(k: int, rows: int, shape) -> np.ndarray:
    """The k-th dropout mask of a step, for the real rows of the global batch."""
    return (np.random.default_rng(100 + k).random((rows, *shape[1:])) < 0.7).astype(np.float64)


def _eps(rows: int) -> np.ndarray:
    return np.random.default_rng(7).random((rows, 1, 1))


def _padded(a: np.ndarray, rows: int, fill: float = 1.0) -> np.ndarray:
    """a's rows padded with ``fill`` to ``rows``."""
    return np.concatenate([a, np.full((rows - a.shape[0], *a.shape[1:]), fill)])


WORKER = r"""
import os, pickle, sys
rank, io_dir = int(sys.argv[1]), sys.argv[2]
import numpy as np
import torch
torch.set_num_threads(1)
from scgrhc_torch.parallel import comm, mesh as tmesh
comm.init_distributed("file://" + os.path.join(io_dir, "store"), 2, rank, device="cpu",
                      timeout_s=60)
with open(os.path.join(io_dir, "inputs.pkl"), "rb") as f:
    inp = pickle.load(f)
writes = []
if rank:
    def audit(event, args):
        path = str(args[0]) if args else ""
        if not path.startswith(inp["exp"] + os.sep):
            return
        if event == "open" and (args[1] is None or any(c in args[1] for c in "wax+")):
            writes.append(path)
        elif event in ("os.rename", "os.replace", "os.remove"):
            writes.append(path)
    sys.addaudithook(audit)
out = {}

# the collectives
m = tmesh.make_mesh()
out["mesh"] = (m.size, m.rank)
x = torch.tensor([rank + 1.0, -3.0 * rank])
out["sum"] = comm.all_reduce_sum(x.clone()).tolist()
out["mean"] = comm.all_reduce_mean(x.clone()).tolist()
out["max"] = comm.all_reduce_max(x.clone()).tolist()
out["gather"] = comm.all_gather(torch.full((2, 3), float(rank))).tolist()
full = torch.arange(12.0).reshape(6, 2)
out["block"] = tmesh.place_global(full, m).tolist()
out["fetched"] = tmesh.fetch_global(tmesh.place_global(full, m), m).tolist()
out["bcast"] = comm.broadcast(torch.tensor([100 + rank])).tolist()
five = torch.arange(10.0).reshape(5, 2)
a, b, k = tmesh.row_block(m, 5)
block = tmesh.pad_rows(five[a:b], k, (-1.0, -2.0))
out["row_block"] = (a, b, k, block.tolist())
out["rows"] = [t.tolist() for t in tmesh.fetch_rows(m, 5, block, block[:, :1] * 10)]
out["primary"] = comm.on_primary("ok", lambda: "wrote")
def boom():
    raise OSError("disk full")
try:
    comm.on_primary("boom", boom)
except Exception as e:
    out["failed"] = f"{type(e).__name__}: {e}"
comm.barrier("cases")
from scgrhc_torch.core.params import Params
p = Params(inp["unseeded"])
out["unseeded"] = p.unseeded
out["seeds"] = comm.all_gather(torch.tensor([p.seed])).tolist()

# one DP step a batch size, draws pinned at the global batch's shape
from scgrhc_torch.models import convert
from scgrhc_torch.models import generator as tgen
from scgrhc_torch.parallel.dp import DataParallelTrainer
from scgrhc_torch.train import wgan
exec(inp["helpers"])
trainer = DataParallelTrainer(m)
seams = (tgen.dropout, wgan._draw_eps)
for b, case in inp["dp"].items():
    padded = -(-b // 2) * 2
    calls = [0]
    def dropout(x, rate, rng, train, b=b, padded=padded):
        k = calls[0]
        calls[0] += 1
        mask = _padded(_mask(k, b, x.shape), padded)
        return x * torch.from_numpy(mask[rank * x.shape[0]:(rank + 1) * x.shape[0]]) / (1 - rate)
    def draw_eps(rng, n, device, b=b, padded=padded):
        return torch.from_numpy(_padded(_eps(b), padded, 0.5)[rank * n:(rank + 1) * n])
    tgen.dropout, wgan._draw_eps = dropout, draw_eps
    cfg = wgan.TrainConfig(n_critic=1)
    g = convert.generator_from_jax_params(inp["g0"])
    d = convert.critic_from_jax_params(inp["d0"])
    st = trainer.place_state(wgan.TrainState(g, d, wgan.make_optimizer(g, cfg),
                                             wgan.make_optimizer(d, cfg)))
    d_loss, g_loss = trainer.step(st, torch.from_numpy(case["scg"]),
                                  torch.from_numpy(case["rhc"]), torch.arange(b), None, cfg)
    out[f"dp{b}"] = {"g": {k: v.detach().numpy() for k, v in g.state_dict().items()},
                     "d": {k: v.detach().numpy() for k, v in d.state_dict().items()},
                     "d_loss": d_loss.numpy(), "g_loss": float(g_loss), "calls": calls[0]}
tgen.dropout, wgan._draw_eps = seams

# sharded evaluation, f32 and int8
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.eval import infer
store = SegmentStore(**inp["store"])
gen = convert.generator_from_state_dict(inp["g_sd"]).eval()
for dtype in ("float32", "int8"):
    out["eval_" + dtype] = infer.predict_split(gen if dtype == "float32" else
                                               gen.cast(torch.int8), store,
                                               batch=inp["eval_batch"], mesh=m)

# predict --mesh through the CLI; rank 0 writes
from scgrhc_torch.core import paths
from scgrhc_torch.__main__ import main
paths.set_data_path(inp["data"])
out["predict_rc"] = main(["predict", inp["exp"], "SYN000", "last", "--mesh", "--device", "cpu"])
out["writes"] = writes
comm.barrier("end")
with open(os.path.join(io_dir, f"out{rank}.pkl"), "wb") as f:
    pickle.dump(out, f)
comm.destroy()
"""

HELPERS = "\n".join(
    __import__("inspect").getsource(f) for f in (_mask, _eps, _padded)
)


def run_world(io_dir: Path, script: str, n: int = 2, timeout: float = WORLD_TIMEOUT_S,
              args=()) -> list[subprocess.CompletedProcess]:
    """``script`` as n ranks (argv: rank, io_dir, *args), one thread each;
    each is killed when the world runs over ``timeout``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", script, str(r), str(io_dir), *args],
                              cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in range(n)]
    done = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            done.append(subprocess.CompletedProcess(p.args, p.returncode, out))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return done


@contextlib.contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _params(d, **extra) -> str:
    cfg = {
        "dir_path": str(d), "in_channels": ["patch_ACC_lat", "patch_ACC_hf"], "chamber": "PA",
        "segment_size": T / 500, "batch_size": 4, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_test.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 1, "min_RHC": -50, "use_global_min_max": False, "seed": 2, **extra,
    }
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "params.json")
    with open(path, "w") as f:
        json.dump(cfg, f)
    return path


def _store_arrays(n: int, c: int, seed: int) -> dict:
    rng = np.random.default_rng(seed)
    mm = np.stack([np.full(n, -10.0), np.full(n, 40.0)], axis=1)
    return dict(scg=rng.random((n, c, T)).astype(np.float32),
                rhc=rng.random((n, 1, T)).astype(np.float32),
                record_names=[f"rec{i}" for i in range(n)],
                start_idx=np.arange(n, dtype=np.int64), stop_idx=np.arange(n, dtype=np.int64) + T,
                minmax_scg=mm.copy(), minmax_rhc=mm.copy(), segment_samples=T)


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """The 2-rank world's outputs, with its inputs."""
    from scgrhc_torch.utils.synth import make_synthetic_database

    tmp = tmp_path_factory.mktemp("world2")
    init = jwgan.init_state(jax.random.key(0), 2, jwgan.TrainConfig(n_critic=1))
    g0 = jax.tree.map(lambda a: np.asarray(a, np.float64), init.g_params)
    d0 = jax.tree.map(lambda a: np.asarray(a, np.float64), init.d_params)
    rng = np.random.default_rng(1)
    dp = {b: {"scg": rng.random((b, 2, T)), "rhc": rng.random((b, 1, T))} for b in DP_BATCHES}
    db = make_synthetic_database(str(tmp / "db"), n_records=1, duration_s=40.0, seed=4)
    exp = tmp / "exp"
    _params(exp)
    os.makedirs(exp / "checkpoints")
    jckpt.save(str(exp / "checkpoints" / "000.checkpoint"), start_time=0.0, epoch=0,
               g_losses=[], d_losses=[], state=jwgan.init_state(jax.random.key(3), 2,
                                                                 jwgan.TrainConfig()))
    g_sd = {k: np.asarray(v, np.float32) for k, v in convert.state_dict_from_jax_params(
        jax.tree.map(np.asarray, jgen.init(jax.random.key(1), 2))).items()}
    inputs = {"unseeded": _params(tmp / "unseeded", seed=None), "g0": g0, "d0": d0, "dp": dp,
              "helpers": HELPERS, "store": _store_arrays(11, 2, 1), "eval_batch": EVAL_BATCH,
              "g_sd": g_sd,
              "data": os.path.dirname(db), "exp": str(exp)}
    with open(tmp / "inputs.pkl", "wb") as f:
        pickle.dump(inputs, f)
    procs = run_world(tmp, WORKER)
    for p in procs:
        assert p.returncode == 0, p.stdout[-4000:]
    outs = []
    for r in range(2):
        with open(tmp / f"out{r}.pkl", "rb") as f:
            outs.append(pickle.load(f))
    return {"inputs": inputs, "outs": outs, "log": procs[0].stdout, "tmp": tmp}


def test_collectives_and_single_writer(world):
    r0, r1 = world["outs"]
    assert "2 rank(s) over gloo (ranks on the CPU)" in world["log"]
    assert (r0["mesh"], r1["mesh"]) == ((2, 0), (2, 1))
    for r in (r0, r1):
        assert r["sum"] == [3.0, -3.0] and r["mean"] == [1.5, -1.5] and r["max"] == [2.0, 0.0]
        assert r["gather"] == [[0.0] * 3] * 2 + [[1.0] * 3] * 2  # rank order
        assert r["fetched"] == torch.arange(12.0).reshape(6, 2).tolist()
        assert r["bcast"] == [100]  # rank 0's
        assert r["rows"] == [torch.arange(10.0).reshape(5, 2).tolist(),
                             [[0.0], [20.0], [40.0], [60.0], [80.0]]]
    assert r0["block"] == [[0, 1], [2, 3], [4, 5]] and r1["block"] == [[6, 7], [8, 9], [10, 11]]
    assert r0["row_block"] == (0, 3, 3, [[0, 1], [2, 3], [4, 5]])
    assert r1["row_block"] == (3, 5, 3, [[6, 7], [8, 9], [-1, -2]])  # padded with the fill row
    assert r0["primary"] == "wrote" and r1["primary"] is None
    assert r0["failed"] == "OSError: disk full"
    assert r1["failed"] == "RuntimeError: boom: rank 0 failed: OSError: disk full"


def test_unseeded_params_broadcast_rank_zeros_seed(world, tmp_path, monkeypatch):
    """``"seed": null`` gives both ranks rank 0's draw; a launch whose
    environment names a world while no group is up raises (each process
    would draw its own)."""
    r0, r1 = world["outs"]
    assert r0["unseeded"] and r1["unseeded"]
    assert r0["seeds"] == r1["seeds"] and r0["seeds"][0] == r0["seeds"][1]
    path = _params(tmp_path / "x", seed=None)
    assert Params(path).unseeded  # one process: its own draw
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="init_distributed"):
        Params(path)
    assert Params(_params(tmp_path / "y")).seed == 2  # a seeded launch needs no group


def _jax_dp_step(g0, d0, case, b: int):
    """scgrhc's DataParallelTrainer step on the 8-device mesh, B padded to 8
    with masked rows, the draws pinned as in the world."""
    trainer = JDataParallelTrainer(n_devices=8)
    jcfg = jwgan.TrainConfig(n_critic=1)
    calls = collections.Counter()

    def jax_dropout(x, rate, rng=None, train=True):
        k = calls["k"]
        calls["k"] += 1
        return x * jnp.asarray(_padded(_mask(k, b, x.shape), x.shape[0])) / (1.0 - rate)

    real = (jgen.dropout, jwgan._draw_eps)
    jgen.dropout = jax_dropout
    jwgan._draw_eps = lambda key, n: jnp.asarray(_padded(_eps(b), n, 0.5))
    try:
        with enable_x64():
            opt = jwgan.make_optimizer(jcfg)
            gj, dj = jax.tree.map(jnp.asarray, g0), jax.tree.map(jnp.asarray, d0)
            state = trainer.place_state(jwgan.TrainState(gj, dj, opt.init(gj), opt.init(dj)))
            scg, rhc = (_padded(case[k], 8, 0.0) for k in ("scg", "rhc"))
            assert scg.shape[0] % trainer.n == 0
            scg, rhc = jmesh.shard_batch(trainer.mesh, jnp.asarray(scg), jnp.asarray(rhc))
            mask = None if b == 8 else jmesh.shard_batch(
                trainer.mesh, jnp.asarray(_padded(np.ones(b), 8, 0.0)))
            # a fresh jit, so that the seams are traced (train_step's cache may
            # hold a trace without them)
            step = jax.jit(jwgan._train_step_impl, static_argnames=("cfg",))
            s1, d_loss, g_loss = step(state, scg, rhc, jax.random.key(5), jcfg, mask)
            out = {"g": convert.state_dict_from_jax_params(jax.tree.map(np.asarray, s1.g_params)),
                   "d": convert.critic_state_dict_from_jax_params(
                       jax.tree.map(np.asarray, s1.d_params)),
                   "d_loss": np.asarray(d_loss), "g_loss": float(g_loss)}
    finally:
        jgen.dropout, jwgan._draw_eps = real
    assert calls["k"] == 12
    return out


def _port_step_world_one(g0, d0, case, b: int):
    calls = [0]

    def dropout(x, rate, rng, train):
        calls[0] += 1
        return x * torch.from_numpy(_mask(calls[0] - 1, b, x.shape)) / (1 - rate)

    real = (tgen.dropout, wgan._draw_eps)
    tgen.dropout = dropout
    wgan._draw_eps = lambda rng, n, device: torch.from_numpy(_eps(b))
    try:
        cfg = wgan.TrainConfig(n_critic=1)
        g, d = convert.generator_from_jax_params(g0), convert.critic_from_jax_params(d0)
        st = wgan.TrainState(g, d, wgan.make_optimizer(g, cfg), wgan.make_optimizer(d, cfg))
        d_loss, g_loss = wgan.train_step(st, torch.from_numpy(case["scg"]),
                                         torch.from_numpy(case["rhc"]), None, cfg)
    finally:
        tgen.dropout, wgan._draw_eps = real
    return {"g": {k: v.detach().numpy() for k, v in g.state_dict().items()},
            "d": {k: v.detach().numpy() for k, v in d.state_dict().items()},
            "d_loss": d_loss.numpy(), "g_loss": float(g_loss)}


def _assert_step_close(got, want):
    np.testing.assert_allclose(got["d_loss"], want["d_loss"], rtol=1e-9)
    np.testing.assert_allclose(got["g_loss"], want["g_loss"], rtol=1e-9)
    for model in ("g", "d"):
        for k, v in want[model].items():
            assert got[model][k].dtype == np.float64
            tol = dict(rtol=0, atol=NOISE_ATOL) if k in NORMED_BIASES else dict(rtol=1e-9)
            np.testing.assert_allclose(got[model][k], v, err_msg=k, **tol)


@pytest.mark.parametrize("b", DP_BATCHES)
def test_dp_step_matches_scgrhc_and_world_one(world, b):
    """One DP step at world size 2 (B = 5 padded and masked): the replicas
    equal bit for bit, and the step that of ``scgrhc``'s DP step and of the
    port at world size 1."""
    r0, r1 = (o[f"dp{b}"] for o in world["outs"])
    assert r0["calls"] == r1["calls"] == 12
    for model in ("g", "d"):
        for k, v in r0[model].items():
            np.testing.assert_array_equal(v, r1[model][k], err_msg=k)
    np.testing.assert_array_equal(r0["d_loss"], r1["d_loss"])
    assert r0["g_loss"] == r1["g_loss"]
    g0, d0, case = world["inputs"]["g0"], world["inputs"]["d0"], world["inputs"]["dp"][b]
    _assert_step_close(r0, _jax_dp_step(g0, d0, case, b))
    _assert_step_close(r0, _port_step_world_one(g0, d0, case, b))


@pytest.mark.parametrize("dtype", ["float32", "int8"])
def test_sharded_eval_matches_world_one_and_scgrhc(world, dtype):
    """11 windows in chunks of 8 over 2 ranks (the last chunk, 3 windows,
    padded to 4) against world size 1 and ``scgrhc``'s sharded
    ``predict_split`` (the same chunks, the last padded to 8).  int8: each
    activation scale spans the chunk's real windows on both ranks, so each
    window's output is world size 1's; ``scgrhc``'s scale also spans its
    zero pad windows, and its int8 is held by correlation, as
    tests/test_torch_quant.py holds it."""
    inp = world["inputs"]
    store = SegmentStore(**inp["store"])
    gen = convert.generator_from_state_dict(inp["g_sd"]).eval()
    want = infer.predict_split(gen if dtype == "float32" else gen.cast(torch.int8), store,
                               batch=EVAL_BATCH)
    for real, pred, scores in (o[f"eval_{dtype}"] for o in world["outs"]):
        np.testing.assert_array_equal(real, want[0])
        np.testing.assert_allclose(pred, want[1], rtol=RTOL, atol=RTOL * np.abs(want[1]).max())
        for k, v in want[2].items():
            np.testing.assert_allclose(scores[k], v, rtol=1e-4, atol=1e-5, err_msg=k)
    js = inp["store"]
    jstore = JSegmentStore(js["scg"], js["rhc"], js["record_names"], js["start_idx"],
                           js["stop_idx"], js["minmax_scg"], js["minmax_rhc"], T)
    params = jax.tree.map(jnp.asarray, convert.jax_params_from_state_dict(inp["g_sd"]))
    _, jpred, _ = jinfer.predict_split(params, jstore, batch=EVAL_BATCH, dtype=dtype,
                                       sharding=jmesh.batch_sharding(jmesh.make_mesh()))
    pred = world["outs"][0][f"eval_{dtype}"][1]
    if dtype == "float32":
        np.testing.assert_allclose(pred, jpred, rtol=JAX_RTOL,
                                   atol=JAX_RTOL * np.abs(jpred).max())
    else:
        for i in range(len(pred)):
            assert np.corrcoef(pred[i], jpred[i])[0, 1] > FWD_MIN_PCC


def test_predict_mesh_matches_world_one_and_scgrhc(world, tmp_path, monkeypatch):
    """``predict <dir> SYN000 last --mesh`` at world size 2: the 625 windows
    in chunks of 512 and 113 split over the ranks; rank 0 alone wrote the
    .npy and its sidecar; the waveform is world size 1's (``--mesh`` a
    mesh of one) and ``scgrhc``'s ``predict --mesh`` on 8 devices."""
    r0, r1 = world["outs"]
    assert r0["predict_rc"] == r1["predict_rc"] == 0 and r1["writes"] == []
    exp = world["inputs"]["exp"]
    got = np.load(os.path.join(exp, "predictions", "SYN000.npy"))
    assert got.shape == (625 * T,) and np.isfinite(got).all()
    for mod in (tpaths, jpaths):
        monkeypatch.setattr(mod, "DATA_PATH", world["inputs"]["data"])
        monkeypatch.setattr(mod, "PROCESSED_DATA_PATH",
                            os.path.join(world["inputs"]["data"], "processed_data"))
    one = tpredict.run(Params(os.path.join(exp, "params.json")), "SYN000", "last", mesh=True,
                       device="cpu", out_dir=str(tmp_path / "one"))
    want = np.load(one)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=RTOL * np.abs(want).max())
    theirs = np.load(jpredict.run(JParams(os.path.join(exp, "params.json")), "SYN000", "last",
                                  out_dir=str(tmp_path / "jax"), mesh=True))
    np.testing.assert_allclose(got, theirs, rtol=JAX_RTOL, atol=JAX_RTOL * np.abs(theirs).max())


def test_backend_rule_and_world_of_one(monkeypatch):
    """nccl for one card per rank, gloo on the CPU or pinned to a card; no
    group without a world in the environment; a stage launched into a
    world with no group refuses to run alone."""
    assert comm.backend_for(None)[0] == comm.backend_for("cuda")[0] == "nccl"
    assert comm.backend_for("cpu")[0] == comm.backend_for("cuda:0")[0] == "gloo"
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert comm.init_distributed() is False and not comm.is_initialized()
    monkeypatch.setenv("WORLD_SIZE", "1")
    assert comm.init_distributed() is False and not comm.is_initialized()
    assert comm.process_count() == 1 and comm.is_primary() and comm.process_index() == 0
    assert comm.on_primary("x", lambda: 7) == 7 and comm.broadcast(torch.ones(1)).item() == 1
    comm.barrier("one")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(RuntimeError, match="no process group"):
        comm.refuse_lone_rank()


def test_a_mesh_of_one_splits_pads_and_gathers_nothing():
    """``Mesh(1, 0)``, one process's mesh: its block is every row, and
    ``pad_rows`` and ``fetch_rows`` hand back the rows as they are; a batch
    is padded (with row 0 and a 0 mask) only past a mesh of one."""
    m = tmesh.Mesh(1, 0)
    x = torch.arange(10.0).reshape(5, 2)
    assert tmesh.make_mesh() == m and tmesh.row_block(m, 5) == (0, 5, 5)
    assert tmesh.pad_rows(x, 5) is x
    (got,) = tmesh.fetch_rows(m, 5, x)
    assert got.data_ptr() == x.data_ptr() and torch.equal(got, x)
    idx = torch.arange(5)
    same, mask = tmesh.pad_idx_mask(idx, 1)
    assert same is idx and mask is None
    padded, mask = tmesh.pad_idx_mask(idx, 2)
    assert padded.tolist() == [0, 1, 2, 3, 4, 0] and mask.tolist() == [1, 1, 1, 1, 1, 0]


@pytest.mark.parametrize("argv", [["demo", "w"], ["sweep", "."], ["summary"], ["report", "."]])
def test_single_rank_commands_refuse_a_world(argv, monkeypatch):
    """The host-side commands, whose every rank would write the same files,
    refuse a world of two."""
    from scgrhc_torch.__main__ import main

    monkeypatch.setattr(comm, "process_count", lambda: 2)
    with pytest.raises(SystemExit, match="more than one rank.*not yet ported"):
        main(argv)
