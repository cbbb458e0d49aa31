"""The keys of ``train_profile: "fast"`` in the port's training and
evaluation, against the same runs with the keys off and against
``scgrhc``'s profile.

  * ``channel_bucket`` and ``shape_bucket`` are read and ignored by the
    port (they pad shapes for XLA's program sharing): a 1-epoch CPU run
    with either key on writes the key-off run's checkpoint bit for bit, in
    step and epoch mode, and eval CSVs and ``checkpoint_scores.csv`` are
    byte-equal.
  * ``train_step``'s 0/1 mask: one padded-and-masked step equals the
    unpadded step in float64 at the oracle tier's rtol 1e-9.
  * ``rng_impl``: "rbg" and "unsafe_rbg" train the threefry run's
    checkpoint; ``train_profile: "fast"`` sets ``scgrhc``'s keys and trains
    (bf16) and evaluates end to end on the CPU.
"""

import collections
import json
import os
import shutil

import numpy as np
import pytest
import torch

from scgrhc_torch.core.params import Params
from scgrhc_torch.data.loaders import SegmentLoader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.eval import run as eval_run
from scgrhc_torch.models import convert
from scgrhc_torch.models import generator as tgen
from scgrhc_torch.select import run as select_run
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import run as train_run
from scgrhc_torch.train import wgan

T = 32
CHANNELS = ["patch_ACC_lat", "patch_ACC_hf", "patch_ACC_dv"]
NORMED_BIASES = (
    {f"{b}.{i}.bias" for b in ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1")
     for i in (0, 3)}
    | {f"{a}.{s}.0.bias" for a in ("att3", "att2", "att1") for s in ("W_x", "W_g", "psi")}
    | {f"model.{i}.bias" for i in (2, 5, 8)}
)


def _experiment(tmp_path, name, c=1, n=5, batch=2, **extra) -> Params:
    """An experiment of ``n`` windows of ``c`` SCG channels (the same
    windows in every split), ``batch_size`` ``batch``, 1 epoch."""
    exp = str(tmp_path / name)
    os.makedirs(exp, exist_ok=True)
    rng = np.random.default_rng(2)
    store = SegmentStore.from_windows(rng.standard_normal((n, T, c)),
                                      rng.standard_normal((n, T, 1)) * 5 + 20, "SYN000",
                                      np.arange(n) * T)
    SegmentLoader(store, batch, seed=3).save(os.path.join(exp, "loader_train.pickle"))
    SegmentLoader(store, 1, shuffle=False).save(os.path.join(exp, "loader_valid.pickle"))
    cfg = {
        "dir_path": exp, "in_channels": CHANNELS[:c], "chamber": "PA",
        "segment_size": T / 500, "batch_size": batch, "train_path": "loader_train.pickle",
        "valid_path": "loader_valid.pickle", "test_path": "loader_valid.pickle",
        "checkpoint_dir_path": "checkpoints", "comparison_dir_path": "comparisons",
        "pred_top_dir_path": "pred_top", "pred_rand_dir_path": "pred_rand", "alpha": 1e-4,
        "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10, "lambda_aux": 100,
        "total_epochs": 1, "min_RHC": -50, "use_global_min_max": False, "seed": 7, **extra,
    }
    with open(os.path.join(exp, "params.json"), "w") as f:
        json.dump(cfg, f)
    return Params(os.path.join(exp, "params.json"))


def _train(p: Params) -> dict:
    train_run.run(p, device="cpu", plot=False)
    return ckpt_io.load(os.path.join(p.checkpoint_dir_path, "000.checkpoint"))


def _assert_same_run(got: dict, want: dict) -> None:
    """Equal losses, weights and Adam moments and steps, bit for bit."""
    assert got["g_losses"] == want["g_losses"] and got["d_losses"] == want["d_losses"]
    for (name, _, a), (_, _, b) in zip(_tensors(want), _tensors(got)):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        assert [s["step"] for s in got[k]["state"].values()] == \
               [s["step"] for s in want[k]["state"].values()]


def _tensors(ck: dict):
    """(name, array) of every weight and Adam moment of a checkpoint."""
    for k in ("g_state_dict", "d_state_dict"):
        for p, v in ck[k].items():
            yield k[0] + ":" + p, p, v
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        names = convert.param_keys("generator" if k[0] == "g" else "critic")
        for i, s in ck[k]["state"].items():
            for m in ("exp_avg", "exp_avg_sq"):
                yield f"{k[0]}:{names[i]}:{m}", names[i], s[m]


# ---- channel_bucket ------------------------------------------------------------

@pytest.mark.parametrize("mode", ["epoch", "step"])
@pytest.mark.parametrize("c", [1, 2])
def test_channel_bucket_writes_the_key_off_checkpoint(tmp_path, c, mode):
    off = _train(_experiment(tmp_path, "off", c, train_mode=mode))
    on = _train(_experiment(tmp_path, "on", c, channel_bucket=True, train_mode=mode))
    assert on["g_state_dict"]["enc1.0.weight"].shape == (64, c, 3)
    assert on["d_state_dict"]["model.0.weight"].shape == (64, c + 1, 3)
    _assert_same_run(on, off)


def _eval_csvs(tmp_path, p: Params, name: str, **keys) -> dict:
    """Score the checkpoints of ``p`` on its valid split in a copy of the
    experiment with ``keys`` set; the comparison CSVs and
    ``checkpoint_scores.csv`` as bytes."""
    d = str(tmp_path / name)
    shutil.copytree(p.dir_path, d, ignore=shutil.ignore_patterns("comparisons"))
    with open(os.path.join(d, "params.json")) as f:
        cfg = json.load(f)
    cfg.update(dir_path=d, **keys)
    with open(os.path.join(d, "params.json"), "w") as f:
        json.dump(cfg, f)
    q = Params(os.path.join(d, "params.json"))
    eval_run.run(q, "valid", "all", device="cpu")
    select_run.run(q)
    comp = os.path.join(q.comparison_dir_path, "valid")
    out = {f: open(os.path.join(comp, f), "rb").read() for f in sorted(os.listdir(comp))}
    out["checkpoint_scores.csv"] = open(os.path.join(d, "checkpoint_scores.csv"), "rb").read()
    return out


@pytest.mark.parametrize("c", [1, 2, 3])
def test_channel_bucket_eval_csvs_are_byte_equal(tmp_path, c):
    p = _experiment(tmp_path, "exp", c, n=7, eval_batch=4)
    _train(p)
    off = _eval_csvs(tmp_path, p, "off")
    assert list(off) == ["000.csv", "checkpoint_scores.csv"]
    assert off == _eval_csvs(tmp_path, p, "on", channel_bucket=True)


# ---- shape_bucket --------------------------------------------------------------

@pytest.fixture()
def pinned_draws(monkeypatch):
    """Dropout masks and GP eps that depend on the row, not on the batch
    size: a padded batch's real rows draw what the short batch draws."""
    masks = {}

    def dropout(x, rate, rng, train):
        if not train:
            return x
        key = (tuple(x.shape[1:]), x.dtype)
        if key not in masks:
            keep = np.random.default_rng(len(masks)).random((8, *x.shape[1:])) < 1.0 - rate
            masks[key] = torch.from_numpy(keep)
        return torch.where(masks[key][:x.shape[0]], x / (1.0 - rate), 0.0)

    eps = np.random.default_rng(99).random((8, 1, 1))
    monkeypatch.setattr(tgen, "dropout", dropout)
    monkeypatch.setattr(wgan, "_draw_eps",
                        lambda rng, b, device: torch.from_numpy(eps[:b]).to(torch.float32))


def test_masked_padded_step_is_the_unpadded_step_f64(pinned_draws, monkeypatch):
    """``train_step``'s mask: one step on a 1-row batch against the same
    row padded to 3 with the mask [1, 0, 0], in float64: losses at rtol 1e-9, weights at rtol 1e-9
    but the biases that feed an instance norm (Adam's noise on an
    analytically zero gradient, test_torch_train.py's NOISE_ATOL)."""
    eps = np.random.default_rng(99).random((8, 1, 1))
    monkeypatch.setattr(wgan, "_draw_eps", lambda rng, b, device: torch.from_numpy(eps[:b]))
    cfg = wgan.TrainConfig(n_critic=2)
    states = []
    for _ in range(2):
        st = wgan.init_state(0, 1, cfg, "cpu")
        st.generator.double()
        st.critic.double()
        states.append(wgan.TrainState(st.generator, st.critic,
                                      wgan.make_optimizer(st.generator, cfg),
                                      wgan.make_optimizer(st.critic, cfg)))
    rng = np.random.default_rng(0)
    scg = torch.from_numpy(rng.random((1, 1, T)))
    rhc = torch.from_numpy(rng.random((1, 1, T)))
    d1, g1 = wgan.train_step(states[0], scg, rhc, None, cfg)
    pad = lambda x: torch.cat((x, x.new_zeros((2, *x.shape[1:]))))  # noqa: E731
    d2, g2 = wgan.train_step(states[1], pad(scg), pad(rhc), None, cfg,
                             torch.tensor([1.0, 0.0, 0.0]))
    np.testing.assert_allclose(d2.numpy(), d1.numpy(), rtol=1e-9)
    np.testing.assert_allclose(float(g2), float(g1), rtol=1e-9)
    for m1, m2 in ((states[0].generator, states[1].generator),
                   (states[0].critic, states[1].critic)):
        for (k, a), (_, b) in zip(m1.state_dict().items(), m2.state_dict().items()):
            tol = dict(rtol=0, atol=1e-8) if k in NORMED_BIASES else dict(rtol=1e-9)
            np.testing.assert_allclose(b.numpy(), a.numpy(), err_msg=k, **tol)


@pytest.mark.parametrize("mode", ["step", "epoch"])
def test_shape_bucket_trains_the_key_off_run(tmp_path, mode):
    """8 windows at batch 3: the last batch has two rows, and the run is
    the key-off run's bit for bit."""
    off = _train(_experiment(tmp_path, "off", n=8, batch=3, train_mode=mode))
    on = _train(_experiment(tmp_path, "on", n=8, batch=3, shape_bucket=True, train_mode=mode))
    assert len(on["g_losses"]) == len(off["g_losses"]) == 3
    _assert_same_run(on, off)


@pytest.mark.parametrize("eval_batch", [3, 4])
def test_shape_bucket_eval_csvs_are_byte_equal(tmp_path, eval_batch):
    """7 windows in chunks of 3 or 4: a short last chunk (1 or 3
    windows)."""
    p = _experiment(tmp_path, "exp", 1, n=7, eval_batch=eval_batch)
    _train(p)
    assert _eval_csvs(tmp_path, p, "off") == _eval_csvs(tmp_path, p, "on", shape_bucket=True)


def test_shape_bucket_eval_of_a_split_below_eval_batch(tmp_path):
    """7 windows at eval_batch 16: one chunk shorter than eval_batch."""
    p = _experiment(tmp_path, "exp", 1, n=7, eval_batch=16)
    _train(p)
    assert _eval_csvs(tmp_path, p, "off") == _eval_csvs(tmp_path, p, "on", shape_bucket=True)


# ---- rng_impl and the fast profile ----------------------------------------------

@pytest.mark.parametrize("impl", ["rbg", "unsafe_rbg"])
def test_rng_impl_trains_the_threefry_run(tmp_path, impl):
    """The port draws from torch.Generator under every impl."""
    want = _train(_experiment(tmp_path, "threefry"))
    got = _train(_experiment(tmp_path, impl, rng_impl=impl))
    _assert_same_run(got, want)


def test_unknown_rng_impl_raises(tmp_path):
    with pytest.raises(ValueError, match="rng_impl"):
        train_run.run(_experiment(tmp_path, "x", rng_impl="philox"), device="cpu")


def test_fast_profile_trains_and_evaluates_on_cpu(tmp_path):
    """``train_profile: "fast"`` (bf16 training, reuse_pred, critic_fuse
    2b, both bucket keys, async checkpoints) on 2 channels: 1 epoch, then
    valid all and select; the checkpoint keeps the true channel count."""
    from scgrhc.core.params import Params as JaxParams

    p = _experiment(tmp_path, "fast", 2, n=7, batch=3, train_profile="fast", eval_batch=4)
    assert (p.shape_bucket, p.channel_bucket, p.rng_impl, p.train_dtype) == \
           (True, True, "rbg", "bfloat16")
    jp = JaxParams(os.path.join(p.dir_path, "params.json"))
    assert {k: v for k, v in vars(p).items() if k in vars(jp)} == \
           {k: v for k, v in vars(jp).items() if k in vars(p)}
    ck = _train(p)
    assert ck["g_state_dict"]["enc1.0.weight"].shape == (64, 2, 3)
    assert ck["d_state_dict"]["model.0.weight"].shape == (64, 3, 3)
    assert len(ck["g_losses"]) == 3 and np.isfinite(ck["g_losses"] + ck["d_losses"]).all()
    counts = collections.Counter(s["step"] for s in ck["d_optimizer_state_dict"]["state"].values())
    assert counts == {3: 10}
    eval_run.run(p, "valid", "all", device="cpu")
    select_run.run(p)
    best = open(os.path.join(p.dir_path, "checkpoint_best.txt")).read().split()
    assert best[1] == "000.checkpoint" and np.isfinite(float(best[3]))
