"""The port's training slice against ``scgrhc``.

  * K1b's plain version and the ``ConvInReLU`` Function against ``jax.vjp``
    of ``scgrhc.ops.pallas.conv_block.conv_in_relu`` in interpret mode, f32.
  * One WGAN-GP step (``scgrhc_torch.train.wgan.train_step``) against
    ``scgrhc.train.wgan._train_step_impl`` in f64, draws pinned on both
    sides through the seams (``generator.dropout``, ``wgan._draw_eps``):
    losses at the f64 oracle tier's rtol 1e-9 and updated weights at rtol
    1e-9 (tests/test_reference_parity.py), except the biases that feed an
    instance norm (see ``NOISE_ATOL``).
  * The kernel launches of a step, counted through the wrappers on the CPU,
    against ``launches_per_step``.
  * Checkpoints both ways with ``scgrhc.train.checkpoint``, loader files
    from ``scgrhc.data``, and training runs on the CPU: 2 epochs straight
    against 1 epoch plus a resume, step mode against epoch mode.
"""

import collections
import contextlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.data.loaders import SegmentLoader as JSegmentLoader
from scgrhc.data.store import SegmentStore as JSegmentStore
from scgrhc.models import generator as jgen
from scgrhc.models import torch_compat
from scgrhc.ops.pallas.conv_block import conv_in_relu as jax_conv_in_relu
from scgrhc.train import checkpoint as jckpt
from scgrhc.train import wgan as jwgan
from scgrhc_torch.__main__ import main as cli
from scgrhc_torch.core.params import Params
from scgrhc_torch.data.loaders import SegmentLoader, load_dataloader
from scgrhc_torch.data.store import SegmentStore
from scgrhc_torch.models import convert
from scgrhc_torch.models import generator as tgen
from scgrhc_torch.ops import nn as tnn
from scgrhc_torch.ops.kernels import conv_block as k1
from scgrhc_torch.ops.kernels import critic_fused as k2
from scgrhc_torch.train import checkpoint as ckpt_io
from scgrhc_torch.train import run as train_run
from scgrhc_torch.train import wgan

T = 32
# A bias that feeds an instance norm has an analytically zero gradient; in
# f64 it is rounding noise of ~1e-13, which Adam divides by |g| + 1e-8, so
# the weight moves by up to lr·1e-13/1e-8 ≈ 1e-9 in either package.
NOISE_ATOL = 1e-8
NORMED_BIASES = (
    {f"{b}.{i}.bias" for b in ("enc1", "enc2", "enc3", "bottleneck", "dec3", "dec2", "dec1")
     for i in (0, 3)}
    | {f"{a}.{s}.0.bias" for a in ("att3", "att2", "att1") for s in ("W_x", "W_g", "psi")}
    | {f"model.{i}.bias" for i in (2, 5, 8)}
)
K1B_ATOL = 2e-4  # f32 against the Pallas backward: reassociation over C_in·3 and T


@contextlib.contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


@pytest.mark.parametrize("ci,o", [(3, 8), (8, 16)])
def test_conv_in_relu_bwd_matches_pallas_vjp(ci, o):
    rng = np.random.default_rng(ci)
    x = rng.standard_normal((2, ci, T)).astype(np.float32)
    w = (rng.uniform(-1, 1, (o, ci, 3)) / np.sqrt(3 * ci)).astype(np.float32)
    b = (rng.uniform(-1, 1, o) / np.sqrt(3 * ci)).astype(np.float32)
    dy = rng.standard_normal((2, o, T)).astype(np.float32)
    _, vjp = jax.vjp(lambda *a: jax_conv_in_relu(*a, interpret=True),
                     jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    want = [np.asarray(v) for v in vjp(jnp.asarray(dy))]

    tx, tw, tb, tdy = (torch.from_numpy(v) for v in (x, w, b, dy))
    got = k1.conv_in_relu_bwd_plain(tx, tw, tb, tdy)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), r, atol=K1B_ATOL)
    assert k1.conv_in_relu_bwd_plain(tx, tw, tb, tdy, need_dx=False)[0] is None

    # the Function: K1f forward, K1b backward (on the CPU, their plain versions)
    tw.requires_grad_()
    tb.requires_grad_()
    before = k1.conv_in_relu_bwd.launches
    y = k1.ConvInReLU.apply(tx, tw, tb)
    gw, gb = torch.autograd.grad(y, (tw, tb), tdy)
    assert k1.conv_in_relu_bwd.launches == before  # CPU: no kernel
    np.testing.assert_allclose(gw.numpy(), want[1], atol=K1B_ATOL)
    np.testing.assert_allclose(gb.numpy(), want[2], atol=K1B_ATOL)
    xg = tx.clone().requires_grad_()
    (gx,) = torch.autograd.grad(k1.ConvInReLU.apply(xg, tw, tb), xg, tdy)
    np.testing.assert_allclose(gx.numpy(), want[0], atol=K1B_ATOL)


def test_conv_in_relu_function_gradcheck():
    g = torch.Generator().manual_seed(0)
    args = [torch.randn(s, dtype=torch.float64, generator=g, requires_grad=True)
            for s in ((2, 3, 9), (4, 3, 3), (4,))]
    assert torch.autograd.gradcheck(k1.ConvInReLU.apply, args)


def test_dropout_is_inverted_and_train_only():
    x = torch.ones(64, 64, 8)
    assert tnn.dropout(x, 0.3, None, train=False) is x
    assert tnn.dropout(x, 0.0, None, train=True) is x
    y = tnn.dropout(x, 0.3, torch.Generator().manual_seed(1), train=True)
    kept = y != 0
    assert torch.allclose(y[kept], torch.full_like(y[kept], 1 / 0.7))
    assert abs(float(kept.float().mean()) - 0.7) < 0.01
    again = tnn.dropout(x, 0.3, torch.Generator().manual_seed(1), train=True)
    assert torch.equal(y, again)


def test_masked_mean_and_gp_norms_match_jax():
    rng = np.random.default_rng(0)
    v = rng.standard_normal((4, 1, T)).astype(np.float32)
    mask = np.array([1, 0, 1, 1], np.float32)
    for m in (None, mask):
        want = float(jwgan._masked_mean(jnp.asarray(v), None if m is None else jnp.asarray(m)))
        got = float(wgan._masked_mean(torch.from_numpy(v),
                                      None if m is None else torch.from_numpy(m)))
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)  # f32 summation order
    g = rng.standard_normal((4, 3, T)).astype(np.float32)
    np.testing.assert_allclose(wgan._gp_norms(torch.from_numpy(g).bfloat16()).numpy(),
                               np.asarray(jwgan._gp_norms(jnp.asarray(g, jnp.bfloat16))),
                               rtol=1e-6)


# ---- one step against the JAX step, f64 -------------------------------------

STEP_CASES = {
    "off": dict(n_critic=1),
    "2b_reuse_pred": dict(n_critic=1, critic_fuse="2b", reuse_pred=True),
    "3b_fix_g_masked": dict(n_critic=1, critic_fuse="3b", fix_g_adversarial=True),
}


@pytest.mark.parametrize("case", list(STEP_CASES))
def test_train_step_matches_jax_f64(case):
    kw = STEP_CASES[case]
    b, c = 3, 2
    jcfg = jwgan.TrainConfig(**kw)
    tcfg = wgan.TrainConfig(**kw)
    init = jwgan.init_state(jax.random.key(0), c, jcfg)
    g0 = jax.tree.map(lambda a: np.asarray(a, np.float64), init.g_params)
    d0 = jax.tree.map(lambda a: np.asarray(a, np.float64), init.d_params)
    rng = np.random.default_rng(1)
    scg, rhc = rng.random((b, c, T)), rng.random((b, 1, T))
    eps = [rng.random((b, 1, 1)) for _ in range(jcfg.n_critic)]
    mask = np.array([1.0, 1.0, 0.0]) if case.endswith("masked") else None

    # JAX: masks drawn in call order at trace time; with reuse_pred the
    # generator update's forward repeats the shared forward's key, so it
    # replays the shared forward's masks (the port runs that forward once)
    masks = []
    calls = collections.Counter()

    def jax_dropout(x, rate, rng=None, train=True):
        k = calls["jax"]
        calls["jax"] += 1
        if kw.get("reuse_pred"):
            k %= 6  # the G forward = the shared forward
        while len(masks) <= k:
            masks.append((np.random.default_rng(100 + len(masks)).random(x.shape) < 0.7)
                         .astype(np.float64))
        return x * jnp.asarray(masks[k]) / (1.0 - rate)

    jeps = collections.deque(eps)
    real = (jgen.dropout, jwgan._draw_eps)
    jgen.dropout, jwgan._draw_eps = jax_dropout, lambda key, n: jnp.asarray(jeps.popleft())
    try:
        with enable_x64():
            opt = jwgan.make_optimizer(jcfg)
            gj, dj = jax.tree.map(jnp.asarray, g0), jax.tree.map(jnp.asarray, d0)
            state = jwgan.TrainState(gj, dj, opt.init(gj), opt.init(dj))
            step = jax.jit(jwgan._train_step_impl, static_argnames=("cfg",))
            s1, d_want, g_want = step(state, jnp.asarray(scg), jnp.asarray(rhc),
                                      jax.random.key(5), jcfg,
                                      None if mask is None else jnp.asarray(mask))
            g1 = jax.tree.map(np.asarray, s1.g_params)
            d1 = jax.tree.map(np.asarray, s1.d_params)
            d_want, g_want = np.asarray(d_want), float(g_want)
    finally:
        jgen.dropout, jwgan._draw_eps = real
    n_forwards = 1 if kw.get("reuse_pred") else jcfg.n_critic + 1
    assert len(masks) == 6 * n_forwards

    replay = collections.deque(masks)
    teps = collections.deque(eps)

    def torch_dropout(x, rate, rng, train):
        return x * torch.from_numpy(replay.popleft()) / (1.0 - rate)

    real = (tgen.dropout, wgan._draw_eps)
    tgen.dropout = torch_dropout
    wgan._draw_eps = lambda rng, n, device: torch.from_numpy(teps.popleft())
    try:
        g = convert.generator_from_jax_params(g0)
        d = convert.critic_from_jax_params(d0)
        st = wgan.TrainState(g, d, wgan.make_optimizer(g, tcfg), wgan.make_optimizer(d, tcfg))
        d_got, g_got = wgan.train_step(st, torch.from_numpy(scg), torch.from_numpy(rhc), None,
                                       tcfg, None if mask is None else torch.from_numpy(mask))
    finally:
        tgen.dropout, wgan._draw_eps = real
    assert not replay and not teps
    np.testing.assert_allclose(d_got.numpy(), d_want, rtol=1e-9)
    np.testing.assert_allclose(float(g_got), g_want, rtol=1e-9)
    for got_sd, want_sd in (
        ({k: v.detach().numpy() for k, v in g.state_dict().items()},
         convert.state_dict_from_jax_params(g1)),
        ({k: v.detach().numpy() for k, v in d.state_dict().items()},
         convert.critic_state_dict_from_jax_params(d1)),
    ):
        for k, v in want_sd.items():
            assert got_sd[k].dtype == np.float64
            tol = dict(rtol=0, atol=NOISE_ATOL) if k in NORMED_BIASES else dict(rtol=1e-9)
            np.testing.assert_allclose(got_sd[k], v, err_msg=k, **tol)


@pytest.mark.parametrize("kw", [{}, {"critic_fuse": "2b"}, {"critic_fuse": "3b"},
                                {"reuse_pred": True}, {"fix_g_adversarial": True}])
def test_launches_per_step_counts_the_wrappers(kw, monkeypatch):
    """On the card each wrapper call is one launch; on the CPU the same
    calls run the plain versions, so counting them here checks the table
    that chip_smoke.py asserts."""
    counts = collections.Counter()

    def counting(mod, name):
        fn = getattr(mod, name)

        def wrapper(*a, **k):
            counts[name] += 1
            return fn(*a, **k)

        monkeypatch.setattr(mod, name, wrapper)

    for name in ("conv_in_relu", "conv_in_relu_bwd"):
        counting(k1, name)
    for name in ("critic_layer", "critic_layer_bwd_dx", "critic_layer_bwd_dwdb"):
        counting(k2, name)
    cfg = wgan.TrainConfig(n_critic=2, **kw)
    st = wgan.init_state(0, 1, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    wgan.train_step(st, torch.rand(2, 1, 16, generator=g), torch.rand(2, 1, 16, generator=g),
                    torch.Generator().manual_seed(1), cfg)
    assert dict(counts) == wgan.launches_per_step(cfg)


# ---- checkpoints and loaders, both ways -------------------------------------

def _jax_state_with_moments(c: int, seed: int = 0):
    """A JAX TrainState whose Adam state has count 3 and random moments."""
    cfg = jwgan.TrainConfig()
    st = jwgan.init_state(jax.random.key(seed), c, cfg)
    rng = np.random.default_rng(seed)

    def moments(opt_state, params):
        mu = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        nu = jax.tree.map(lambda a: rng.random(a.shape).astype(np.float32), params)
        return (opt_state[0]._replace(count=jnp.int32(3), mu=mu, nu=nu),) + tuple(opt_state[1:])

    return st._replace(g_opt=moments(st.g_opt, st.g_params),
                       d_opt=moments(st.d_opt, st.d_params)), cfg


def _adam(opt, kind):
    """A port optimizer's (count, mu, nu) as JAX-layout numpy trees."""
    sd = ckpt_io._adam_layout(opt.state_dict()["state"], len(opt.param_groups[0]["params"]),
                              wgan.TrainConfig())
    return convert.adam_state_to_jax(sd["state"], kind)


def test_jax_checkpoint_restores_in_port(tmp_path):
    st, cfg = _jax_state_with_moments(2)
    path = str(tmp_path / "004.checkpoint")
    jckpt.save(path, start_time=1.0, epoch=4, g_losses=[1.0], d_losses=[2.0, 3.0], state=st,
               cfg=cfg)
    ck = ckpt_io.load(path)
    port = ckpt_io.restore(ck, wgan.TrainConfig(), 2, "cpu")
    want_g = torch_compat.generator_to_torch_sd(jax.tree.map(np.asarray, st.g_params),
                                                as_torch=False)
    for k, v in port.generator.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want_g[k])
    want_d = convert.critic_state_dict_from_jax_params(jax.tree.map(np.asarray, st.d_params))
    for k, v in port.critic.state_dict().items():
        np.testing.assert_array_equal(v.numpy(), want_d[k])
    for opt, jopt, kind in ((port.g_opt, st.g_opt, "generator"),
                            (port.d_opt, st.d_opt, "critic")):
        want = convert.adam_state_from_jax(
            int(jopt[0].count), *(jax.tree.map(np.asarray, t) for t in (jopt[0].mu, jopt[0].nu)),
            kind)
        got = opt.state_dict()["state"]
        assert set(got) == set(want)
        for i, s in want.items():
            assert float(got[i]["step"]) == s["step"] == 3
            np.testing.assert_array_equal(got[i]["exp_avg"].numpy(), s["exp_avg"])
            np.testing.assert_array_equal(got[i]["exp_avg_sq"].numpy(), s["exp_avg_sq"])


def test_port_checkpoint_restores_in_jax(tmp_path):
    cfg = wgan.TrainConfig(n_critic=1)
    st = wgan.init_state(3, 2, cfg, "cpu")
    g = torch.Generator().manual_seed(0)
    wgan.train_step(st, torch.rand(2, 2, T, generator=g), torch.rand(2, 1, T, generator=g),
                    torch.Generator().manual_seed(1), cfg)
    path = str(tmp_path / "000.checkpoint")
    ckpt_io.save(path, start_time=0.0, epoch=0, g_losses=[1.0], d_losses=[2.0], state=st,
                 cfg=cfg, block=False)
    ckpt_io.wait()
    ck = jckpt.load(path)
    assert ck["format"] == "scgrhc-checkpoint.v1" and ck["epoch"] == 0
    js = jckpt.restore_state(ck, jwgan.TrainConfig(n_critic=1), 2)
    for tree, module in ((js.g_params, st.generator), (js.d_params, st.critic)):
        sd = (torch_compat.generator_to_torch_sd if module is st.generator
              else torch_compat.critic_to_torch_sd)(jax.tree.map(np.asarray, tree),
                                                    as_torch=False)
        for k, v in module.state_dict().items():
            np.testing.assert_array_equal(sd[k], v.numpy())
    for jopt, opt, kind in ((js.g_opt, st.g_opt, "generator"), (js.d_opt, st.d_opt, "critic")):
        count, mu, nu = _adam(opt, kind)
        assert int(jopt[0].count) == count == 1
        jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jopt[0].mu), mu)
        jax.tree.map(np.testing.assert_array_equal, jax.tree.map(np.asarray, jopt[0].nu), nu)


def _raw_windows(n, c, seed=0):
    rng = np.random.default_rng(seed)
    return rng.random((n, T, c)) * 5 - 2, rng.random((n, T, 1)) * 40 + 5


def test_jax_loader_loads_in_port(tmp_path):
    scg, rhc = _raw_windows(7, 2)
    store = SegmentStore.from_windows(scg, rhc, "SYN000", np.arange(7) * T)
    jstore = JSegmentStore(store.scg, store.rhc, store.record_names, store.start_idx,
                           store.stop_idx, store.minmax_scg, store.minmax_rhc, T)
    path = str(tmp_path / "loader_train.pickle")
    JSegmentLoader(jstore, 3, shuffle=True, seed=5).save(path)
    got = load_dataloader(path)
    assert (got.batch_size, got.shuffle, got.seed, len(got)) == (3, True, 5, 3)
    for name in ("scg", "rhc", "start_idx", "stop_idx", "minmax_scg", "minmax_rhc"):
        np.testing.assert_array_equal(getattr(got.dataset, name), getattr(jstore, name))
    jl = JSegmentLoader(jstore, 3, shuffle=True, seed=5)
    for epoch in range(3):
        np.testing.assert_array_equal(got.epoch_order(epoch), jl.epoch_order(epoch))
        jl.set_epoch(epoch)
        for (a, b), (c, d) in zip(got.batches(epoch), jl):
            np.testing.assert_array_equal(a, c)
            np.testing.assert_array_equal(b, d)


def test_store_normalization_matches_jax_from_segments():
    from scgrhc.dsp.segment import Segment

    scg, rhc = _raw_windows(3, 2, seed=4)
    segs = [Segment(scg=scg[i], rhc=rhc[i], record_name="R", start_idx=i * T,
                    stop_idx=(i + 1) * T) for i in range(3)]
    want = JSegmentStore.from_segments(segs, T / 500, None, None)
    got = SegmentStore.from_windows(scg, rhc, "R", np.arange(3) * T)
    for name in ("scg", "rhc", "minmax_scg", "minmax_rhc", "start_idx", "stop_idx"):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name))


def test_loader_refuses_reference_torch_pickle(tmp_path):
    import pickle

    path = str(tmp_path / "loader.pickle")
    with open(path, "wb") as f:
        pickle.dump([1, 2, 3], f)
    with pytest.raises(NotImplementedError, match="not yet ported"):
        load_dataloader(path)


# ---- training runs on the CPU -----------------------------------------------

def _experiment(tmp_path, name, **extra):
    exp = str(tmp_path / name)
    os.makedirs(exp, exist_ok=True)
    scg, rhc = _raw_windows(5, 1, seed=2)
    store = SegmentStore.from_windows(scg, rhc, "SYN000", np.arange(5) * T)
    SegmentLoader(store, 2, seed=3).save(os.path.join(exp, "loader_train.pickle"))
    cfg = {
        "dir_path": exp, "in_channels": ["patch_ACC_lat"], "chamber": "PA",
        "segment_size": T / 500, "batch_size": 2, "train_path": "loader_train.pickle",
        "valid_path": "v.pickle", "test_path": "t.pickle", "checkpoint_dir_path": "checkpoints",
        "comparison_dir_path": "c", "pred_top_dir_path": "p", "pred_rand_dir_path": "r",
        "alpha": 1e-4, "beta1": 0.5, "beta2": 0.999, "n_critic": 1, "lambda_gp": 10,
        "lambda_aux": 100, "total_epochs": 2, "min_RHC": -50, "use_global_min_max": False,
        "seed": 7, **extra,
    }
    with open(os.path.join(exp, "params.json"), "w") as f:
        json.dump(cfg, f)
    return exp


def _load_ckpt(exp, epoch):
    return ckpt_io.load(os.path.join(exp, "checkpoints", f"{epoch:03d}.checkpoint"))


def _assert_same_checkpoint(a, b):
    assert a["g_losses"] == b["g_losses"] and a["d_losses"] == b["d_losses"]
    assert a["epoch"] == b["epoch"]
    for k in ("g_state_dict", "d_state_dict"):
        for p, v in a[k].items():
            np.testing.assert_array_equal(v, b[k][p], err_msg=p)
    for k in ("g_optimizer_state_dict", "d_optimizer_state_dict"):
        for i, s in a[k]["state"].items():
            assert s["step"] == b[k]["state"][i]["step"]
            np.testing.assert_array_equal(s["exp_avg"], b[k]["state"][i]["exp_avg"])
            np.testing.assert_array_equal(s["exp_avg_sq"], b[k]["state"][i]["exp_avg_sq"])


def test_training_runs_resume_and_modes_agree(tmp_path):
    straight = _experiment(tmp_path, "straight")
    train_run.run(Params(os.path.join(straight, "params.json")), device="cpu", plot=False)

    resumed = _experiment(tmp_path, "resumed", total_epochs=1, checkpoint_async=True)
    out = train_run.run(Params(os.path.join(resumed, "params.json")), device="cpu", plot=False)
    assert [e["epoch"] for e in out["epochs"]] == [0] and out["epochs"][0]["steps"] == 3
    _experiment(tmp_path, "resumed", total_epochs=2)
    out = train_run.run(Params(os.path.join(resumed, "params.json")), device="cpu", plot=False)
    assert [e["epoch"] for e in out["epochs"]] == [1]

    stepped = _experiment(tmp_path, "stepped", train_mode="step")
    assert cli(["train", stepped, "--device", "cpu"]) == 0

    first = _load_ckpt(straight, 1)
    assert len(first["g_losses"]) == 6 and len(first["d_losses"]) == 6
    assert np.isfinite(first["g_losses"] + first["d_losses"]).all()
    assert set(first) == {"format", "start_time", "epoch", "g_losses", "d_losses",
                          "g_state_dict", "d_state_dict", "g_optimizer_state_dict",
                          "d_optimizer_state_dict"}
    for other in (resumed, stepped):
        for epoch in (0, 1):
            _assert_same_checkpoint(_load_ckpt(straight, epoch), _load_ckpt(other, epoch))
    assert not any(n.endswith(".tmp") for n in os.listdir(os.path.join(resumed, "checkpoints")))


def test_jax_checkpoint_resumes_training_in_port(tmp_path):
    exp = _experiment(tmp_path, "from_jax")
    st, cfg = _jax_state_with_moments(1, seed=4)
    os.makedirs(os.path.join(exp, "checkpoints"))
    jckpt.save(os.path.join(exp, "checkpoints", "000.checkpoint"), start_time=0.0, epoch=0,
               g_losses=[5.0, 6.0, 7.0], d_losses=[1.0, 2.0, 3.0], state=st, cfg=cfg)
    out = train_run.run(Params(os.path.join(exp, "params.json")), device="cpu", plot=False)
    assert [e["epoch"] for e in out["epochs"]] == [1]
    ck = _load_ckpt(exp, 1)
    assert ck["g_losses"][:3] == [5.0, 6.0, 7.0] and len(ck["g_losses"]) == 6
    assert ck["g_optimizer_state_dict"]["state"][0]["step"] == 3 + 3


@pytest.mark.parametrize("key,value", [("shape_bucket", True), ("channel_bucket", True),
                                       ("checkpoint_backend", "orbax"), ("rng_impl", "rbg")])
def test_unported_training_keys_raise(tmp_path, key, value):
    exp = _experiment(tmp_path, "refused", **{key: value})
    with pytest.raises(NotImplementedError, match="not yet ported"):
        train_run.run(Params(os.path.join(exp, "params.json")), device="cpu")


def test_multi_process_launch_raises(tmp_path, monkeypatch):
    exp = _experiment(tmp_path, "dp")
    monkeypatch.setenv("WORLD_SIZE", "2")
    with pytest.raises(NotImplementedError, match="more than one device"):
        train_run.run(Params(os.path.join(exp, "params.json")), device="cpu")
