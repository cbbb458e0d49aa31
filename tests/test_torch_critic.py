"""The port's critic layer (K2f, K2dx, K2dw plain versions and their nested
autograd Functions) and Critic against ``scgrhc``.

  * The plain versions against the Pallas kernels of
    ``scgrhc.ops.pallas.critic_fused`` in interpret mode, in (N, C, T)
    after ``from_flat``: forward, input gradient and weight gradients, f32.
  * The Critic against ``scgrhc.models.critic``: the forward and the
    gradient penalty's value against ``apply_fused(..., interpret=True)``
    (f32); the parameter gradients and the GP's second-order parameter
    gradient against the XLA critic, which ``tests/test_critic_fused.py``
    holds to ``apply_fused`` (f64, at the oracle tier's rtol 1e-9).
  * The Functions' wiring itself: gradcheck and gradgradcheck in f64.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.models import critic as jcritic
from scgrhc.ops.pallas import critic_fused as jcf
from scgrhc.train import wgan as jwgan
from scgrhc_torch.models.convert import (
    critic_from_jax_params,
    critic_jax_params_from_state_dict,
    critic_state_dict_from_jax_params,
)
from scgrhc_torch.models.critic import Critic
from scgrhc_torch.ops.kernels import critic_fused as k2
from scgrhc_torch.train import wgan

T = 32  # interpret mode is slow; the math is length-blind
# f32 against the Pallas kernels: the tolerance of tests/test_critic_fused.py
F32_ATOL = 1e-5
GRAD_ATOL = 2e-4


@contextlib.contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _rand(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _t(a):
    return torch.from_numpy(np.asarray(a))


@pytest.mark.parametrize("mode", k2.MODES)
@pytest.mark.parametrize("shape", [(3, 5, 8), (2, 8, 16), (2, 16, 1)])  # (B, C_in, O)
def test_layer_plain_matches_pallas_interpret(mode, shape):
    b, c, o = shape
    x, dy = _rand((b, c, T), 0), _rand((b, o, T), 3)
    w, bias = _rand((o, c, 3), 1) * 0.3, _rand((o,), 2) * 0.1

    def flat_layer(xf, ww, bb):
        return jcf.fused_layer(xf, ww, bb, T, b, mode, interpret=True)

    xf = jcf.to_flat(jnp.asarray(x), T)
    yf, vjp = jax.vjp(flat_layer, xf, jnp.asarray(w), jnp.asarray(bias))
    dxf, dw, db = vjp(jcf.to_flat(jnp.asarray(dy), T))

    tx, tw, tb, tdy = _t(x), _t(w), _t(bias), _t(dy)
    y = k2.critic_layer_plain(tx, tw, tb, mode)
    np.testing.assert_allclose(y.numpy(), np.asarray(jcf.from_flat(yf, b, T)), atol=F32_ATOL)
    got_dx = k2.critic_layer_bwd_dx_plain(tx, tw, tb, tdy, mode)
    np.testing.assert_allclose(got_dx.numpy(), np.asarray(jcf.from_flat(dxf, b, T)),
                               atol=GRAD_ATOL)
    got_dw, got_db = k2.critic_layer_bwd_dwdb_plain(tx, tw, tb, tdy, mode)
    assert got_dw.dtype == got_db.dtype == torch.float32
    np.testing.assert_allclose(got_dw.numpy(), np.asarray(dw), atol=GRAD_ATOL)
    np.testing.assert_allclose(got_db.numpy(), np.asarray(db), atol=GRAD_ATOL)

    # the Function's first-order backward on the CPU is the plain version
    tx.requires_grad_()
    tw.requires_grad_()
    tb.requires_grad_()
    gx, gw, gb = torch.autograd.grad(k2.fused_layer(tx, tw, tb, mode), (tx, tw, tb), tdy)
    assert torch.equal(gx, got_dx) and torch.equal(gw, got_dw) and torch.equal(gb, got_db)


@pytest.mark.parametrize("mode", k2.MODES)
def test_layer_functions_twice_differentiable(mode):
    """Layer → BwdDx/BwdDwDb → their plain vjp: gradcheck and
    gradgradcheck in f64 (the GP differentiates the input gradient)."""
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 3, 9, dtype=torch.float64, generator=g, requires_grad=True)
    w = torch.randn(4, 3, 3, dtype=torch.float64, generator=g, requires_grad=True)
    b = torch.randn(4, dtype=torch.float64, generator=g, requires_grad=True)

    def f(x, w, b):
        return k2.fused_layer(x, w, b, mode)

    assert torch.autograd.gradcheck(f, (x, w, b))
    assert torch.autograd.gradgradcheck(f, (x, w, b))


def test_layer_rejects_unknown_mode():
    x = torch.zeros(1, 2, 4)
    with pytest.raises(ValueError):
        k2.critic_layer(x, torch.zeros(3, 2, 3), torch.zeros(3), "tanh")


def test_layer_cpu_takes_plain_path():
    x, w, b = _t(_rand((2, 5, T), 4)), _t(_rand((8, 5, 3), 5)), _t(_rand((8,), 6))
    counts = (k2.critic_layer.launches, k2.critic_layer_bwd_dx.launches,
              k2.critic_layer_bwd_dwdb.launches)
    assert torch.equal(k2.critic_layer(x, w, b, "relu"), k2.critic_layer_plain(x, w, b, "relu"))
    k2.critic_layer_bwd_dx(x, w, b, _t(_rand((2, 8, T), 7)), "relu")
    assert (k2.critic_layer.launches, k2.critic_layer_bwd_dx.launches,
            k2.critic_layer_bwd_dwdb.launches) == counts


def _critic_params(c_in, seed, dtype=np.float32):
    p = jcritic.init(jax.random.key(seed), c_in)
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), p)


def test_state_dict_is_reference_layout():
    params = _critic_params(4, 0)
    want = critic_state_dict_from_jax_params(params)
    assert list(Critic(4).state_dict()) == list(want)
    c = critic_from_jax_params(params)
    for k, v in want.items():
        np.testing.assert_array_equal(c.state_dict()[k].numpy(), v)
    back = critic_jax_params_from_state_dict(want)
    jax.tree.map(np.testing.assert_array_equal, back, params)
    # PyTorch's default init, U(±1/√fan_in), from the explicit generator
    a, b = Critic(4, torch.Generator().manual_seed(3)), Critic(4, torch.Generator().manual_seed(3))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    assert float(a.state_dict()["model.8.weight"].abs().max()) <= 1 / np.sqrt(256 * 3)


def test_critic_forward_and_gp_match_apply_fused():
    """f32: the port's Critic against the fused Pallas critic in interpret
    mode: scores, and the GP value with a pinned eps."""
    b, c_in = 2, 1
    params = _critic_params(c_in, 5)
    rng = np.random.default_rng(11)
    scg, rhc, pred = (rng.random((b, c, T)).astype(np.float32) for c in (c_in, 1, 1))
    eps = rng.random((b, 1, 1)).astype(np.float32)
    x = np.concatenate((scg, rhc), axis=1)
    critic = critic_from_jax_params(params)

    want = np.asarray(jcritic.apply_fused(params, jnp.asarray(x), interpret=True))
    with torch.no_grad():
        got = critic(_t(x)).numpy()
    np.testing.assert_allclose(got, want, atol=5e-5)

    gp_want = float(jwgan.gradient_penalty_from_eps(
        params, *(jnp.asarray(v) for v in (scg, rhc, pred, eps)), backend="fused"))
    gp_got = float(wgan.gradient_penalty_from_eps(
        critic, *(_t(v) for v in (scg, rhc, pred, eps))).detach())
    np.testing.assert_allclose(gp_got, gp_want, rtol=1e-5)


def _critic_gradients_match_jax(b, t):
    dtype = "float64"
    c_in = 2
    params = _critic_params(c_in, 1, np.dtype(dtype))
    g_params = jax.tree.map(lambda a: np.asarray(a).astype(dtype),
                            jwgan.init_state(jax.random.key(2), c_in, jwgan.TrainConfig()).g_params)
    rng = np.random.default_rng(9)
    x = rng.random((b, c_in + 1, t)).astype(dtype)
    scg, rhc, pred = (rng.random((b, c, t)).astype(dtype) for c in (c_in, 1, 1))
    eps = rng.random((b, 1, 1)).astype(np.float32)
    with enable_x64():
        jp = jax.tree.map(jnp.asarray, params)
        g_score = jax.jit(jax.grad(
            lambda p: jnp.mean(jnp.square(jcritic.apply(p, jnp.asarray(x))))))(jp)

        def jloss(p):
            return jwgan.critic_loss(p, g_params, jnp.asarray(scg), jnp.asarray(rhc), None, None,
                                     jwgan.TrainConfig(n_critic=1), pred_rhc=jnp.asarray(pred))

        real_eps = jwgan._draw_eps
        jwgan._draw_eps = lambda key, n: jnp.asarray(eps)
        try:
            l_want, g_loss = jax.jit(jax.value_and_grad(jloss))(jp)
        finally:
            jwgan._draw_eps = real_eps

    critic = critic_from_jax_params(params)
    names = [n for n, _ in critic.named_parameters()]
    ps = list(critic.parameters())
    got_score = torch.autograd.grad(critic(_t(x)).square().mean(), ps)

    real_eps = wgan._draw_eps
    wgan._draw_eps = lambda rng_, n, device: _t(eps)
    try:
        loss = wgan.critic_loss(critic, None, _t(scg), _t(rhc), None,
                                wgan.TrainConfig(n_critic=1), pred_rhc=_t(pred))
    finally:
        wgan._draw_eps = real_eps
    got_loss = torch.autograd.grad(loss, ps)
    np.testing.assert_allclose(float(loss.detach()), float(l_want), rtol=1e-9)
    for want_tree, got in ((g_score, got_score), (g_loss, got_loss)):
        want = critic_state_dict_from_jax_params(jax.tree.map(np.asarray, want_tree))
        for n, g in zip(names, got):
            # atol: the in_relu layers' bias gradients are zero up to rounding,
            # a sum over the steps: 1e-12 at T = 32, in proportion beyond
            np.testing.assert_allclose(g.numpy(), want[n], rtol=1e-9, atol=1e-12 * max(1, t / T),
                                       err_msg=n)


def test_critic_gradients_match_jax():
    """Parameter gradients of a score loss, and of the critic loss with its
    second-order GP, against the XLA critic, in f64."""
    _critic_gradients_match_jax(3, T)


def test_critic_gradients_match_jax_past_1024_steps():
    """The same at T = 1100, past the 1024 steps the card once refused."""
    _critic_gradients_match_jax(2, 1100)


@pytest.mark.parametrize("layer", [k2.fused_layer, k2.critic_layer_plain])
def test_input_gradient_built_forward_matches_create_graph(layer):
    """``Critic.forward(x, ct=...)`` builds the input gradient layer by layer
    from the top; it equals the ``create_graph`` backward's, and so does its
    own (second-order) parameter gradient, in f64."""
    critic = Critic(2, torch.Generator().manual_seed(4)).double()
    g = torch.Generator().manual_seed(5)
    x = torch.rand(3, 3, T, generator=g, dtype=torch.float64)
    ct = torch.rand(3, 1, T, generator=g, dtype=torch.float64)
    scores, dx = critic(x, layer=layer, ct=ct)
    xg = x.clone().requires_grad_()
    want_scores = critic(xg, layer=layer)
    (want,) = torch.autograd.grad((want_scores * ct).sum(), xg, create_graph=True)
    torch.testing.assert_close(scores, want_scores, rtol=1e-12, atol=0)
    torch.testing.assert_close(dx, want, rtol=1e-12, atol=1e-15)
    ps = list(critic.parameters())
    got_p = torch.autograd.grad(dx.square().sum(), ps, allow_unused=True)
    want_p = torch.autograd.grad(want.square().sum(), ps, allow_unused=True)
    names = [n for n, _ in critic.named_parameters()]
    for n, a, b in zip(names, got_p, want_p):
        assert (a is None) == (b is None), n
        if a is not None:
            torch.testing.assert_close(a, b, rtol=1e-10, atol=1e-13, msg=n)
