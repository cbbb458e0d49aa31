"""scgrhc_torch.ops.nn against scgrhc.ops.nn in float64 at the repo's f64
oracle tier (rtol 1e-9, atol 1e-11): the same numpy inputs go through
both packages."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.ops import nn as jnn
from scgrhc_torch.ops import nn as tnn

RTOL, ATOL = 1e-9, 1e-11


@contextlib.contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _both(fn_j, fn_t, *arrays):
    with enable_x64():
        want = np.asarray(fn_j(*(jnp.asarray(a) for a in arrays)))
    got = fn_t(*(torch.from_numpy(a) for a in arrays)).numpy()
    return got, want


@pytest.mark.parametrize("cin,o,k,padding", [(3, 8, 3, 1), (16, 4, 1, 0), (5, 7, 3, 0)])
def test_conv1d_f64(cin, o, k, padding):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, cin, 41))
    w = rng.standard_normal((o, cin, k))
    b = rng.standard_normal(o)
    got, want = _both(
        lambda x, w, b: jnn.conv1d(x, w, b, padding=padding),
        lambda x, w, b: tnn.conv1d(x, w, b, padding=padding),
        x, w, b,
    )
    assert got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("cin,o", [(8, 4), (3, 6)])
def test_conv_transpose1d_f64(cin, o):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, cin, 33))
    w = rng.standard_normal((cin, o, 3))  # (I, O, K)
    b = rng.standard_normal(o)
    got, want = _both(jnn.conv_transpose1d, tnn.conv_transpose1d, x, w, b)
    assert got.shape == (2, o, 35)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("scale,offset", [(1.0, 0.0), (1e-3, 5.0), (30.0, -2.0)])
def test_instance_norm_f64(scale, offset):
    """One-pass statistics, clamped variance — including an offset input
    where the E[x²]−mean² cancellation is visible."""
    x = np.random.default_rng(2).standard_normal((3, 4, 50)) * scale + offset
    got, want = _both(jnn.instance_norm, tnn.instance_norm, x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


def test_instance_norm_stats_in_f32_for_bf16():
    x = np.random.default_rng(3).standard_normal((2, 3, 64)).astype(np.float32)
    xt = torch.from_numpy(x).to(torch.bfloat16)
    got = tnn.instance_norm(xt)
    assert got.dtype == torch.bfloat16
    want = tnn.instance_norm(xt.float())
    np.testing.assert_allclose(got.float().numpy(), want.numpy(), atol=3e-2)


@pytest.mark.parametrize(
    "name", ["max_pool1d_k3s1", "relu", "sigmoid"]
)
def test_elementwise_and_pool_f64(name):
    x = np.random.default_rng(4).standard_normal((2, 5, 30))
    got, want = _both(getattr(jnn, name), getattr(tnn, name), x)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("transpose", [False, True])
def test_conv_init_shapes_and_bounds(transpose):
    """Same shapes and U(±1/√fan_in) bounds as scgrhc's conv_init (the
    draws differ: different generators), reproducible from a seed."""
    j = jnn.conv_init(jax.random.key(0), 8, 16, 3, transpose=transpose)
    w, b = tnn.conv_init(torch.Generator().manual_seed(0), 8, 16, 3, transpose=transpose)
    w2, _ = tnn.conv_init(torch.Generator().manual_seed(0), 8, 16, 3, transpose=transpose)
    assert tuple(w.shape) == j["w"].shape and tuple(b.shape) == j["b"].shape
    assert torch.equal(w, w2)
    bound = 1.0 / np.sqrt((8 if transpose else 16) * 3)
    assert float(w.abs().max()) <= bound and float(b.abs().max()) <= bound
    assert float(w.abs().max()) > 0.8 * bound  # uses the whole range
