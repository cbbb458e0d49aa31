"""The port's Generator against scgrhc.models.generator with the same
weights: ``scgrhc.models.generator.init`` weights carried across by
``generator_from_jax_params``.  Float64 at the f64 oracle tier (rtol 1e-9);
float32 at a stated envelope."""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from scgrhc.models import generator as jgen
from scgrhc.models import torch_compat
from scgrhc_torch.models.convert import generator_from_jax_params
from scgrhc_torch.models.generator import Generator, plain_block

# T=96 keeps the test fast; every length quirk still runs
# (96 → 94 → 92 → 90 → 92 → 94 → 96).
T = 96
# f32: the two packages' CPU convs sum in different orders; 23 conv
# layers, each renormalized by instance norm, keep the drift near 1e-5.
F32_ATOL = 1e-4


@contextlib.contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _jax_params(c, dtype):
    p = jgen.init(jax.random.key(0), c)
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), p)


def _forward_f64_matches_jax(c, n, t):
    params = _jax_params(c, np.float64)
    x = np.random.default_rng(0).random((n, c, t))
    with enable_x64():
        want = np.asarray(
            jgen.apply(jax.tree.map(jnp.asarray, params), jnp.asarray(x), train=False)
        )
    g = generator_from_jax_params(params)
    assert g.dtype == torch.float64
    with torch.inference_mode():
        got = g(torch.from_numpy(x)).numpy()
    assert got.shape == (n, 1, t) and got.dtype == np.float64
    np.testing.assert_allclose(got, want, rtol=1e-9, atol=1e-11)


@pytest.mark.parametrize("c", [4, 1])
def test_forward_f64_matches_jax(c):
    _forward_f64_matches_jax(c, 2, T)


def test_forward_f64_matches_jax_past_1024_steps():
    """A 2.2-s window (T = 1100, past the 1024 steps the card once
    refused): the port's layers take any length, as scgrhc's XLA path
    does (1100 → 1098 → 1096 → 1094 → 1096 → 1098 → 1100)."""
    _forward_f64_matches_jax(4, 1, 1100)


def test_forward_f32_matches_jax():
    params = _jax_params(4, np.float32)
    x = np.random.default_rng(1).random((3, 4, T)).astype(np.float32)
    want = np.asarray(jgen.apply(params, jnp.asarray(x), train=False))
    g = generator_from_jax_params(params)
    with torch.inference_mode():
        got = g(torch.from_numpy(x)).numpy()
        plain = g(torch.from_numpy(x), block=plain_block).numpy()
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
    # on the CPU the kernel wrapper IS the plain version
    np.testing.assert_array_equal(got, plain)


def test_state_dict_keys_are_reference_layout():
    params = _jax_params(4, np.float32)
    want = list(torch_compat.generator_to_torch_sd(params, as_torch=False))
    assert list(Generator(4).state_dict()) == want
    g = generator_from_jax_params(params)
    for k, v in torch_compat.generator_to_torch_sd(params, as_torch=False).items():
        np.testing.assert_array_equal(g.state_dict()[k].numpy(), v)


def test_seeded_init_is_reproducible_and_torch_default_scaled():
    a = Generator(3, torch.Generator().manual_seed(7))
    b = Generator(3, torch.Generator().manual_seed(7))
    for (k, va), vb in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(va, vb), k
    w = a.state_dict()["bottleneck.3.weight"]
    assert float(w.abs().max()) <= 1.0 / np.sqrt(512 * 3)


def test_cast_keeps_final_in_its_dtype():
    g = Generator(2).cast(torch.bfloat16)
    assert g.dtype == torch.bfloat16
    assert g.final.weight.dtype == torch.float32
    assert g.up2.weight.dtype == torch.bfloat16
    assert g.att1.psi[0].weight.dtype == torch.bfloat16
    x = torch.rand(1, 2, T)
    with torch.inference_mode():
        y = g(x)
    assert y.dtype == torch.float32 and torch.isfinite(y).all()


def test_pad_size_quirk_matches_jax():
    """At an input length where the branches do not reconcile, the port
    takes the same shorter-branch quirk as the JAX package."""
    params = _jax_params(2, np.float32)
    x = np.random.default_rng(2).random((1, 2, 37)).astype(np.float32)
    want = np.asarray(jgen.apply(params, jnp.asarray(x), train=False))
    with torch.inference_mode():
        got = generator_from_jax_params(params)(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=F32_ATOL)
