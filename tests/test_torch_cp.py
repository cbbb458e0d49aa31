"""The port's continuous whole-record mode (scgrhc_torch.models.cp) against
scgrhc.models.cp.apply_continuous, with the same weights carried across by
``generator_from_jax_params``.

  * Float64 on both sides (``jax_enable_x64``) at the f64 oracle tier,
    rtol 1e-9, at L = 1, 2, 257 and 1001 with 3 and 4 SCG channels.  At
    L = 2 the forward is ill-conditioned: a row of two samples has a
    variance far below the instance norm's eps, and each such norm
    multiplies a rounding difference by up to 1/sqrt(eps) ≈ 316, so an
    input moved by 1e-15 relative moves the output by about 1e-7 (measured
    1.2e-7 and 9.0e-7).  The test measures that sensitivity of the port's
    own forward and allows ten times it beside the rtol; at the other
    lengths it is below 1e-13 and the rtol decides.
  * Float32 at L = 1001 within 1e-3 (the cross-package f32 envelope).
  * The flipped-kernel SAME conv equals ConvTranspose1d k3 s1 cropped by
    one sample at each end.
  * Every length comes back unchanged, a record shorter than one window
    included; on the CPU the K1f wrapper is its plain version.
"""

import contextlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from scgrhc.models import cp as jcp
from scgrhc.models import generator as jgen
from scgrhc_torch.models import cp
from scgrhc_torch.models.convert import generator_from_jax_params
from scgrhc_torch.models.generator import plain_block

RTOL = 1e-9
F32_ATOL = 1e-3


@contextlib.contextmanager
def enable_x64():
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", True)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _params(c: int, dtype):
    return jax.tree.map(lambda a: np.asarray(a).astype(dtype), jgen.init(jax.random.key(0), c))


def _forward(gen, x: np.ndarray, block=None) -> np.ndarray:
    with torch.inference_mode():
        kw = {} if block is None else {"block": block}
        return cp.apply_continuous(gen, torch.from_numpy(x), **kw).numpy()


def test_conv_transpose_same_equivalence():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 512, 64)))
    w = torch.from_numpy(rng.standard_normal((512, 256, 3)))
    b = torch.from_numpy(rng.standard_normal(256))
    full = F.conv_transpose1d(x, w, b)  # (2, 256, 66)
    same = cp.conv_transpose3(x, w, b)
    assert same.shape == (2, 256, 64)
    np.testing.assert_allclose(same.numpy(), full[..., 1:-1].numpy(), rtol=1e-12, atol=1e-12)
    with enable_x64():
        want = jcp._conv_transpose3(jnp.asarray(x.numpy()), jnp.asarray(w.numpy()),
                                    jnp.asarray(b.numpy()), None, 1)
    np.testing.assert_allclose(same.numpy(), np.asarray(want), rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("length", [1, 2, 257, 1001])
@pytest.mark.parametrize("c", [3, 4])
def test_apply_continuous_f64_matches_jax(c, length):
    params = _params(c, np.float64)
    x = np.random.default_rng(length).random((1, c, length))
    with enable_x64():
        want = np.asarray(jcp.apply_continuous(jax.tree.map(jnp.asarray, params),
                                               jnp.asarray(x)))
    gen = generator_from_jax_params(params).eval()
    got = _forward(gen, x)
    assert got.shape == want.shape == (1, 1, length) and got.dtype == np.float64
    # the forward's own conditioning at this length (see the module docstring)
    sensitivity = float(np.abs(_forward(gen, x * (1 + 1e-15)) - got).max())
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=10 * sensitivity)


def test_apply_continuous_f32_matches_jax():
    params = _params(4, np.float32)
    x = np.random.default_rng(5).random((1, 4, 1001)).astype(np.float32)
    want = np.asarray(jcp.apply_continuous(params, jnp.asarray(x)))
    got = _forward(generator_from_jax_params(params).eval(), x)
    assert got.dtype == np.float32
    np.testing.assert_allclose(got, want, atol=F32_ATOL)


@pytest.mark.parametrize("length", [1, 2, 3, 7, 333, 749])
def test_length_preserving_and_plain_on_cpu(length):
    """Odd and short lengths, 749 being a record shorter than one window."""
    gen = generator_from_jax_params(_params(3, np.float32)).eval()
    x = np.random.default_rng(length).random((1, 3, length)).astype(np.float32)
    got = _forward(gen, x)
    assert got.shape == (1, 1, length) and np.isfinite(got).all()
    np.testing.assert_array_equal(got, _forward(gen, x, block=plain_block))
