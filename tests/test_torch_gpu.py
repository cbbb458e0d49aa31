"""The port's CUDA kernels against their plain versions, on the card.

Every test here is marked ``gpu`` and skips without a CUDA device.  The
machine with the card has no JAX, so this file imports neither JAX nor
``scgrhc``, and it runs there without the repo's conftest:

    python -m pytest -m gpu --noconftest -p no:cacheprovider tests/test_torch_gpu.py

Tolerances: f32 1e-4 absolute (the kernel and cuDNN sum the 3·C_in
products in different orders; outputs are instance-normalized, O(1));
bf16 3e-2 absolute plus 1e-2 relative against the f32 plain version on
the same bf16-rounded inputs (the kernel's only extra rounding is the bf16
store, 2^-9 relative); K4 1e-6 (it performs the plain version's exact
f32 operations).
"""

import numpy as np
import pytest
import torch

from scgrhc_torch.models.generator import Generator, plain_block
from scgrhc_torch.ops.kernels import conv_block as k1f
from scgrhc_torch.ops.kernels import dsp as k4

pytestmark = pytest.mark.gpu


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _conv_inputs(n, ci, o, t, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, ci, t)).astype(np.float32)
    bound = 1.0 / np.sqrt(ci * 3)
    w = rng.uniform(-bound, bound, (o, ci, 3)).astype(np.float32)
    b = rng.uniform(-bound, bound, o).astype(np.float32)
    return x, w, b


def _windows(n, c, t, nan_window, seed=0):
    rng = np.random.default_rng(seed)
    w = (rng.standard_normal((n, c, t)) * rng.uniform(0.1, 50, (n, 1, 1))
         + rng.uniform(-10, 10, (n, 1, 1))).astype(np.float32)
    w[nan_window, c // 2, t // 3] = np.nan
    return w


@pytest.mark.parametrize(
    "ci,o,t", [(4, 64, 750), (2, 64, 96), (64, 128, 748), (512, 512, 744),
               (256, 128, 747), (100, 24, 1024), (7, 5, 1)]
)
def test_conv_in_relu_kernel_f32(cuda, ci, o, t):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(3, ci, o, t))
    before = k1f.conv_in_relu.launches
    got = k1f.conv_in_relu(x, w, b)
    torch.cuda.synchronize()
    assert k1f.conv_in_relu.launches == before + 1
    want = k1f.conv_in_relu_plain(x, w, b)
    torch.testing.assert_close(got, want, atol=1e-4, rtol=0)


@pytest.mark.parametrize("ci,o,t", [(4, 64, 750), (512, 256, 746)])
def test_conv_in_relu_kernel_bf16(cuda, ci, o, t):
    x, w, b = (torch.from_numpy(a).to(cuda).bfloat16() for a in _conv_inputs(3, ci, o, t))
    got = k1f.conv_in_relu(x, w, b)
    assert got.dtype == torch.bfloat16
    want = k1f.conv_in_relu_plain(x.float(), w.float(), b.float())
    torch.testing.assert_close(got.float(), want, atol=3e-2, rtol=1e-2)


def test_conv_in_relu_kernel_propagates_nan(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(2, 4, 64, 750))
    x[1, 2, 100] = float("nan")
    got = k1f.conv_in_relu(x, w, b)
    assert torch.isnan(got[1]).all() and not torch.isnan(got[0]).any()


def test_conv_in_relu_kernel_rejects(cuda):
    x, w, b = (torch.from_numpy(a).to(cuda) for a in _conv_inputs(2, 4, 64, 750))
    with pytest.raises(TypeError):
        k1f.conv_in_relu(x.double(), w.double(), b.double())
    with pytest.raises(ValueError):
        k1f.conv_in_relu(x.transpose(1, 2).contiguous().transpose(1, 2), w, b)
    with pytest.raises(ValueError):
        k1f.conv_in_relu(torch.zeros(1, 4, 1025, device=cuda), w, b)


@pytest.mark.parametrize("n,c,t", [(512, 4, 750), (3, 1, 5)])
def test_normalize_windows_kernel(cuda, n, c, t):
    w = torch.from_numpy(_windows(n, c, t, nan_window=n // 2)).to(cuda)
    before = k4.normalize_windows.launches
    got = k4.normalize_windows(w)
    torch.cuda.synchronize()
    assert k4.normalize_windows.launches == before + 1
    want = k4.normalize_windows_plain(w)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.isnan(got[n // 2]).all()
    torch.testing.assert_close(got, want, atol=1e-6, rtol=0, equal_nan=True)


def test_generator_fused_matches_plain_block(cuda):
    """The whole U-Net: 14 K1f launches against the plain block, same weights."""
    gen = Generator(4, torch.Generator().manual_seed(3)).to(cuda).eval()
    x = torch.rand(8, 4, 750, generator=torch.Generator().manual_seed(4)).to(cuda)
    before = k1f.conv_in_relu.launches
    with torch.inference_mode():
        got = gen(x)
        want = gen(x, block=plain_block)
    assert k1f.conv_in_relu.launches == before + 14
    torch.testing.assert_close(got, want, atol=1e-3, rtol=0)
